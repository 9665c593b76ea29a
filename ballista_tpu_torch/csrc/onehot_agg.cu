// One-hot group sums on Hopper: out[p, r] = sum of vals[r, i] over the
// rows i with rid[i] == p, for p in [0, P). Rows whose rid lies outside
// [0, P) are dropped.
//
// Replaces the TPU kernel ballista_tpu/ops/pallas_agg.py (_program, inner
// `kernel`, reached through onehot_sums), which builds a (P, B) one-hot of
// each row block in VMEM and contracts it with the value rows on the MXU.
//
// Bound on an H100: the kernel must read rid (4n bytes) and the value rows
// (8Rn bytes) once and write the (P, R) sums; it needs only n*R f64 adds.
// At TPC-H q1's shape (n = 2^21, R = 14, P = 12) that is 243 MB, about
// 73 us at 3.35 TB/s against under 1 us of f64 arithmetic: memory bound.
//
// Design:
// - f64 in, f64 accumulation. The TPU's hi/lo f32 split existed only
//   because the v5e's MXU has no f64; the H100 has native f64.
// - Select, do not multiply: a row adds its value to slot rid[i] only, so a
//   NaN stays in its own group (a one-hot product gives 0 * NaN = NaN in
//   every slot).
// - Deterministic, no floating-point atomics. Block b owns a fixed range of
//   rows and writes its own (P, R) partial; a second kernel sums the
//   partials over b in a fixed order (a strided lane sum, then a fixed
//   warp-shuffle tree). Two launches on the same input are bit-identical.
//   The TPU kernel's (nb2, P, R) partials work the same way.
// - Each thread owns K (slot, value-row) pairs and keeps their sums in
//   registers. The block stages a tile of rid and of all R value rows in
//   shared memory (coalesced loads), then every thread scans the tile
//   serially: rid[i] is a broadcast read, and threads of a warp share a
//   value row, so the tile is read from device memory once per pass over
//   the pairs. For P*R up to K*blockDim (q1: 168 pairs) that is one pass.
//   Larger P*R (up to P = 2048) repeats the row scan per group of pairs:
//   the same P*n*R work as the TPU's one-hot contraction.
// The launch shape (tile, threads, K, blocks, rows per block) is computed
// by the Python wrapper (ops/onehot_agg.py, launch_plan) so that it is
// testable without a card.

#include <cuda_runtime.h>

namespace {

template <int K>
__global__ void partial_sums(const int* __restrict__ rid,
                             const double* __restrict__ vals, long long n,
                             int R, int P, int tile, long long rows_per_block,
                             double* __restrict__ partials) {
  extern __shared__ double smem[];
  const int stride = tile + 1;  // pad so that value rows start on other banks
  double* s_val = smem;         // R rows of `stride` doubles
  int* s_rid = reinterpret_cast<int*>(smem + (size_t)R * stride);

  const long long row0 = (long long)blockIdx.x * rows_per_block;
  const long long row_end = min(n, row0 + rows_per_block);
  const int pairs = P * R;

  for (int base = 0; base < pairs; base += K * blockDim.x) {
    int p[K], r[K];
    double acc[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int q = base + j * blockDim.x + threadIdx.x;
      // pair q = (slot q % P, value row q / P): a warp's threads share r
      r[j] = q < pairs ? q / P : 0;
      p[j] = q < pairs ? q % P : -1;
      acc[j] = 0.0;
    }
    for (long long t0 = row0; t0 < row_end; t0 += tile) {
      const int m = (int)min((long long)tile, row_end - t0);
      __syncthreads();  // the previous tile is fully consumed
      for (int i = threadIdx.x; i < m; i += blockDim.x) s_rid[i] = rid[t0 + i];
      for (int e = threadIdx.x; e < R * tile; e += blockDim.x) {
        const int rr = e / tile;
        const int i = e - rr * tile;
        if (i < m) s_val[rr * stride + i] = vals[(size_t)rr * n + t0 + i];
      }
      __syncthreads();
      for (int i = 0; i < m; ++i) {
        const int g = s_rid[i];
#pragma unroll
        for (int j = 0; j < K; ++j) {
          if (g == p[j]) acc[j] += s_val[r[j] * stride + i];
        }
      }
    }
#pragma unroll
    for (int j = 0; j < K; ++j) {
      if (p[j] >= 0) {
        partials[(size_t)blockIdx.x * pairs + (size_t)p[j] * R + r[j]] = acc[j];
      }
    }
  }
}

// One warp per output element: lanes take partials b = lane, lane + 32, ...
// in order, then a fixed shuffle tree adds the 32 lane sums.
__global__ void reduce_partials(const double* __restrict__ partials, int nb,
                                int pairs, double* __restrict__ out) {
  const int w = (int)((blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (w >= pairs) return;  // uniform across the warp
  double s = 0.0;
  for (int b = lane; b < nb; b += 32) s += partials[(size_t)b * pairs + w];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
  if (lane == 0) out[w] = s;
}

}  // namespace

extern "C" {

// Launches both kernels on `stream`. Returns cudaGetLastError() (0 = ok).
int onehot_sums_f64(const int* rid, const double* vals, long long n, int R,
                    int P, int tile, int threads, int k, int nb,
                    long long rows_per_block, double* partials, double* out,
                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = (size_t)R * (tile + 1) * sizeof(double) + tile * sizeof(int);
  if (k == 1) {
    partial_sums<1><<<nb, threads, smem, s>>>(rid, vals, n, R, P, tile,
                                              rows_per_block, partials);
  } else if (k == 4) {
    partial_sums<4><<<nb, threads, smem, s>>>(rid, vals, n, R, P, tile,
                                              rows_per_block, partials);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int pairs = P * R;
  const int rthreads = 256;
  const int rblocks = (int)(((long long)pairs * 32 + rthreads - 1) / rthreads);
  reduce_partials<<<rblocks, rthreads, 0, s>>>(partials, nb, pairs, out);
  return (int)cudaGetLastError();
}

const char* onehot_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
