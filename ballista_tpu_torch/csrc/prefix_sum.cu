// Inclusive f64 prefix sums of k columns, in an order of adds fixed by the
// shapes alone, on Hopper.
//
// x is k columns of n rows, each column contiguous (a (k, n) row-major
// array); out[c][i] = x[c][0] + ... + x[c][i], associated as follows.
// Cut each column into chunks of kChunk = 16 consecutive rows (the last
// chunk padded with +0.0). Within a chunk, a running sum from +0.0, left to
// right: local[i]. The chunk totals (local of each chunk's last row, padding
// included) form a column of m = ceil(n / kChunk) rows, whose inclusive
// prefix is taken by the same rule, recursively, until a level has one
// chunk. Then out[i] = offset[chunk(i)] + local[i], where offset[0] = +0.0
// and offset[j] = the totals' inclusive prefix at j - 1. Every add is one
// IEEE round-to-nearest f64 add (__dadd_rn: no contraction, no fast math,
// no float atomics), and which values each add takes depends on n alone,
// so two launches on the same input are bit-identical, and the plain
// version (ops/prefix_sum.py, prefix_sums_plain: a torch.cumsum along the
// chunks of a (k, m, kChunk) CPU view, which torch's CPU kernel runs left
// to right from +0.0) gives the same bits. A running sum from +0.0 is never
// -0.0, so the added +0.0 offset and the +0.0 padding change no bit.
//
// Replaces the reference's f64 prefix on the accelerator,
// ballista_tpu/ops/aggregate.py (_prefix_sum_2d, _mm_prefix: blocked
// upper-triangular products of block 512), which the sort aggregate's
// f64 SUMs run (prefix differences at the segment starts). torch.cumsum on
// a CUDA tensor is one device-wide scan whose order of adds can follow
// which block finishes first (decoupled look-back), so an f64 SUM was not
// bit-reproducible from run to run.
//
// Bound on an H100: memory. Each row of each column is read once (8 bytes)
// and written once (8 bytes): 16 bytes a row a column, 28.7 us for one
// column of 6,000,000 rows at 3.35 TB/s; the adds (one a row, plus one in
// kChunk for the levels above) are far below the f64 rate. The design
// reads the input twice (once for the totals, once for the scan: 24 bytes
// a row), which trades a third of the bound for a scan that needs no
// per-chunk local values in device memory.
//
// Design:
//  - chunk_totals: a block of kThreads threads stages a tile of kTile =
//    kThreads * kChunk rows of one column into shared memory (coalesced
//    loads; rows past n read as +0.0), then thread t sums chunk t of the
//    tile from +0.0, left to right, and writes the total.
//  - The totals (k, m) are scanned by the same two kernels, recursively,
//    in a scratch buffer the caller allocates (prefix_sum_scratch_rows).
//  - chunk_scan: stages the tile again; thread t runs the same sum over its
//    chunk, keeping each running value, adds its chunk's offset, and the
//    block stores the tile (coalesced).
//  - Shared memory rows are kChunk + 1 doubles apart, so the 16 threads of
//    a half-warp walking their chunks hit distinct banks.
//  - grid: (tiles, k); one launch sequence of 2L + 1 launches for L levels
//    with more than one chunk (n = 6,000,000: L = 5, 11 launches).
//  - No allocation, no synchronisation: the launches queue on the caller's
//    stream, and each is checked with cudaGetLastError.

#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 16;
constexpr int kThreads = 256;
constexpr int kTile = kChunk * kThreads;  // 4,096 rows a block
constexpr int kPad = kChunk + 1;          // shared-memory row stride

__device__ __forceinline__ void stage(const double* __restrict__ x, long long n,
                                      long long base, double* s) {
  for (int j = threadIdx.x; j < kTile; j += kThreads) {
    const long long i = base + j;
    s[(j / kChunk) * kPad + (j % kChunk)] = i < n ? x[i] : 0.0;
  }
}

__global__ void __launch_bounds__(kThreads)
chunk_totals(const double* __restrict__ x, long long n, long long m,
             double* __restrict__ totals) {
  __shared__ double s[kThreads * kPad];
  const long long col = blockIdx.y;
  stage(x + col * n, n, (long long)blockIdx.x * kTile, s);
  __syncthreads();
  const double* r = s + threadIdx.x * kPad;
  double acc = 0.0;
#pragma unroll
  for (int j = 0; j < kChunk; ++j) acc = __dadd_rn(acc, r[j]);
  const long long c = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (c < m) totals[col * m + c] = acc;
}

__global__ void __launch_bounds__(kThreads)
chunk_scan(const double* __restrict__ x, long long n, long long m,
           const double* __restrict__ incl, double* __restrict__ out) {
  __shared__ double s[kThreads * kPad];
  const long long col = blockIdx.y;
  const long long base = (long long)blockIdx.x * kTile;
  stage(x + col * n, n, base, s);
  __syncthreads();
  const long long c = (long long)blockIdx.x * kThreads + threadIdx.x;
  const double off =
      (incl != nullptr && c > 0 && c < m) ? incl[col * m + c - 1] : 0.0;
  double* r = s + threadIdx.x * kPad;
  double acc = 0.0;
#pragma unroll
  for (int j = 0; j < kChunk; ++j) {
    acc = __dadd_rn(acc, r[j]);
    r[j] = __dadd_rn(off, acc);
  }
  __syncthreads();
  double* o = out + col * n;
  for (int j = threadIdx.x; j < kTile; j += kThreads) {
    const long long i = base + j;
    if (i < n) o[i] = s[(j / kChunk) * kPad + (j % kChunk)];
  }
}

// One level: the totals of x's chunks, their prefix (the next level, in
// the scratch that follows), then the scan of x with those offsets.
cudaError_t prefix_level(const double* x, long long n, int k, double* scratch,
                         double* out, cudaStream_t s) {
  const long long m = (n + kChunk - 1) / kChunk;
  const dim3 grid((unsigned)((n + kTile - 1) / kTile), (unsigned)k);
  const double* incl = nullptr;
  if (m > 1) {
    double* totals = scratch;
    double* tincl = scratch + (long long)k * m;
    chunk_totals<<<grid, kThreads, 0, s>>>(x, n, m, totals);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    e = prefix_level(totals, m, k, scratch + 2LL * k * m, tincl, s);
    if (e != cudaSuccess) return e;
    incl = tincl;
  }
  chunk_scan<<<grid, kThreads, 0, s>>>(x, n, m, incl, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The chunk length the association is defined by (the plain version
// checks it against its own).
int prefix_sum_chunk() { return kChunk; }

// Launches the levels on `stream`. x and out: k * n doubles each (column c
// at c * n); scratch: k * prefix_sum_scratch_rows(n) doubles. Returns a
// cudaError_t (0 = ok).
int prefix_sum_f64(const double* x, long long n, int k, double* scratch,
                   double* out, void* stream) {
  if (n <= 0 || k <= 0) return (int)cudaErrorInvalidValue;
  return (int)prefix_level(x, n, k, scratch, out,
                           static_cast<cudaStream_t>(stream));
}

const char* prefix_sum_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
