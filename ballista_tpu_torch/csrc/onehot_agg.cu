// Group sums on Hopper: out[p, r] = sum of vals[r, i] over the rows i with
// rid[i] == p, for p in [0, P). Rows whose rid lies outside [0, P) are
// dropped.
//
// Replaces the TPU kernel ballista_tpu/ops/pallas_agg.py (_program, inner
// `kernel`, reached through onehot_sums), which builds a (P, B) one-hot of
// each row block in VMEM and contracts it with the value rows on the MXU.
// That contraction does P*n*R work; this kernel does n*R: each row's R
// values are read once and added once, into the row's own slot.
//
// Bound on an H100: the kernel must read rid (4n bytes) and the value rows
// (8Rn bytes) once and write the (P, R) sums; it needs n*R f64 adds. At
// TPC-H q1's shape (n = 2^21, R = 6, P = 12) that is 109 MB, about 33 us
// at 3.35 TB/s against under 1 us of f64 arithmetic: memory bound.
//
// Design, common to both kernels:
// - f64 in, f64 accumulation; select, never multiply, so a NaN stays in
//   its own slot (a one-hot product gives 0 * NaN = NaN in every slot).
// - Accumulators in shared memory. Where P*R does not fit a block's, the
//   grid's x dimension walks chunks of Pc slots; every chunk re-reads rid,
//   but copies the values only of its own rows (the copy of any other row
//   reads nothing and writes a zero). Chunks of one row block are
//   neighbours in launch order, so the re-reads mostly hit L2.
// - Loads run ahead of the adds: cp.async fills rings in shared memory,
//   with the slot ids further ahead than the values, so that a value is
//   copied only for a row whose slot lies in the block's chunk.
// - Deterministic, no floating-point atomics. A warp takes 32 rows at a
//   time, a lane a row, and groups the lanes whose rows share a slot (see
//   each kernel). Where no group has more than kDirect lanes (many slots),
//   the lanes of a group add their own values in turn, in lane order;
//   else a tree fixed by each lane's rank among its peers sums the group's
//   values (shuffles) and the group's lowest lane adds the result. So each
//   accumulator address has one writing lane at a time. Block (c, b)
//   writes its (Pc, R) part of partial b; a second kernel sums the
//   partials over b in a fixed order (a strided lane sum, then a fixed
//   warp-shuffle tree). The order of every f64 add depends only on the
//   launch shape, the row indices and the slot ids, so two launches on the
//   same input are bit-identical.
//
// partial_sums ("lanes", for fewer than 256 slots, or R > 32): lane l of
// a warp takes row base + l, so each value row a warp copies is 256
// contiguous bytes. A block keeps `copies` accumulators (odd row stride
// where that fits, so that a warp's leaders hit distinct banks); its 8
// warps form `copies` groups of k warps; group g takes the 32-row steps g,
// g + copies, ... of the block's rows, and warp j of a group owns the
// value rows r = j, j + k, ... (so the k warps of a group each find the
// step's groups again, for their own value rows). The lanes of one slot
// are found by one ballot per bit of the slot id in a chunk of up to
// 2^tree_bits slots, by __match_any_sync above.
//
// owner_sums ("owners", from 256 slots and up to 32 value rows): one
// accumulator; warp w owns the chunk's slots equal to w modulo 8, lists
// its rows of each staged tile, and takes them 32 at a time, each lane
// with all R values of its row; the lanes of one slot are found once for
// all R, by an integer atomicOr into a word of the slot (faster here than
// __match_any_sync, whose cost grows with the distinct slots of a warp).
//
// The launch shape (mode, copies, ring stages, tile, Pc, chunks, blocks,
// rows per block, shared memory) is computed by the Python wrapper
// (ops/onehot_agg.py, launch_plan) so that it is testable without a card.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxRounds = 5;  // a group of up to 32 lanes
constexpr int kBatch = 4;      // value rows summed side by side
constexpr int kDirect = 4;     // groups up to this size add in turn, no tree

// a[(t0 + b) * k] += x[b] for the batch's value rows below `mine`: all
// loads first, then all stores
__device__ __forceinline__ void add_batch(double* a, int k, int t0, int mine,
                                          const double (&x)[kBatch]) {
  double y[kBatch];
#pragma unroll
  for (int b = 0; b < kBatch; ++b) y[b] = t0 + b < mine ? a[(t0 + b) * k] : 0.0;
#pragma unroll
  for (int b = 0; b < kBatch; ++b) {
    if (t0 + b < mine) a[(t0 + b) * k] = y[b] + x[b];
  }
}

// cp.async of one value (8 bytes) or one slot id (4 bytes) into shared
// memory; where `pred` is false nothing is read and a zero is written. No
// memory clobber on each copy: the ring is read only after wait_copies,
// which has one, and the refill of a step follows a compiler barrier.
__device__ __forceinline__ void copy8(double* dst, const double* src, bool pred) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
               "l"(src), "r"(pred ? 8 : 0));
}

__device__ __forceinline__ void copy4(int* dst, const int* src, bool pred) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(pred ? 4 : 0));
}

__device__ __forceinline__ void commit_copies() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The lanes whose slot equals this lane's, among the lanes of `in_mask`:
// one ballot per bit of the slot (slots lie in [0, 2^bits)). Every lane of
// the warp must call it.
__device__ __forceinline__ unsigned peer_mask(int slot, int bits, unsigned in_mask) {
  unsigned peers = in_mask;
  for (int b = 0; b < bits; ++b) {
    const bool on = (slot >> b) & 1;
    const unsigned m = __ballot_sync(kFull, on);
    peers &= on ? m : ~m;
  }
  return peers;
}

// The tree over a group of peer lanes: in round s each lane still in it
// adds the nearest peer above it, which holds the sum of the next 2^s
// ranks; lanes whose rank has bit s set leave; rank 0 (the leader) ends
// with the group's sum. Every lane of the warp must build it.
struct Tree {
  int rounds;
  int src[kMaxRounds];
  bool add[kMaxRounds];
};

__device__ __forceinline__ Tree make_tree(unsigned peers, int lane, unsigned biggest) {
  const unsigned lt = (1u << lane) - 1u;     // lanes below this one
  const unsigned gt = ~((2u << lane) - 1u);  // lanes above this one
  Tree t;
  t.rounds = biggest > 1u ? 32 - __clz(biggest - 1u) : 0;
  int rank = __popc(peers & lt);
  unsigned rest = peers & gt;
#pragma unroll
  for (int s = 0; s < kMaxRounds; ++s) {
    t.src[s] = lane;
    t.add[s] = false;
    if (s < t.rounds) {  // uniform across the warp
      const int nxt = __ffs(rest) - 1;
      t.src[s] = nxt < 0 ? lane : nxt;
      t.add[s] = nxt >= 0;
      rest &= ~__ballot_sync(kFull, rank & 1);
      rank >>= 1;
    }
  }
  return t;
}

// x[b] of every lane summed over its peer group into the leader's x[b]
__device__ __forceinline__ void tree_sum(const Tree& t, double (&x)[kBatch]) {
#pragma unroll
  for (int s = 0; s < kMaxRounds; ++s) {
    if (s < t.rounds) {
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const double o = __shfl_sync(kFull, x[b], t.src[s]);
        if (t.add[s]) x[b] += o;
      }
    }
  }
}

// Adds each lane's m values x_of(0), ..., x_of(m - 1) into a[t * ak] of its
// slot, for the peer groups of `peers` (0 for a lane without a row). Where
// no group has more than kDirect lanes, the lanes of a group add their own
// values in turn (rank order); else the peer tree sums each group's values
// into its lowest lane, which adds them. Either way the order depends only
// on the lanes' rows and slots. Every lane of the warp must call it.
template <class Get>
__device__ __forceinline__ void add_groups(unsigned peers, int lane, double* a,
                                           int ak, int m, Get x_of) {
  const int rank = __popc(peers & ((1u << lane) - 1u));
  const unsigned biggest = __reduce_max_sync(kFull, __popc(peers));
  if (biggest <= kDirect) {
    for (unsigned r = 0; r < biggest; ++r) {
      if (peers != 0u && rank == (int)r) {
        for (int t0 = 0; t0 < m; t0 += kBatch) {
          double x[kBatch];
#pragma unroll
          for (int b = 0; b < kBatch; ++b) x[b] = t0 + b < m ? x_of(t0 + b) : 0.0;
          add_batch(a, ak, t0, m, x);
        }
      }
      __syncwarp();
    }
    return;
  }
  const Tree tree = make_tree(peers, lane, biggest);
  // kBatch values at a time, so that their loads, shuffles and adds overlap
  for (int t0 = 0; t0 < m; t0 += kBatch) {
    double x[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) x[b] = t0 + b < m ? x_of(t0 + b) : 0.0;
    tree_sum(tree, x);
    if (peers != 0u && rank == 0) add_batch(a, ak, t0, m, x);
  }
  __syncwarp();  // these adds are seen by the next call's
}

template <int S>
__global__ void __launch_bounds__(256)
partial_sums(const int* __restrict__ rid, const double* __restrict__ vals,
             long long n, int R, int P, int Pc, int copies, int stride,
             int rw, int tree_bits, long long rows_per_block,
             double* __restrict__ partials) {
  // copies x Pc x stride accumulator doubles, then one ring per warp:
  // S x rw x 32 values, then 2S x 32 slot ids
  extern __shared__ double smem[];
  double* acc = smem;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int k = (blockDim.x >> 5) / copies;  // warps per copy
  const int g = warp / k;                    // copy (group) of this warp
  const int j = warp - g * k;                // place in the group
  const int mine = j < R ? (R - 1 - j) / k + 1 : 0;  // value rows j, j + k, ...
  const int c0 = blockIdx.x * Pc;
  const int pc = min(Pc, P - c0);
  const long long row0 = (long long)blockIdx.y * rows_per_block;
  const long long row_end = min(n, row0 + rows_per_block);
  const long long steps = (row_end - row0 + 31) >> 5;
  const int bits = pc > 1 ? 32 - __clz(pc - 1) : 0;  // of a slot in [0, pc)
  const size_t kn = (size_t)k * n;
  const double* col0 = vals + (size_t)j * n;
  const int acc_len = copies * Pc * stride;
  double* ring = smem + acc_len + (size_t)warp * S * (rw + 1) * 32;
  int* ring_id = reinterpret_cast<int*>(ring + S * rw * 32);

  for (int e = threadIdx.x; e < acc_len; e += blockDim.x) acc[e] = 0.0;
  __syncthreads();
  double* my = acc + (size_t)g * Pc * stride;

  // this warp's steps are the block's steps g, g + copies, ...; in its
  // step u, this lane's row is first + u * hop
  const int my_steps = steps > g ? (int)((steps - 1 - g) / copies + 1) : 0;
  const long long first = row0 + ((long long)g << 5) + lane;
  const long long hop = (long long)copies << 5;
  auto row_of = [&](int u) { return first + u * hop; };
  auto in_chunk = [&](int id) { return (unsigned)(id - c0) < (unsigned)pc; };
  auto id_at = [&](int u) {  // after its copy has landed
    return row_of(u) < row_end ? ring_id[(u & (2 * S - 1)) * 32 + lane] : -1;
  };
  auto copy_id = [&](int u) {
    const long long i = row_of(u);
    copy4(ring_id + (u & (2 * S - 1)) * 32 + lane, rid + (i < row_end ? i : 0), i < row_end);
  };
  auto copy_values = [&](int u) {
    const long long i = row_of(u);
    const bool in = in_chunk(id_at(u));
    const double* src = col0 + (in ? i : 0);
    double* dst = ring + (u & (S - 1)) * rw * 32 + lane;
    for (int t = 0; t < mine; ++t) copy8(dst + t * 32, src + t * kn, in);
  };

  if (mine > 0 && my_steps > 0) {
    for (int u = 0; u < 2 * S; ++u) copy_id(u);
    commit_copies();
    wait_copies<0>();
    for (int u = 0; u < S; ++u) {
      copy_values(u);
      commit_copies();
    }
    for (int u = 0; u < my_steps; ++u) {
      wait_copies<S - 1>();  // the copies of step u (and the ids of u + S)
      const int slot = id_at(u) - c0;
      const bool in = (unsigned)slot < (unsigned)pc;
      const unsigned inmask = __ballot_sync(kFull, in);
      const double* cur = ring + (u & (S - 1)) * rw * 32 + lane;
      double* a = my + (size_t)(in ? slot : 0) * stride + j;
      if (inmask != 0u) {
        // every lane votes (bits and tree_bits are uniform)
        const unsigned all = bits <= tree_bits
                                 ? peer_mask(slot, bits, inmask)
                                 : __match_any_sync(kFull, in ? slot : -1);
        add_groups(in ? all : 0u, lane, a, k, mine, [&](int t) { return cur[t * 32]; });
      }
      // refill: the values of step u + S into the stage just summed, the
      // ids of step u + 2S into the slot just read (after this step's reads
      // of both, which the compiler may not move past the copies)
      asm volatile("" ::: "memory");
      copy_values(u + S);
      copy_id(u + 2 * S);
      commit_copies();
    }
    wait_copies<0>();
  }
  __syncthreads();
  // this block's part of partial blockIdx.y: the copies summed in order
  double* out = partials + ((size_t)blockIdx.y * P + c0) * R;
  for (int e = threadIdx.x; e < pc * R; e += blockDim.x) {
    const int p = e / R;
    const int r = e - p * R;
    double s = acc[(size_t)p * stride + r];
    for (int c = 1; c < copies; ++c) s += acc[((size_t)c * Pc + p) * stride + r];
    out[e] = s;
  }
}

// Many slots (mode "owners"): warp w of the block owns the slots c0 + p of
// the chunk with p = w modulo the 8 warps, so no two warps write one
// address, and neighbouring hot slots spread over the warps. Slot p keeps
// row (p % 8) * q + p / 8 of the accumulator (q = pc / 8, rounded up), so
// that the slots of one warp lie together and not on two banks, and the
// lane word of the same index. The block stages tiles of T rows in shared
// memory with cp.async: the values (of the chunk's rows only) of the next
// kTiles - 1 tiles and the slot ids of the 2 * kTiles - 2 after the tile
// being summed (a value is copied only once its row's id has landed).
// Each warp lists its rows of the tile in order, then takes them 32 at a
// time, a lane a row: each lane ORs its bit into its slot's lane word (an
// integer atomicOr, whose result does not depend on the order), which then
// holds the lanes of the slot, and add_groups adds them.
constexpr int kTiles = 3;                 // tiles of values staged
constexpr int kIdTiles = 2 * kTiles - 1;  // tiles of slot ids staged

__global__ void __launch_bounds__(256)
owner_sums(const int* __restrict__ rid, const double* __restrict__ vals,
           long long n, int R, int P, int Pc, int stride, int tile_shift,
           long long rows_per_block, double* __restrict__ partials) {
  // Pc x stride accumulator doubles, kTiles tiles of R x (T + 1) values,
  // Pc lane words, a list of T row numbers for each warp, kIdTiles tiles
  // of T ids
  extern __shared__ double smem[];
  const int T = 1 << tile_shift;
  const int vstride = T + 1;  // odd: rows a lane apart hit distinct banks
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int c0 = blockIdx.x * Pc;
  const int pc = min(Pc, P - c0);
  const int q = (pc + 7) >> 3;
  const unsigned lt = (1u << lane) - 1u;
  const long long row0 = (long long)blockIdx.y * rows_per_block;
  const long long row_end = min(n, row0 + rows_per_block);
  const int tiles = (int)((row_end - row0 + T - 1) >> tile_shift);
  double* acc = smem;
  double* tile_vals = acc + (size_t)Pc * stride;
  unsigned* lanes_of = reinterpret_cast<unsigned*>(tile_vals + kTiles * (size_t)R * vstride);
  short* lists = reinterpret_cast<short*>(lanes_of + Pc);
  short* list = lists + warp * T;
  int* tile_ids = reinterpret_cast<int*>(lists + warps * T);

  for (int e = threadIdx.x; e < Pc * stride; e += blockDim.x) acc[e] = 0.0;
  for (int e = threadIdx.x; e < Pc; e += blockDim.x) lanes_of[e] = 0u;

  auto copy_ids = [&](int t) {
    if (t >= tiles) return;
    const long long base = row0 + ((long long)t << tile_shift);
    int* dst = tile_ids + (t % kIdTiles) * T;
    for (int i = threadIdx.x; i < T; i += blockDim.x) {
      const bool ok = base + i < row_end;
      copy4(dst + i, rid + (ok ? base + i : 0), ok);
    }
  };
  auto copy_values = [&](int t) {  // once tile t's ids are visible
    if (t >= tiles) return;
    const long long base = row0 + ((long long)t << tile_shift);
    const int* ids = tile_ids + (t % kIdTiles) * T;
    double* dst = tile_vals + (t % kTiles) * (size_t)R * vstride;
    for (int i = threadIdx.x; i < T; i += blockDim.x) {  // a row, all R values
      const bool in = base + i < row_end && (unsigned)(ids[i] - c0) < (unsigned)pc;
      const double* src = vals + (in ? base + i : 0);
      for (int r = 0; r < R; ++r) copy8(dst + r * vstride + i, src + (size_t)r * n, in);
    }
  };

  // one group of copies a tile: the values of tile t + kTiles - 1 and the
  // ids of tile t + kIdTiles - 1 (the first tiles' ids come first, alone)
  for (int t = 0; t < kIdTiles - 1; ++t) copy_ids(t);
  commit_copies();
  wait_copies<0>();
  __syncthreads();  // those ids and the zeroed accumulator
  for (int t = 0; t < kTiles - 1; ++t) {
    copy_values(t);
    commit_copies();
  }
  for (int t = 0; t < tiles; ++t) {
    wait_copies<kTiles - 2>();
    __syncthreads();  // tile t's values, tile t + kTiles - 1's ids visible
    copy_values(t + kTiles - 1);
    copy_ids(t + kIdTiles - 1);
    commit_copies();
    const long long base = row0 + ((long long)t << tile_shift);
    const int rows = (int)min((long long)T, row_end - base);
    const int* ids = tile_ids + (t % kIdTiles) * T;
    const double* v = tile_vals + (t % kTiles) * (size_t)R * vstride;
    int count = 0;  // this warp's rows of the tile, listed in order
    for (int g0 = 0; g0 < rows; g0 += 32) {
      const int id = g0 + lane < rows ? ids[g0 + lane] : -1;
      const bool own = (unsigned)(id - c0) < (unsigned)pc && ((id - c0) & 7) == warp;
      const unsigned mask = __ballot_sync(kFull, own);
      if (own) list[count + __popc(mask & lt)] = (short)(g0 + lane);
      count += __popc(mask);
    }
    __syncwarp();
    for (int b0 = 0; b0 < count; b0 += 32) {
      const bool has = b0 + lane < count;
      const int row = has ? list[b0 + lane] : 0;
      const int slot = has ? ids[row] - c0 : -1;
      // the lanes of each slot: every lane ORs its bit into its slot's
      // word (an integer atomic; the result does not depend on the order)
      const int at = has ? (slot & 7) * q + (slot >> 3) : 0;
      volatile unsigned* word = lanes_of + at;
      if (has) atomicOr(const_cast<unsigned*>(word), 1u << lane);
      __syncwarp();
      const unsigned peers = has ? *word : 0u;
      __syncwarp();
      if (has && (peers & lt) == 0u) *word = 0u;  // cleared for the next batch
      const double* col = v + row;
      add_groups(peers, lane, acc + (size_t)at * stride, 1, R,
                 [&](int r) { return col[r * vstride]; });
    }
    __syncthreads();  // tile t's buffers are free for the next copies
  }
  wait_copies<0>();
  double* out = partials + ((size_t)blockIdx.y * P + c0) * R;
  for (int e = threadIdx.x; e < pc * R; e += blockDim.x) {
    const int p = e / R;
    out[e] = acc[(size_t)((p & 7) * q + (p >> 3)) * stride + (e - p * R)];
  }
}

// One warp per output element: lanes take partials b = lane, lane + 32, ...
// in order, then a fixed shuffle tree adds the 32 lane sums.
__global__ void reduce_partials(const double* __restrict__ partials, int nb,
                                int pairs, double* __restrict__ out) {
  const long long w = (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (w >= pairs) return;  // uniform across the warp
  double s = 0.0;
  for (int b = lane; b < nb; b += 32) s += partials[(size_t)b * pairs + w];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(kFull, s, off);
  if (lane == 0) out[w] = s;
}

template <int S>
cudaError_t launch(const int* rid, const double* vals, long long n, int R,
                   int P, int threads, int copies, int stride, int rw,
                   int tree_bits, int Pc, int chunks, int nb,
                   long long rows_per_block, int smem, double* partials,
                   cudaStream_t s) {
  auto kern = partial_sums<S>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<dim3(chunks, nb), threads, smem, s>>>(
      rid, vals, n, R, P, Pc, copies, stride, rw, tree_bits, rows_per_block,
      partials);
  return cudaGetLastError();
}

}  // namespace

#define LAUNCH_ARGS                                                          \
  rid, vals, n, R, P, threads, copies, stride, rw, tree_bits, Pc, chunks, \
      nb, rows_per_block, smem, partials, s

extern "C" {

// Launches both kernels on `stream`. `tile_shift` > 0 picks the owners
// kernel (tiles of 2^tile_shift rows); otherwise `stages` (the ring's
// depth: 4, 8 or 16) picks the instantiation of the lanes kernel. Returns
// a cudaError_t (0 = ok).
int onehot_sums_f64(const int* rid, const double* vals, long long n, int R,
                    int P, int threads, int copies, int stride, int rw,
                    int stages, int tree_bits, int tile_shift,
                    int Pc, int chunks, int nb, long long rows_per_block,
                    int smem, double* partials, double* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (tile_shift > 0) {
    e = cudaSuccess;
    if (smem > 48 * 1024) {
      e = cudaFuncSetAttribute(owner_sums,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    }
    if (e == cudaSuccess) {
      owner_sums<<<dim3(chunks, nb), threads, smem, s>>>(
          rid, vals, n, R, P, Pc, stride, tile_shift, rows_per_block, partials);
      e = cudaGetLastError();
    }
  } else {
    switch (stages) {
      case 4: e = launch<4>(LAUNCH_ARGS); break;
      case 8: e = launch<8>(LAUNCH_ARGS); break;
      case 16: e = launch<16>(LAUNCH_ARGS); break;
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (e != cudaSuccess) return (int)e;
  const int pairs = P * R;
  const int rthreads = 256;
  const int rblocks = (int)(((long long)pairs * 32 + rthreads - 1) / rthreads);
  reduce_partials<<<rblocks, rthreads, 0, s>>>(partials, nb, pairs, out);
  return (int)cudaGetLastError();
}

#undef LAUNCH_ARGS

const char* onehot_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
