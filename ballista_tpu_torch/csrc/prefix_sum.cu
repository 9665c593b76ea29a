// Inclusive f64 prefix sums of k columns, in an order of adds fixed by the
// shapes alone, on Hopper, in one pass over the input.
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
// -0.0, so the added +0.0 offsets, the +0.0 padding of a whole tile and
// levels of a single chunk change no bit.
//
// Replaces the reference's f64 prefix on the accelerator,
// ballista_tpu/ops/aggregate.py (_prefix_sum_2d, _mm_prefix: blocked
// upper-triangular products of block 512), which the sort aggregate's
// f64 SUMs run (prefix differences at the segment starts). torch.cumsum on
// a CUDA tensor is one device-wide scan whose order of adds can follow
// which block finishes first (decoupled look-back), so an f64 SUM was not
// bit-reproducible from run to run.
//
// Bound on an H100: memory. The kernel reads each input row once (8 bytes)
// and writes each output row once (8 bytes): 16 bytes a row a column, 28.7
// us for one column of 6,000,000 rows at 3.35 TB/s. The adds (two a row,
// plus a few a chunk) are far below the f64 rate. One call is one
// cudaMemsetAsync (the tile counter and the published values) and one
// launch.
//
// Design: a block scans one tile of kTile = 16^3 = 4,096 rows, so levels
// 0-2 of the rule lie inside it; the levels above are the tile totals'
// prefix, which a block takes from what the blocks before it publish.
//  1. Thread 0 takes the next (tile, column) from an integer counter, so a
//     block only waits on tiles that blocks already running have taken
//     (no deadlock, whatever the residency). Tiles go in order, the k
//     columns of a tile side by side.
//  2. The tile is copied once into shared memory with cp.async: 16-byte
//     pieces, or 8-byte ones zero-filled past n for the ragged last tile
//     and a column that is not 16-byte aligned. Pairs are swizzled (pair e
//     of chunk c at c * 8 + (e ^ (c & 7))), so the 8 threads of a
//     quarter-warp reading their chunks, or writing them, hit distinct
//     banks.
//  3. Level 0: thread u runs the sum over chunk u in place. Level 1: 16
//     lanes of warp 0 run the 16 groups of chunk totals (arrays padded to
//     stride 17). Level 2: lane 0 runs the 16 group totals and publishes
//     the tile's total G0 and its tail (A, the last level-2 total; B, the
//     running sum of the first 15).
//  4. Look-back, by warp 0: P(0, t - 1) and P(0, t - 2), the tile totals'
//     inclusive prefixes at the two tiles before t, by the rule, from the
//     published entries: at level a the entries G_a of the group of 16 that
//     holds index j_a up to j_a (j_0 = t - 1, j_(a+1) = j_a / 16 - 1), and,
//     where j_a opens its group, the previous group's total G_(a+1). The
//     tile that ends a group of 16 entries at level a publishes that
//     group's total G_(a+1), level by level before it waits on anything
//     else, so no chain of waits forms along a level. Lanes read the
//     entries in parallel; lane 0 adds in the fixed order. From these and
//     tile t - 1's tail come the tile's three offsets: X3 = P(0, t - 1) for
//     its level-2 entries, X2 = P(0, t - 2) + G0[t - 1] for its first group
//     of chunk totals, X1 = (P(0, t - 2) + B) + A for its first chunk (all
//     +0.0 at t = 0).
//  5. Each thread adds its chunk's offset to its 16 sums, and the block
//     stores the tile with 16-byte stores.
// A published value is a pair (bits, ~bits) written with one 16-byte
// store into scratch the call's memset cleared; a reader loads the pair
// until the second word is the complement of the first. Each 8-byte half
// is read whole and is either 0 or its final value, so a pair that checks
// holds the value: no flag, no fence, one load. The integer atomic of step
// 1 is the only atomic. Counter and pairs live in the call's own scratch,
// so concurrent calls on other streams share nothing.
// tests/test_torch_prefix_sum.py (one_pass_model) holds this decomposition
// against the rule on the CPU.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 16;
constexpr int kThreads = 256;                    // one chunk a thread
constexpr int kTile = kChunk * kChunk * kChunk;  // 4,096 rows a block
constexpr int kPieces = kTile / 2 / kThreads;    // 16-byte pieces a thread
constexpr int kPad = kChunk + 1;                 // stride of level 1's arrays
constexpr int kLevels = 8;                       // look-back levels: < 16^8 tiles
constexpr int kSlots = kChunk + 1;               // a level's look-back values
constexpr int kBlocksPerSm = 6;                  // 36 KB of shared memory each

typedef unsigned long long u64;

// Publishes v as the pair (bits, ~bits), one 16-byte store.
__device__ __forceinline__ void put(u64* p, double v) {
  const u64 b = (u64)__double_as_longlong(v);
  asm volatile("st.relaxed.gpu.global.v2.u64 [%0], {%1, %2};" ::"l"(p), "l"(b), "l"(~b)
               : "memory");
}

// The value published at p, once its pair checks.
__device__ __forceinline__ double get(const u64* p) {
  for (;;) {
    u64 a, b;
    asm volatile("ld.relaxed.gpu.global.v2.u64 {%0, %1}, [%2];" : "=l"(a), "=l"(b) : "l"(p)
                 : "memory");
    if (b == ~a) return __longlong_as_double((long long)a);
    __nanosleep(32);
  }
}

// The swizzled 16-byte slot of pair e (0-7) of chunk c in the shared tile.
__device__ __forceinline__ int slot(int c, int e) { return c * 8 + (e ^ (c & 7)); }

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Where a published pair lies (in pairs): each tile's three (total, A, B),
// then the group totals of levels 1 and up, each column's contiguous.
struct Layout {
  long long tiles;
  long long size[kLevels];  // entries a column has at level a (a >= 1)
  long long off[kLevels];   // where level a starts
  __device__ Layout(long long tiles_, int k) : tiles(tiles_) {
    long long s = tiles / kChunk, o = 3LL * k * tiles;
    for (int a = 1; a < kLevels; ++a) {
      size[a] = s;
      off[a] = o;
      o += (long long)k * s;
      s /= kChunk;
    }
  }
  // level 0: which = 0 (total), 1 (A), 2 (B)
  __device__ long long tile(int col, long long t, int which) const {
    return 3 * (col * tiles + t) + which;
  }
  __device__ long long at(int a, int col, long long j) const {
    return a == 0 ? tile(col, j, 0) : off[a] + col * size[a] + j;
  }
};

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
fixed_order_scan(const double* __restrict__ x, long long n, int k, long long tiles,
                 double* __restrict__ out, u64* __restrict__ pairs,
                 unsigned* __restrict__ counter) {
  __shared__ __align__(16) double s[kTile];
  __shared__ double l1[kChunk * kPad];  // chunk totals, then level 1's sums
  __shared__ double l2[kChunk];         // level 2's totals, then its sums
  __shared__ double lb[kLevels][kSlots];
  __shared__ double locs[kLevels][2];
  __shared__ double tail[2];
  __shared__ double xs[3];
  __shared__ unsigned s_idx;

  const int u = threadIdx.x;
  if (u == 0) s_idx = atomicAdd(counter, 1u);
  __syncthreads();
  const long long t = s_idx / k;
  const int col = (int)(s_idx % k);
  const long long base = t * kTile;
  const double* xc = x + col * n + base;
  double* oc = out + col * n + base;
  const bool vec = base + kTile <= n &&
      ((reinterpret_cast<uintptr_t>(xc) | reinterpret_cast<uintptr_t>(oc)) & 15) == 0;
  double2* sp = reinterpret_cast<double2*>(s);

  // 2. the tile into shared memory, once
  if (vec) {
#pragma unroll
    for (int i = 0; i < kPieces; ++i) {
      const int p = u + i * kThreads;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                       smem_addr(s + 2 * slot(p >> 3, p & 7))),
                   "l"(xc + 2 * p)
                   : "memory");
    }
  } else {
    for (int j = u; j < kTile; j += kThreads) {
      const int e = j % kChunk;
      const bool in = base + j < n;
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;" ::"r"(
                       smem_addr(s + 2 * slot(j / kChunk, e >> 1) + (e & 1))),
                   "l"(xc + (in ? j : 0)), "r"(in ? 8 : 0)
                   : "memory");
    }
  }
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();

  // 3. level 0: chunk u, running from +0.0, in place
  {
    double acc = 0.0;
#pragma unroll
    for (int e = 0; e < kChunk / 2; ++e) {
      double2 v = sp[slot(u, e)];
      acc = __dadd_rn(acc, v.x);
      v.x = acc;
      acc = __dadd_rn(acc, v.y);
      v.y = acc;
      sp[slot(u, e)] = v;
    }
    l1[(u / kChunk) * kPad + u % kChunk] = acc;
  }
  __syncthreads();

  // 3, 4. warp 0: levels 1 and 2, publish, look back
  if (u < 32) {
    const int lane = u;
    const Layout lay(tiles, k);
    if (lane < kChunk) {
      double* row = l1 + lane * kPad;
      double acc = 0.0;
#pragma unroll
      for (int w = 0; w < kChunk; ++w) {
        acc = __dadd_rn(acc, row[w]);
        row[w] = acc;
      }
      l2[lane] = acc;
    }
    __syncwarp();
    double own = 0.0;  // lane 0: this tile's entry at the level reached
    if (lane == 0) {
      const double a = l2[kChunk - 1];
      double acc = 0.0, prev = 0.0;
      for (int v = 0; v < kChunk; ++v) {
        prev = acc;
        acc = __dadd_rn(acc, l2[v]);
        l2[v] = acc;
      }
      put(pairs + 2 * lay.tile(col, t, 0), acc);
      put(pairs + 2 * lay.tile(col, t, 1), a);
      put(pairs + 2 * lay.tile(col, t, 2), prev);
      own = acc;
    }

    // the levels j_a; the levels at which this tile ends a group
    long long js[kLevels];
    int nl = 0, ends = 0;
    if (t > 0) {
      for (long long j = t - 1;;) {
        js[nl++] = j;
        if (j / kChunk == 0) break;
        j = j / kChunk - 1;
      }
      for (long long i = t; i % kChunk == kChunk - 1 && ends < nl; i /= kChunk) ++ends;
    }

    // lanes read the entries of levels [lo, hi) in parallel; lane 0 then
    // runs each level's sums: locs[a] = (loc(a, j_a), loc(a, j_a - 1))
    auto fetch = [&](int lo, int hi) {
      for (int sl = lane; sl < (hi - lo) * kSlots; sl += 32) {
        const int a = lo + sl / kSlots, i = sl % kSlots;
        const long long j = js[a], q = j / kChunk;
        if (i == kChunk) {
          if (j % kChunk == 0 && q > 0) lb[a][i] = get(pairs + 2 * lay.at(a + 1, col, q - 1));
        } else if (i <= j % kChunk) {
          lb[a][i] = get(pairs + 2 * lay.at(a, col, q * kChunk + i));
          if (a == 0 && i == j % kChunk) {
            tail[0] = get(pairs + 2 * lay.tile(col, j, 1));
            tail[1] = get(pairs + 2 * lay.tile(col, j, 2));
          }
        }
      }
      __syncwarp();
      if (lane == 0) {
        for (int a = lo; a < hi; ++a) {
          const int last = (int)(js[a] % kChunk);
          double acc = 0.0, prev = 0.0;
          for (int i = 0; i <= last; ++i) {
            prev = acc;
            acc = __dadd_rn(acc, lb[a][i]);
          }
          locs[a][0] = acc;
          locs[a][1] = last ? prev : (js[a] ? lb[a][kChunk] : 0.0);
        }
      }
    };

    // a group this tile ends is published before any other wait
    long long ia = t;
    for (int a = 0; a < ends; ++a) {
      fetch(a, a + 1);
      if (lane == 0) {
        own = __dadd_rn(locs[a][0], own);
        ia /= kChunk;
        put(pairs + 2 * lay.at(a + 1, col, ia), own);
      }
      __syncwarp();
    }
    fetch(ends, nl);
    if (lane == 0) {
      double p1 = 0.0, p2 = 0.0;  // P(a, j_a), P(a, j_a - 1), from the top
      for (int a = nl - 1; a >= 0; --a) {
        const long long j = js[a], q = j / kChunk;
        const double off = q > 0 ? p1 : 0.0;
        const double off_prev = q > 1 ? p2 : 0.0;
        p1 = __dadd_rn(off, locs[a][0]);
        p2 = __dadd_rn(j % kChunk ? off : off_prev, locs[a][1]);
      }
      if (t == 0) {
        xs[0] = xs[1] = xs[2] = 0.0;
      } else {
        const double o3 = t >= 2 ? p2 : 0.0;
        xs[0] = __dadd_rn(__dadd_rn(o3, tail[1]), tail[0]);
        xs[1] = __dadd_rn(o3, lb[0][(t - 1) % kChunk]);
        xs[2] = p1;
      }
    }
  }
  __syncthreads();

  // 5. chunk u's offset, the prefix at the chunk before it, onto its sums
  double off1 = xs[0];
  if (u > 0) {
    const int up = u - 1, vp = up / kChunk;
    const double off2 = vp > 0 ? __dadd_rn(xs[2], l2[vp - 1]) : xs[1];
    off1 = __dadd_rn(off2, l1[vp * kPad + up % kChunk]);
  }
#pragma unroll
  for (int e = 0; e < kChunk / 2; ++e) {
    const double2 v = sp[slot(u, e)];
    sp[slot(u, e)] = make_double2(__dadd_rn(off1, v.x), __dadd_rn(off1, v.y));
  }
  __syncthreads();
  if (vec) {
    double2* op = reinterpret_cast<double2*>(oc);
#pragma unroll
    for (int i = 0; i < kPieces; ++i) {
      const int p = u + i * kThreads;
      op[p] = sp[slot(p >> 3, p & 7)];
    }
  } else {
    for (int j = u; j < kTile && base + j < n; j += kThreads) {
      const int e = j % kChunk;
      oc[j] = s[2 * slot(j / kChunk, e >> 1) + (e & 1)];
    }
  }
}

// Published pairs of one column: three a tile, and the group totals of
// levels 1 and up.
long long pairs_per_column(long long tiles) {
  long long p = 3 * tiles;
  for (long long s = tiles / kChunk; s > 0; s /= kChunk) p += s;
  return p;
}

}  // namespace

extern "C" {

// The chunk and tile lengths the association and the grid are defined by
// (the wrapper checks them against its own).
int prefix_sum_chunk() { return kChunk; }
int prefix_sum_tile() { return kTile; }

// Clears `scratch` and launches the scan on `stream`. x and out: k * n
// doubles each (column c at c * n); scratch: 16-byte aligned, words = 2 +
// 2 * k * pairs_per_column(tiles) 64-bit words (the tile counter, then the
// published pairs). Returns a cudaError_t (0 = ok).
int prefix_sum_f64(const double* x, long long n, int k, u64* scratch, long long words,
                   double* out, void* stream) {
  if (n <= 0 || k <= 0) return (int)cudaErrorInvalidValue;
  const long long tiles = (n + kTile - 1) / kTile;
  if (words != 2 + 2 * k * pairs_per_column(tiles) || k * tiles > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = cudaMemsetAsync(scratch, 0, words * sizeof(u64), st);
  if (err != cudaSuccess) return (int)err;
  fixed_order_scan<<<(unsigned)(k * tiles), kThreads, 0, st>>>(
      x, n, k, tiles, out, scratch + 2, reinterpret_cast<unsigned*>(scratch));
  return (int)cudaGetLastError();
}

const char* prefix_sum_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
