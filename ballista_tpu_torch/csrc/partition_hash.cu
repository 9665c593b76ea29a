// Row hash, hash-partition ids and rows grouped by partition, on Hopper.
//
// For each row i, h = 0 and, for each key column c in order,
//     h = splitmix64(h ^ splitmix64(lane(c, i)))
// in uint64 arithmetic. Three modes:
//  - hash-only: hash[i] = h, as int64 bits;
//  - partition ids: pid[i] = h % K (unsigned) for a valid row, K for an
//    invalid one (the drop bucket);
//  - grouped: pid as above, and order = the row indices sorted stably by
//    pid (bucket 0's rows in row order, then bucket 1's, ..., the invalid
//    rows last), with offsets[b] = where bucket b starts (offsets[K] = the
//    valid rows, offsets[K + 1] = n).
//
// Replaces the XLA program of the reference's hash routing:
// ballista_tpu/ops/partition.py (partition_ids_for, partition_ids) over
// ballista_tpu/ops/hashing.py (_splitmix64, _to_u64, hash_columns), which
// the shuffle writer and the grace-hash spill run on every routed row, and
// which the hash-packed join keys run; and, in the grouped mode, the host
// numpy argsort with which the reference's SpillSet.write_split
// (ballista_tpu/exec/spill.py) groups each spilled batch by bucket. torch
// has no uint64 add, shift or remainder; the plain version
// (ops/partition.py, partition_ids_plain, partition_groups_plain) emulates
// them with a chain of about 15 int64 programs a column, then a stable
// argsort and a bincount.
//
// lane(c, i), in the reference's order:
//  1. a string column (int32 dictionary codes) goes through its table of
//     per-value hashes: table[clamp(code, 0, len - 1)], so that equal
//     strings route alike whatever their codes in a batch's dictionary;
//  2. a null row's value is zeroed, after the table: a null string hashes
//     0, not table[0];
//  3. integers and bools sign-extend to 64 bits;
//  4. floats narrow to f32 (round to nearest even), -0.0 becomes +0.0 (the
//     reference's "+ 0.0"), and the 32 bits are zero-extended; every NaN
//     hashes as the positive quiet NaN 0x7FC00000 (the port's rule: GROUP BY
//     puts every NaN in one group, so they must route to one partition).
// The build keeps IEEE arithmetic (no flush to zero): f32 subnormals keep
// their bits.
//
// h % K without a 64-bit division (a software routine on the card): with
// m = floor((2^64 - 1) / K), computed once a launch, q = umulhi(h, m) is
// floor(h / K) or one less, for every uint64 h (h * m / 2^64 lies within
// h / 2^64 < 1 below h / K), so r = h - q * K lies in [0, 2K) and one
// conditional subtraction ends it.
//
// Bound on an H100: memory. The ids mode reads each key column once (1 to
// 8 bytes a row), 1 byte a row of the valid mask and of each null mask,
// and 8 bytes a row for each string-table gather, and writes 4 bytes a
// row (8 in the hash-only mode): for one int32 key at 2^21 rows, 9 bytes a
// row, 5.6 us at 3.35 TB/s. The grouped mode also reads its 4-byte ids
// back and writes 4 bytes of order a row: 17 bytes a row, 10.6 us. The
// instructions come close behind: a row's two splitmix64 and the modulo
// are about 50 32-bit integer instructions, 20 of them multiplies, which
// an SM runs at half the rate of the others; at one 4-byte key their time
// is of the order of the bytes' time.
//
// Design:
//  - Keys: up to kMaxCols key columns passed by value as descriptors (data,
//    dtype, null mask, string table), so a launch needs no device-side
//    argument buffer (more key columns chain launches through h0).
//  - Loads: each thread takes kVec = 4 consecutive rows a step, with one
//    16-byte load of a 4-byte key (two of an 8-byte one, one 4-byte load of
//    a bool key, a null mask or the valid mask) and one 16-byte store of
//    the ids, where every pointer is aligned for it (the host checks, once
//    a launch); otherwise, and on a ragged tail, row by row.
//  - Modulo: a power-of-two K (the spills' 64) masks; any other K takes
//    the multiply-high above.
//  - Ids and hash-only modes: one kernel, grid-stride over the steps.
//  - Grouped mode: three kernels on the stream, with no global atomics and
//    no float arithmetic, so two launches are bit-identical.
//    1. count: one block a tile of kTile rows hashes them, writes their
//       ids, and counts each bucket's rows of the tile in shared memory
//       (integer atomics, exact in any order); it writes the tile's counts
//       to counts[b][tile] (bucket-major).
//    2. scan: one block a bucket turns its row of counts into an exclusive
//       scan over the tiles (where the tile's rows of that bucket start
//       inside the bucket) and writes the bucket's total.
//    3. place: one block a tile reads its ids back (coalesced, 4 bytes a
//       row; the buckets' totals and the tile's starts are read at the same
//       time) and ranks each row among the rows of its bucket before it in
//       the tile. Each warp takes a contiguous stretch of 512 rows, 32 a
//       round, so warp order and round order are row order; the warps
//       count their rows of each bucket in shared memory (atomics), and
//       those counts, scanned in warp order, place the warps. In a round,
//       peers_of gives a row's peers (the lanes of its bucket) and
//       __popc(peers & lanes below) its rank among them; the lowest peer
//       then moves the warp's start in that bucket on. Bucket starts are
//       the exclusive scan of the buckets' totals, which each block scans
//       for itself (K + 1 <= 1025 values). The tile's rows are first placed
//       in shared memory in bucket order, then written out in that order,
//       so that a bucket's rows of one tile go to consecutive addresses
//       (coalesced stores, not one scattered 4-byte store a row).
//       __launch_bounds__ caps the kernel at 64 registers so that four
//       blocks share an SM.
//    K of the grouped mode is at most kMaxGroups = 1024: the place kernel
//    keeps 11 (K + 1) ints and 2 kTile ints of shared memory (35 KB at the
//    spills' K = 64, 76 KB at K = 1024).

#include <cuda_runtime.h>

// A key column as the wrapper passes it (ops/partition.py, _KEYCOL). Outside
// the unnamed namespace: the exported C functions take it.
struct KeyCol {
  const void* data;
  const unsigned char* nulls;           // 1 = null, or nullptr
  const unsigned long long* table;      // per-code value hashes, or nullptr
  long long table_len;
  int dtype;
};

namespace {

constexpr int kMaxCols = 8;
constexpr int kVec = 4;                      // rows a thread takes a step
constexpr int kThreads = 256;                // threads a block, every kernel
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 4096;                  // rows a block of the grouped mode
constexpr int kStepsPerTile = kTile / (kVec * kThreads);  // 4
constexpr int kWarpRows = kTile / kWarps;    // 512 consecutive rows a warp
constexpr int kRounds = kWarpRows / 32;      // 16
constexpr int kMaxGroups = 1024;
constexpr int kMaxBlocks = 132 * 8;          // whole waves over 132 SMs
constexpr unsigned kFull = 0xffffffffu;

// dtype codes (ops/partition.py, _DTYPE_CODES); 2 is int64
constexpr int kBool = 0;
constexpr int kInt32 = 1;
constexpr int kF32 = 3;
constexpr int kF64 = 4;

struct Keys {
  KeyCol col[kMaxCols];
  int ncols;
};

struct Mod {
  unsigned long long k;
  unsigned long long magic;  // floor((2^64 - 1) / k)
  bool pow2;                 // k is a power of two: h % k = h & (k - 1)
};

Mod make_mod(unsigned long long k) {
  return Mod{k, ~0ull / k, (k & (k - 1)) == 0};
}

__device__ __forceinline__ unsigned long long splitmix64(unsigned long long x) {
  x += 0x9E3779B97F4A7C15ull;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
  return x ^ (x >> 31);
}

__device__ __forceinline__ unsigned long long umod(unsigned long long h, Mod m) {
  if (m.pow2) return h & (m.k - 1);
  const unsigned long long r = h - __umul64hi(h, m.magic) * m.k;
  return r >= m.k ? r - m.k : r;
}

// The lanes of the warp whose `label` equals this lane's, for labels in
// [0, 2^nbits): one ballot a bit of the label, each keeping the lanes that
// agree on that bit (nbits = 7 at K = 64). Chosen over __match_any_sync,
// whose cost grows with the distinct labels in the warp: on ids spread over
// 65 buckets (the spills' keys) the ballots took less time on the card, on
// ids of which most share one bucket more.
__device__ __forceinline__ unsigned peers_of(int label, int nbits) {
  unsigned m = kFull;
  for (int b = 0; b < nbits; ++b) {
    const bool bit = (label >> b) & 1;
    const unsigned v = __ballot_sync(kFull, bit);
    m &= bit ? v : ~v;
  }
  return m;
}

__device__ __forceinline__ unsigned long long float_lane(float f) {
  if (f != f) return 0x7FC00000ull;  // every NaN alike
  if (f == 0.0f) return 0ull;        // -0.0 as +0.0
  return static_cast<unsigned long long>(__float_as_uint(f));
}

// An integer key's lane: through the string table where there is one.
__device__ __forceinline__ unsigned long long int_lane(const KeyCol& c, long long x) {
  if (c.table == nullptr) return static_cast<unsigned long long>(x);
  const long long k = x < 0 ? 0 : (x >= c.table_len ? c.table_len - 1 : x);
  return __ldg(c.table + k);
}

// lane(c, i) of one row.
__device__ __forceinline__ unsigned long long lane(const KeyCol& c, long long i) {
  unsigned long long v;
  if (c.dtype == kF32) {
    v = float_lane(static_cast<const float*>(c.data)[i]);
  } else if (c.dtype == kF64) {
    v = float_lane(__double2float_rn(static_cast<const double*>(c.data)[i]));
  } else if (c.dtype == kBool) {
    v = int_lane(c, static_cast<const unsigned char*>(c.data)[i] ? 1 : 0);
  } else if (c.dtype == kInt32) {
    v = int_lane(c, static_cast<const int*>(c.data)[i]);
  } else {
    v = int_lane(c, static_cast<const long long*>(c.data)[i]);
  }
  if (c.nulls != nullptr && c.nulls[i]) v = 0;
  return v;
}

// lane(c, r .. r + 3) with wide loads; r % 4 == 0, the rows in range and
// the pointers aligned (the host checks).
__device__ __forceinline__ void lanes4(const KeyCol& c, long long r, unsigned long long v[kVec]) {
  if (c.dtype == kF32) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(static_cast<const float*>(c.data) + r));
    v[0] = float_lane(x.x); v[1] = float_lane(x.y); v[2] = float_lane(x.z); v[3] = float_lane(x.w);
  } else if (c.dtype == kF64) {
    const double2* p = reinterpret_cast<const double2*>(static_cast<const double*>(c.data) + r);
    const double2 a = __ldg(p), b = __ldg(p + 1);
    v[0] = float_lane(__double2float_rn(a.x)); v[1] = float_lane(__double2float_rn(a.y));
    v[2] = float_lane(__double2float_rn(b.x)); v[3] = float_lane(__double2float_rn(b.y));
  } else {
    long long x[kVec];
    if (c.dtype == kBool) {
      const uchar4 u = __ldg(reinterpret_cast<const uchar4*>(static_cast<const unsigned char*>(c.data) + r));
      x[0] = u.x ? 1 : 0; x[1] = u.y ? 1 : 0; x[2] = u.z ? 1 : 0; x[3] = u.w ? 1 : 0;
    } else if (c.dtype == kInt32) {
      const int4 u = __ldg(reinterpret_cast<const int4*>(static_cast<const int*>(c.data) + r));
      x[0] = u.x; x[1] = u.y; x[2] = u.z; x[3] = u.w;
    } else {
      const longlong2* p = reinterpret_cast<const longlong2*>(static_cast<const long long*>(c.data) + r);
      const longlong2 a = __ldg(p), b = __ldg(p + 1);
      x[0] = a.x; x[1] = a.y; x[2] = b.x; x[3] = b.y;
    }
#pragma unroll
    for (int j = 0; j < kVec; ++j) v[j] = int_lane(c, x[j]);
  }
  if (c.nulls != nullptr) {
    const uchar4 m = __ldg(reinterpret_cast<const uchar4*>(c.nulls + r));
    if (m.x) v[0] = 0;
    if (m.y) v[1] = 0;
    if (m.z) v[2] = 0;
    if (m.w) v[3] = 0;
  }
}

// The hashes of rows r .. r + 3 (those below n): wide loads when `vec` and
// the four rows are in range, else row by row.
__device__ __forceinline__ void hash4(const Keys& keys, const long long* h0, long long r,
                                      long long n, bool vec, unsigned long long h[kVec]) {
  const bool wide = vec && r + kVec <= n;
  if (h0 == nullptr) {
#pragma unroll
    for (int j = 0; j < kVec; ++j) h[j] = 0;
  } else if (wide) {
    const longlong2* p = reinterpret_cast<const longlong2*>(h0 + r);
    const longlong2 a = __ldg(p), b = __ldg(p + 1);
    h[0] = a.x; h[1] = a.y; h[2] = b.x; h[3] = b.y;
  } else {
#pragma unroll
    for (int j = 0; j < kVec; ++j) h[j] = r + j < n ? static_cast<unsigned long long>(h0[r + j]) : 0;
  }
#pragma unroll
  for (int c = 0; c < kMaxCols; ++c) {
    if (c >= keys.ncols) break;
    unsigned long long v[kVec];
    if (wide) {
      lanes4(keys.col[c], r, v);
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j) v[j] = r + j < n ? lane(keys.col[c], r + j) : 0;
    }
#pragma unroll
    for (int j = 0; j < kVec; ++j) h[j] = splitmix64(h[j] ^ splitmix64(v[j]));
  }
}

// Partition ids of rows r .. r + 3 (K for an invalid row), written to pid.
__device__ __forceinline__ void ids4(const unsigned long long h[kVec], const unsigned char* valid,
                                     long long r, long long n, bool vec, Mod mod, int* pid,
                                     int p[kVec]) {
  if (vec && r + kVec <= n) {
    const uchar4 ok = __ldg(reinterpret_cast<const uchar4*>(valid + r));
    const int k = static_cast<int>(mod.k);
    p[0] = ok.x ? static_cast<int>(umod(h[0], mod)) : k;
    p[1] = ok.y ? static_cast<int>(umod(h[1], mod)) : k;
    p[2] = ok.z ? static_cast<int>(umod(h[2], mod)) : k;
    p[3] = ok.w ? static_cast<int>(umod(h[3], mod)) : k;
    *reinterpret_cast<int4*>(pid + r) = make_int4(p[0], p[1], p[2], p[3]);
  } else {
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      p[j] = -1;  // past n
      if (r + j < n) {
        p[j] = valid[r + j] ? static_cast<int>(umod(h[j], mod)) : static_cast<int>(mod.k);
        pid[r + j] = p[j];
      }
    }
  }
}

// Ids and hash-only modes: grid-stride over steps of kVec rows.
__global__ void __launch_bounds__(kThreads)
partition_hash_kernel(Keys keys, const long long* h0, const unsigned char* valid, long long n,
                      Mod mod, int* pid, long long* hash, bool vec) {
  const long long steps = (n + kVec - 1) / kVec;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long s = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; s < steps;
       s += stride) {
    const long long r = s * kVec;
    unsigned long long h[kVec];
    hash4(keys, h0, r, n, vec, h);
    if (pid != nullptr) {
      int p[kVec];
      ids4(h, valid, r, n, vec, mod, pid, p);
    } else if (vec && r + kVec <= n) {
      longlong2* q = reinterpret_cast<longlong2*>(hash + r);
      q[0] = make_longlong2(static_cast<long long>(h[0]), static_cast<long long>(h[1]));
      q[1] = make_longlong2(static_cast<long long>(h[2]), static_cast<long long>(h[3]));
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        if (r + j < n) hash[r + j] = static_cast<long long>(h[j]);
      }
    }
  }
}

// Grouped mode, 1: ids of one tile and its count of rows in each bucket,
// to counts[b * ntiles + tile]. Dynamic shared memory: K + 1 ints.
__global__ void __launch_bounds__(kThreads)
partition_count_kernel(Keys keys, const long long* h0, const unsigned char* valid, long long n,
                       Mod mod, int* pid, int* counts, int ntiles, bool vec) {
  extern __shared__ int hist[];
  const int buckets = static_cast<int>(mod.k) + 1;
  for (int b = threadIdx.x; b < buckets; b += kThreads) hist[b] = 0;
  __syncthreads();
  const long long tile0 = static_cast<long long>(blockIdx.x) * kTile;
#pragma unroll
  for (int s = 0; s < kStepsPerTile; ++s) {
    const long long r = tile0 + (static_cast<long long>(s) * kThreads + threadIdx.x) * kVec;
    unsigned long long h[kVec];
    int p[kVec];
    hash4(keys, h0, r, n, vec, h);
    ids4(h, valid, r, n, vec, mod, pid, p);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      if (p[j] >= 0) atomicAdd(&hist[p[j]], 1);  // exact in any order
    }
  }
  __syncthreads();
  for (int b = threadIdx.x; b < buckets; b += kThreads) {
    counts[static_cast<long long>(b) * ntiles + blockIdx.x] = hist[b];
  }
}

// The exclusive scan of x over the block; *total = the block's sum.
// `sums` is kWarps + 1 ints of shared memory.
__device__ __forceinline__ int block_exclusive_scan(int x, int* sums, int* total) {
  const int lane_id = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, d);
    if (lane_id >= d) incl += y;
  }
  if (lane_id == 31) sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int s = lane_id < kWarps ? sums[lane_id] : 0;
    int si = s;
#pragma unroll
    for (int d = 1; d < kWarps; d <<= 1) {
      const int y = __shfl_up_sync(kFull, si, d);
      if (lane_id >= d) si += y;
    }
    if (lane_id < kWarps) sums[lane_id] = si - s;
    if (lane_id == kWarps - 1) sums[kWarps] = si;
  }
  __syncthreads();
  const int out = incl - x + sums[warp];
  *total = sums[kWarps];
  __syncthreads();  // sums is free again
  return out;
}

// Grouped mode, 2: one block a bucket b; counts[b][*] becomes its
// exclusive scan over the tiles, totals[b] the bucket's rows.
__global__ void __launch_bounds__(kThreads)
partition_scan_kernel(int* counts, int* totals, int ntiles) {
  __shared__ int sums[kWarps + 1];
  int* row = counts + static_cast<long long>(blockIdx.x) * ntiles;
  int carry = 0;
  for (int t0 = 0; t0 < ntiles; t0 += kThreads) {
    const int t = t0 + threadIdx.x;
    const int x = t < ntiles ? row[t] : 0;
    int total;
    const int excl = block_exclusive_scan(x, sums, &total);
    if (t < ntiles) row[t] = carry + excl;
    carry += total;
  }
  if (threadIdx.x == 0) totals[blockIdx.x] = carry;
}

// Grouped mode, 3: one block a tile places its rows. Dynamic shared
// memory: whist[kWarps][K + 1], delta, btotal and tprefix [K + 1] each,
// slot_row[kTile], slot_pos[kTile].
__global__ void __launch_bounds__(kThreads, 4)
partition_place_kernel(const int* pid, const int* counts, const int* totals, long long n, int K,
                       int* order, long long* offsets, int ntiles) {
  extern __shared__ int smem[];
  __shared__ int sums[kWarps + 1];
  const int buckets = K + 1;
  int* whist = smem;                         // [kWarps][buckets]
  int* delta = whist + kWarps * buckets;     // [buckets]
  int* btotal = delta + buckets;             // [buckets]
  int* tprefix = btotal + buckets;           // [buckets]
  int* slot_row = tprefix + buckets;         // [kTile]
  int* slot_pos = slot_row + kTile;          // [kTile]
  const int lane_id = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane_id) - 1u;
  const long long tile0 = static_cast<long long>(blockIdx.x) * kTile;
  const long long row0 = tile0 + static_cast<long long>(warp) * kWarpRows;
  const int nbits = 32 - __clz(buckets);

  // the buckets' totals and this tile's start in each: read first, used
  // after the counting below
  for (int b = threadIdx.x; b < buckets; b += kThreads) {
    btotal[b] = totals[b];
    tprefix[b] = counts[static_cast<long long>(b) * ntiles + blockIdx.x];
  }
  for (int j = threadIdx.x; j < kWarps * buckets; j += kThreads) whist[j] = 0;
  int p[kRounds];
#pragma unroll
  for (int q = 0; q < kRounds; ++q) {
    const long long i = row0 + q * 32 + lane_id;
    p[q] = i < n ? __ldg(pid + i) : -1;
  }
  __syncthreads();
  // each warp's count of its rows in each bucket
  int* mine = whist + warp * buckets;
#pragma unroll
  for (int q = 0; q < kRounds; ++q) {
    if (p[q] >= 0) atomicAdd(&mine[p[q]], 1);
  }
  __syncthreads();

  // buckets in contiguous runs of `per` a thread: the tile's count and the
  // bucket's total of each, scanned over the buckets, give where the
  // bucket's rows of this tile start in shared memory (local) and in
  // `order` (global); the warps' counts become each warp's start
  const int per = (buckets + kThreads - 1) / kThreads;
  const int b0 = min(buckets, static_cast<int>(threadIdx.x) * per);
  const int b1 = min(buckets, b0 + per);
  int tile_sum = 0, total_sum = 0;
  for (int b = b0; b < b1; ++b) {
    for (int w = 0; w < kWarps; ++w) tile_sum += whist[w * buckets + b];
    total_sum += btotal[b];
  }
  int ignored;
  int local = block_exclusive_scan(tile_sum, sums, &ignored);
  int global = block_exclusive_scan(total_sum, sums, &ignored);
  for (int b = b0; b < b1; ++b) {
    if (blockIdx.x == 0) offsets[b] = global;
    delta[b] = global + tprefix[b] - local;
    for (int w = 0; w < kWarps; ++w) {
      const int c = whist[w * buckets + b];
      whist[w * buckets + b] = local;
      local += c;
    }
    global += btotal[b];
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) offsets[buckets] = n;
  __syncthreads();

  // each row's slot: its warp's start in its bucket plus its rank among
  // its peers of the round; the lowest peer then moves the start on
#pragma unroll
  for (int q = 0; q < kRounds; ++q) {
    const unsigned pe = peers_of(p[q] >= 0 ? p[q] : buckets, nbits);
    int c = 0;
    if (p[q] >= 0) {
      const int slot = mine[p[q]] + __popc(pe & below);
      slot_row[slot] = static_cast<int>(row0 + q * 32 + lane_id);
      slot_pos[slot] = slot + delta[p[q]];
      c = __popc(pe);
    }
    __syncwarp();
    if (c && lane_id == __ffs(pe) - 1) mine[p[q]] += c;
    __syncwarp();
  }
  __syncthreads();

  const int rows = static_cast<int>(min(static_cast<long long>(kTile), n - tile0));
  for (int j = threadIdx.x; j < rows; j += kThreads) order[slot_pos[j]] = slot_row[j];
}

size_t place_smem_bytes(int K) {
  return sizeof(int) * (static_cast<size_t>(kWarps + 3) * (K + 1) + 2 * kTile);
}

bool aligned(const void* p, unsigned long long a) {
  return (reinterpret_cast<unsigned long long>(p) & (a - 1)) == 0;
}

// Whether every pointer of a launch takes the wide loads and stores.
bool wide_ok(const KeyCol* cols, int ncols, const void* h0, const void* valid, const void* out) {
  if (!aligned(h0, 16) || !aligned(valid, 4) || !aligned(out, 16)) return false;
  for (int c = 0; c < ncols; ++c) {
    if (!aligned(cols[c].data, cols[c].dtype == kBool ? 4 : 16)) return false;
    if (!aligned(cols[c].nulls, 4)) return false;
  }
  return true;
}

// The checks of every mode; fills `keys`.
bool take_keys(const KeyCol* cols, int ncols, long long n, Keys* keys) {
  if (ncols < 1 || ncols > kMaxCols || n < 0) return false;
  *keys = Keys{};
  for (int c = 0; c < ncols; ++c) {
    if (cols[c].data == nullptr || cols[c].dtype < kBool || cols[c].dtype > kF64) return false;
    if (cols[c].table != nullptr && cols[c].table_len < 1) return false;
    keys->col[c] = cols[c];
  }
  keys->ncols = ncols;
  return true;
}

int steps_blocks(long long n) {
  const long long steps = (n + kVec - 1) / kVec;
  const long long blocks = (steps + kThreads - 1) / kThreads;
  return static_cast<int>(blocks < kMaxBlocks ? (blocks > 0 ? blocks : 1) : kMaxBlocks);
}

}  // namespace

extern "C" {

// Rows a tile of the grouped mode (ops/partition.py sizes its scratch by it).
int partition_groups_tile_rows() { return kTile; }

// Launches the ids or hash-only mode on `stream` over n rows of `ncols`
// key columns (1..8), starting each row's hash from h0[i] (a launch over
// earlier key columns; 0 when h0 is null). With `pid` set: partition ids
// in [0, K), K for rows whose valid[i] is 0 (1 <= K < 2^31). Otherwise
// `hash` takes the row hashes (`valid` and K unused). Returns a
// cudaError_t (0 = ok; cudaErrorInvalidValue for an argument out of range:
// the column count, K, an empty string table, a missing output).
int partition_hash(const KeyCol* cols, int ncols, const long long* h0,
                   const unsigned char* valid, long long n, long long K, int* pid,
                   long long* hash, void* stream) {
  Keys keys;
  if (!take_keys(cols, ncols, n, &keys)) return (int)cudaErrorInvalidValue;
  if (pid != nullptr && (K < 1 || K > 0x7fffffffLL || valid == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  if (pid == nullptr && hash == nullptr) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const Mod mod = make_mod(pid != nullptr ? static_cast<unsigned long long>(K) : 1ull);
  const bool vec = wide_ok(cols, ncols, h0, valid, pid != nullptr ? (void*)pid : (void*)hash);
  partition_hash_kernel<<<steps_blocks(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      keys, h0, valid, n, mod, pid, hash, vec);
  return (int)cudaGetLastError();
}

// Launches the grouped mode on `stream`: pid[n] as in the ids mode, order[n]
// (row indices, stable by pid, invalid rows last) and offsets[K + 2]
// (1 <= K <= 1024, 1 <= n < 2^31). `scratch` holds `scratch_len` ints, at
// least (K + 1) * (ntiles + 1) with ntiles = ceil(n / tile rows). Returns a
// cudaError_t as partition_hash does.
int partition_groups(const KeyCol* cols, int ncols, const long long* h0,
                     const unsigned char* valid, long long n, long long K, int* pid,
                     int* order, long long* offsets, int* scratch, long long scratch_len,
                     void* stream) {
  Keys keys;
  if (!take_keys(cols, ncols, n, &keys)) return (int)cudaErrorInvalidValue;
  if (K < 1 || K > kMaxGroups || n < 1 || n > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (valid == nullptr || pid == nullptr || order == nullptr || offsets == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  const int ntiles = static_cast<int>((n + kTile - 1) / kTile);
  const int buckets = static_cast<int>(K) + 1;
  if (scratch == nullptr || scratch_len < static_cast<long long>(buckets) * (ntiles + 1)) {
    return (int)cudaErrorInvalidValue;
  }
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  // the place kernel's shared memory goes above the default 48 KB from
  // K = 372 on: raise its limit once a device, to what K = 1024 needs
  static bool raised[64] = {};
  if (device < 64 && !raised[device]) {
    err = cudaFuncSetAttribute(partition_place_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(place_smem_bytes(kMaxGroups)));
    if (err != cudaSuccess) return (int)err;
    raised[device] = true;
  }
  const Mod mod = make_mod(static_cast<unsigned long long>(K));
  const bool vec = wide_ok(cols, ncols, h0, valid, pid);
  int* counts = scratch;
  int* totals = scratch + static_cast<long long>(buckets) * ntiles;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  partition_count_kernel<<<ntiles, kThreads, sizeof(int) * buckets, s>>>(
      keys, h0, valid, n, mod, pid, counts, ntiles, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  partition_scan_kernel<<<buckets, kThreads, 0, s>>>(counts, totals, ntiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  partition_place_kernel<<<ntiles, kThreads, place_smem_bytes(static_cast<int>(K)), s>>>(
      pid, counts, totals, n, static_cast<int>(K), order, offsets, ntiles);
  return (int)cudaGetLastError();
}

const char* partition_hash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
