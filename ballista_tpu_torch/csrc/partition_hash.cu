// Row hash and hash-partition ids on Hopper.
//
// For each row i, h = 0 and, for each key column c in order,
//     h = splitmix64(h ^ splitmix64(lane(c, i)))
// in uint64 arithmetic. The partition-id mode writes pid[i] = h % K
// (unsigned) for a valid row and K for an invalid one (the drop bucket);
// the hash-only mode writes h itself, as int64 bits.
//
// Replaces the XLA program of the reference's hash routing:
// ballista_tpu/ops/partition.py (partition_ids_for, partition_ids) over
// ballista_tpu/ops/hashing.py (_splitmix64, _to_u64, hash_columns), which
// the shuffle writer and the grace-hash spill run on every routed row, and
// which the hash-packed join keys run. torch has no uint64 add, shift or
// remainder; the plain version (ops/partition.py, partition_ids_plain)
// emulates them with a chain of about 15 int64 programs a column.
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
// Bound on an H100: memory. One pass reads each key column once (1 to 8
// bytes a row), 1 byte a row of the valid mask and of each null mask, and
// 8 bytes a row for each string-table gather, and writes 4 bytes a row (8
// in the hash-only mode); about 20 integer operations a row and column
// are far below the card's integer rate. At 2^21 rows of one int64 key
// that is 27 MB, about 8 us at 3.35 TB/s.
//
// Design: one thread a row, grid-stride over the rows, coalesced loads and
// stores; up to kMaxCols key columns passed by value as descriptors (data,
// dtype, null mask, string table), so a launch needs no device-side
// argument buffer (more key columns chain launches through h0). No shared
// memory and no atomics: each output is written by one thread, so two
// launches are bit-identical.

#include <cuda_runtime.h>

// A key column as the wrapper passes it (ops/partition.py, _KeyCol). Outside
// the unnamed namespace: the exported C function takes it.
struct KeyCol {
  const void* data;
  const unsigned char* nulls;           // 1 = null, or nullptr
  const unsigned long long* table;      // per-code value hashes, or nullptr
  long long table_len;
  int dtype;
};

namespace {

constexpr int kMaxCols = 8;

// dtype codes (ops/partition.py, _DTYPE_CODES); 2 is int64
constexpr int kBool = 0;
constexpr int kInt32 = 1;
constexpr int kF32 = 3;
constexpr int kF64 = 4;

struct Keys {
  KeyCol col[kMaxCols];
  int ncols;
};

__device__ __forceinline__ unsigned long long splitmix64(unsigned long long x) {
  x += 0x9E3779B97F4A7C15ull;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
  return x ^ (x >> 31);
}

__device__ __forceinline__ unsigned long long float_lane(float f) {
  if (f != f) return 0x7FC00000ull;  // every NaN alike
  if (f == 0.0f) return 0ull;        // -0.0 as +0.0
  return static_cast<unsigned long long>(__float_as_uint(f));
}

__device__ __forceinline__ unsigned long long lane(const KeyCol& c, long long i) {
  unsigned long long v;
  if (c.dtype == kF32) {
    v = float_lane(static_cast<const float*>(c.data)[i]);
  } else if (c.dtype == kF64) {
    v = float_lane(__double2float_rn(static_cast<const double*>(c.data)[i]));
  } else {
    long long x;
    if (c.dtype == kBool) {
      x = static_cast<const unsigned char*>(c.data)[i] ? 1 : 0;
    } else if (c.dtype == kInt32) {
      x = static_cast<const int*>(c.data)[i];
    } else {  // int64
      x = static_cast<const long long*>(c.data)[i];
    }
    if (c.table != nullptr) {
      long long k = x < 0 ? 0 : (x >= c.table_len ? c.table_len - 1 : x);
      v = c.table[k];
    } else {
      v = static_cast<unsigned long long>(x);
    }
  }
  if (c.nulls != nullptr && c.nulls[i]) v = 0;
  return v;
}

__global__ void partition_hash_kernel(Keys keys, const long long* h0,
                                      const unsigned char* valid, long long n,
                                      unsigned long long K, int* pid,
                                      long long* hash) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    unsigned long long h = h0 != nullptr ? static_cast<unsigned long long>(h0[i]) : 0ull;
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) {
      if (c < keys.ncols) h = splitmix64(h ^ splitmix64(lane(keys.col[c], i)));
    }
    if (pid != nullptr) {
      pid[i] = valid[i] ? static_cast<int>(h % K) : static_cast<int>(K);
    } else {
      hash[i] = static_cast<long long>(h);
    }
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` over n rows of `ncols` key columns
// (1..8), starting each row's hash from h0[i] (a launch over earlier key
// columns; 0 when h0 is null). With `pid` set: partition ids in [0, K), K
// for rows whose valid[i] is 0 (1 <= K < 2^31). Otherwise `hash` takes the
// row hashes (`valid` and K unused). Returns a cudaError_t (0 = ok).
int partition_hash(const KeyCol* cols, int ncols, const long long* h0,
                   const unsigned char* valid, long long n, long long K,
                   int* pid, long long* hash, int blocks, int threads,
                   void* stream) {
  if (ncols < 1 || ncols > kMaxCols) return (int)cudaErrorInvalidValue;
  if (pid != nullptr && (K < 1 || K > 0x7fffffffLL || valid == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  if (pid == nullptr && hash == nullptr) return (int)cudaErrorInvalidValue;
  Keys keys = {};
  for (int c = 0; c < ncols; ++c) keys.col[c] = cols[c];
  keys.ncols = ncols;
  partition_hash_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      keys, h0, valid, n, static_cast<unsigned long long>(K), pid, hash);
  return (int)cudaGetLastError();
}

const char* partition_hash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
