// Blockwise polynomial chunk checksums for Hopper (sm_90a), exact uint32,
// of a list of buffers in one launch.  For each buffer:
//
//   digest_k = sum_i d[k*L + i] * P^(L-1-i)       mod 2^32,  P = 0x01000193
//   total    = sum_k digest_k * P^(n_blocks-1-k)  mod 2^32
//
// over the buffer zero-padded to a multiple of the block length L, read as
// uint32: uint8 zero-extended, int32 as its two's-complement bits.
//
// Replaces: the Pallas TPU kernel `_checksum_kernel` / `block_digests` in
// src/repro/kernels/chunk_checksum.py, and the fold of `combine_digests`
// that follows it there.
//
// What bounds it on this card: one multiply-add per element against one
// read of the element, so the bound is bytes: a 1.56 GB model is 0.47 ms
// at 3.35 TB/s (H100 SXM data sheet, 700 W).  A model is hundreds of
// buffers, most of them small, so one launch per buffer leaves the time
// to the host.
//
// What the design does about it:
//   * one launch for the whole list: the host passes a device table of
//     (pointer, elements, first digest, first unit, dtype) per buffer.
//     Work is cut into units of 4 KB (U = 4096 / (L * element size)
//     consecutive blocks of one buffer, counted from its end, so only a
//     unit at a buffer's start is short).  Warps walk the units of all
//     buffers, unit u, u + G, ... (G warps in the grid), so the warps in
//     flight read neighbouring units; a warp finds a new buffer by binary
//     search over the table, which stays in L1;
//   * the fold needs no pass of its own: block k of a buffer of n blocks
//     has weight P^(n-1-k), and unit j of the buffer covers blocks
//     n-1-U j-r, r < U, with weights P^(U j) P^r.  A warp computes P^(U j)
//     with pow_mod when it enters a buffer and multiplies it by P^(U G) at
//     each step inside it; it adds its partial sum to the buffer's total
//     with one atomicAdd per buffer it touched.  Addition mod 2^32 is
//     associative and commutative, so every total is exact and the same in
//     every run, whatever the order of the atomics;
//   * bandwidth: a unit's loads are all issued before any is summed, so
//     each lane has 128 bytes (8 loads of 16 bytes for L 1024) in flight;
//     its 32 lanes read consecutive 16-byte pieces, so every load
//     instruction covers 512 contiguous bytes.  A lane sums each vector by
//     Horner's rule and weights it once, so it keeps L/128 weights in
//     registers, not L/32 (68 registers: three blocks of 8 warps an SM);
//     the warp sums its lanes with shuffles;
//   * the buffer is read in its own dtype, never widened to a uint32 copy;
//     a buffer's short first unit and its ragged last block take the same
//     vector loads, one block at a time, elements at or beyond the end
//     zeroed in registers; a buffer of 0 elements has no unit and total 0.
//
// Plain C interface, loaded with ctypes; it returns the cudaError_t of
// the launch and never synchronises.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned FNV_PRIME = 0x01000193u;
constexpr int WARPS = 8;           // warps per block
constexpr int UNIT_BYTES = 4096;   // bytes of one warp's step
constexpr int COLS = 5;            // table columns, below
enum Col { PTR = 0, ELEMS = 1, FIRST_BLOCK = 2, FIRST_UNIT = 3, DTYPE = 4 };

__device__ __forceinline__ unsigned pow_mod(unsigned base,
                                            unsigned long long e) {
  unsigned r = 1u;
  while (e) {
    if (e & 1ull) r *= base;
    base *= base;
    e >>= 1;
  }
  return r;
}

template <int BYTES>
struct Vec;
template <>
struct Vec<16> {
  using type = uint4;
};
template <>
struct Vec<8> {
  using type = uint2;
};

__device__ __forceinline__ unsigned as_u32(uint8_t v) { return v; }
__device__ __forceinline__ unsigned as_u32(int32_t v) {
  return static_cast<unsigned>(v);
}

// The shape of one lane's share of a block of L elements of T.
template <typename T, int L>
struct Shape {
  static constexpr int EPL = L / 32;  // elements per lane
  static constexpr int VEC =
      EPL < int(16 / sizeof(T)) ? EPL : int(16 / sizeof(T));
  static constexpr int LOADS = EPL / VEC;
  static constexpr int U = UNIT_BYTES / (L * int(sizeof(T)));  // blocks/unit
  using V = typename Vec<VEC * sizeof(T)>::type;
};

// Lane `lane` holds positions m * 32 * VEC + lane * VEC + e of a block:
// the VEC elements of its m-th vector are summed by Horner's rule with
// weights P^(VEC-1-e), then weighted by w[m] = P^(L-VEC-(m * 32 * VEC +
// lane * VEC)).  W = L / 128 is the most vectors a lane loads (int32).
template <int L>
constexpr int W = L / 128;

template <typename T, int L>
__device__ __forceinline__ void lane_weights(unsigned (&w)[W<L>], int lane) {
  using S = Shape<T, L>;
#pragma unroll
  for (int m = 0; m < S::LOADS; ++m)
    w[m] = pow_mod(FNV_PRIME, L - S::VEC - (m * 32 * S::VEC + lane * S::VEC));
}

__device__ __forceinline__ unsigned warp_sum(unsigned s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;
}

// The digest of block k (its elements from base = k * L) in lane sums:
// whole vectors loaded, elements at or beyond n zeroed in registers when
// MASK.  A vector that starts before n is loaded whole: aligned to its
// own size, it lies in one page with an element of the buffer.
template <typename T, int L, bool MASK>
__device__ __forceinline__ unsigned block_sum(const typename Shape<T, L>::V
                                                  (&raw)[Shape<T, L>::LOADS],
                                              long long base, long long n,
                                              const unsigned (&w)[W<L>],
                                              int lane) {
  using S = Shape<T, L>;
  unsigned s = 0u;
#pragma unroll
  for (int m = 0; m < S::LOADS; ++m) {
    const T* vals = reinterpret_cast<const T*>(&raw[m]);
    const long long start = base + m * 32 * S::VEC + lane * S::VEC;
    unsigned h = 0u;
#pragma unroll
    for (int e = 0; e < S::VEC; ++e)
      h = h * FNV_PRIME + (MASK && start + e >= n ? 0u : as_u32(vals[e]));
    s += h * w[m];
  }
  return warp_sum(s);
}

// Unit j of a buffer of n elements (n_blocks blocks): blocks
// n_blocks-1-U j-r for r < U that exist.  Writes their digests and returns
// sum_r digest * fold_w * P^r, fold_w = P^(U j).  A whole unit issues
// every load before it sums any; a buffer's first unit (short) or the one
// with its ragged last block goes block by block, masked.
template <typename T, int L>
__device__ __forceinline__ unsigned unit_sum(const T* __restrict__ data,
                                             long long n, long long n_blocks,
                                             long long j,
                                             const unsigned (&w)[W<L>],
                                             unsigned fold_w,
                                             unsigned* __restrict__ digests,
                                             int lane) {
  using S = Shape<T, L>;
  using V = typename S::V;
  const long long top = n_blocks - 1 - S::U * j;  // the unit's last block
  unsigned partial = 0u;
  if (top - (S::U - 1) >= 0 && (top + 1) * L <= n) {
    V raw[S::U][S::LOADS];
#pragma unroll
    for (int r = 0; r < S::U; ++r)
#pragma unroll
      for (int m = 0; m < S::LOADS; ++m)
        raw[r][m] = *reinterpret_cast<const V*>(
            data + (top - r) * L + m * 32 * S::VEC + lane * S::VEC);
#pragma unroll
    for (int r = 0; r < S::U; ++r) {
      const unsigned s =
          block_sum<T, L, false>(raw[r], (top - r) * L, n, w, lane);
      if (lane == 0) digests[top - r] = s;
      partial += s * fold_w;
      fold_w *= FNV_PRIME;
    }
  } else {
    for (int r = 0; r < S::U && top - r >= 0; ++r) {
      const long long base = (top - r) * L;
      V raw[S::LOADS];
#pragma unroll
      for (int m = 0; m < S::LOADS; ++m) {
        const long long start = base + m * 32 * S::VEC + lane * S::VEC;
        raw[m] = start < n ? *reinterpret_cast<const V*>(data + start) : V{};
      }
      const unsigned s = block_sum<T, L, true>(raw, base, n, w, lane);
      if (lane == 0) digests[top - r] = s;
      partial += s * fold_w;
      fold_w *= FNV_PRIME;
    }
  }
  return partial;
}

// table: n_buffers rows of COLS int64.  digests: every buffer's block
// digests, buffer b's from table[b][FIRST_BLOCK]; totals: (n_buffers,),
// zero before the launch.  dtype: 0 = uint8, 1 = int32.
template <int L>
__global__ void __launch_bounds__(WARPS * 32)
    checksum_kernel(const long long* __restrict__ table, int n_buffers,
                    long long total_units, unsigned* __restrict__ digests,
                    unsigned* __restrict__ totals) {
  const int lane = threadIdx.x & 31;
  const long long warp = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
  const long long n_warps = (long long)gridDim.x * WARPS;
  // P^(U G): the step of the fold weight within a buffer, per dtype
  const unsigned step8 = pow_mod(FNV_PRIME, Shape<uint8_t, L>::U * n_warps);
  const unsigned step32 = pow_mod(FNV_PRIME, Shape<int32_t, L>::U * n_warps);

  unsigned w[W<L>];
  int dtype = -1;  // the dtype w was formed for
  int b = -1;
  long long unit_end = 0, first_unit = 0, n = 0, n_blocks = 0;
  const void* data = nullptr;
  unsigned* dig = nullptr;
  unsigned fold_w = 0u, partial = 0u;
  for (long long u = warp; u < total_units; u += n_warps) {
    if (u < unit_end) {
      fold_w *= dtype == 0 ? step8 : step32;
    } else {  // entering a buffer: the last one whose first unit is <= u
      if (b >= 0 && lane == 0) atomicAdd(totals + b, partial);
      partial = 0u;
      int lo = b + 1, hi = n_buffers - 1;
      while (lo < hi) {
        const int mid = (lo + hi + 1) / 2;
        if (table[mid * COLS + FIRST_UNIT] <= u) lo = mid;
        else hi = mid - 1;
      }
      b = lo;
      const long long* row = table + b * COLS;
      data = reinterpret_cast<const void*>(row[PTR]);
      n = row[ELEMS];
      first_unit = row[FIRST_UNIT];
      dig = digests + row[FIRST_BLOCK];
      unit_end = b + 1 < n_buffers ? table[(b + 1) * COLS + FIRST_UNIT]
                                   : total_units;
      n_blocks = (n + L - 1) / L;
      const int dt = int(row[DTYPE]);
      if (dt != dtype) {
        if (dt == 0) lane_weights<uint8_t, L>(w, lane);
        else lane_weights<int32_t, L>(w, lane);
        dtype = dt;
      }
      const int U = dtype == 0 ? Shape<uint8_t, L>::U : Shape<int32_t, L>::U;
      fold_w = pow_mod(FNV_PRIME, (unsigned long long)(U * (u - first_unit)));
    }
    const long long j = u - first_unit;
    partial += dtype == 0
        ? unit_sum<uint8_t, L>(static_cast<const uint8_t*>(data), n,
                               n_blocks, j, w, fold_w, dig, lane)
        : unit_sum<int32_t, L>(static_cast<const int32_t*>(data), n,
                               n_blocks, j, w, fold_w, dig, lane);
  }
  if (b >= 0 && lane == 0) atomicAdd(totals + b, partial);
}

template <int L>
cudaError_t launch(const long long* table, int n_buffers,
                   long long total_units, unsigned* digests,
                   unsigned* totals, cudaStream_t stream) {
  static int max_grid = 0;  // resident blocks on the whole card
  if (!max_grid) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, checksum_kernel<L>, WARPS * 32, 0);
    if (err != cudaSuccess) return err;
    max_grid = sms * (per_sm > 0 ? per_sm : 1);
  }
  const long long want = (total_units + WARPS - 1) / WARPS;
  const int grid = int(want < max_grid ? want : max_grid);
  checksum_kernel<L><<<grid, WARPS * 32, 0, stream>>>(
      table, n_buffers, total_units, digests, totals);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// table: device int64 (n_buffers, 5): pointer, elements, first digest,
// first unit, dtype of each buffer, in order of first unit.  digests,
// totals: device uint32.  Returns a cudaError_t (0 = success).
int chunk_checksum_many(const void* table, int n_buffers,
                        long long total_units, int block, void* digests,
                        void* totals, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      cudaMemsetAsync(totals, 0, sizeof(unsigned) * n_buffers, st);
  if (err != cudaSuccess || total_units == 0) return err;
  const long long* t = static_cast<const long long*>(table);
  unsigned* d = static_cast<unsigned*>(digests);
  unsigned* s = static_cast<unsigned*>(totals);
  switch (block) {
    case 256: return launch<256>(t, n_buffers, total_units, d, s, st);
    case 1024: return launch<1024>(t, n_buffers, total_units, d, s, st);
    default: return cudaErrorInvalidValue;
  }
}

const char* chunk_checksum_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
