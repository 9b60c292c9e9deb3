// Blockwise polynomial chunk checksum for Hopper (sm_90a), exact uint32:
//
//   digest_k = sum_i d[k*L + i] * P^(L-1-i)       mod 2^32,  P = 0x01000193
//   total    = sum_k digest_k * P^(n_blocks-1-k)  mod 2^32
//
// over a buffer zero-padded to a multiple of the block length L, read as
// uint32: uint8 zero-extended, int32 as its two's-complement bits.
//
// Replaces: the Pallas TPU kernel `_checksum_kernel` / `block_digests` in
// src/repro/kernels/chunk_checksum.py, and the fold of `combine_digests`
// that follows it there.
//
// What bounds it on this card: one multiply-add per element against one
// read of the element, so the bound is bytes: a 1.56 GB model is 0.47 ms
// at 3.35 TB/s (H100 SXM data sheet, 700 W).
//
// What the design does about it:
//   * the buffer is read in its own dtype, never widened to a uint32
//     copy in device memory (four times the bytes for uint8);
//   * one warp per block of L elements: its 32 lanes read 16 bytes each
//     from consecutive addresses, so every load instruction covers 512
//     contiguous bytes; each lane keeps the L/32 weights P^(L-1-i) of its
//     positions in registers, computed once by squaring, and the warp
//     sums its lanes with shuffles;
//   * the fold across blocks needs no pass of its own: a warp visits
//     blocks k = n-1-w, n-1-w-G, ... (G warps in the grid), so the weight
//     P^(n-1-k) starts at P^w and is multiplied by P^G at each step, and
//     each warp adds its partial sum to the total with one atomicAdd.
//     Addition mod 2^32 is associative and commutative, so the total is
//     the same in every run, whatever the order of the atomics;
//   * nothing of size n_blocks is built on the host; the ragged last
//     block is read with bounds checks and padded with zeros in
//     registers.
//
// Plain C interface, loaded with ctypes; it returns the cudaError_t of
// the launch and never synchronises.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned FNV_PRIME = 0x01000193u;
constexpr int WARPS = 8;          // warps per block
constexpr int MAX_GRID = 1056;    // 8 resident blocks on each of 132 SMs

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

// data: n elements of T, 16-byte aligned.  digests: (n_blocks,) uint32;
// total: one uint32, zero before the launch.
template <typename T, int L>
__global__ void __launch_bounds__(WARPS * 32)
    checksum_kernel(const T* __restrict__ data, long long n,
                    long long n_blocks, unsigned* __restrict__ digests,
                    unsigned* __restrict__ total) {
  constexpr int EPL = L / 32;  // elements per lane
  constexpr int VEC = (EPL < int(16 / sizeof(T))) ? EPL : int(16 / sizeof(T));
  constexpr int LOADS = EPL / VEC;
  using V = typename Vec<VEC * sizeof(T)>::type;
  const int lane = threadIdx.x & 31;
  // Lane `lane` holds positions m * 32 * VEC + lane * VEC + e of a block.
  unsigned w[EPL];
#pragma unroll
  for (int m = 0; m < LOADS; ++m)
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      w[m * VEC + e] = pow_mod(FNV_PRIME, L - 1 - (m * 32 * VEC + lane * VEC + e));

  const long long warp = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
  const long long n_warps = (long long)gridDim.x * WARPS;
  const unsigned step = pow_mod(FNV_PRIME, n_warps);
  unsigned fold_w = pow_mod(FNV_PRIME, warp);  // P^(n_blocks-1-k)
  unsigned partial = 0u;
  for (long long k = n_blocks - 1 - warp; k >= 0; k -= n_warps) {
    const long long base = k * L;
    unsigned s = 0u;
    if (base + L <= n) {
#pragma unroll
      for (int m = 0; m < LOADS; ++m) {
        const V raw = *reinterpret_cast<const V*>(data + base + m * 32 * VEC +
                                                  lane * VEC);
        const T* vals = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int e = 0; e < VEC; ++e) s += as_u32(vals[e]) * w[m * VEC + e];
      }
    } else {  // the ragged last block: zeros beyond n
#pragma unroll
      for (int m = 0; m < LOADS; ++m)
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const long long i = base + m * 32 * VEC + lane * VEC + e;
          if (i < n) s += as_u32(data[i]) * w[m * VEC + e];
        }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) digests[k] = s;
    partial += s * fold_w;
    fold_w *= step;
  }
  if (lane == 0 && warp < n_blocks) atomicAdd(total, partial);
}

template <typename T, int L>
cudaError_t launch(const void* data, long long n, long long n_blocks,
                   unsigned* digests, unsigned* total, cudaStream_t stream) {
  const long long want = (n_blocks + WARPS - 1) / WARPS;
  const int grid = int(want < MAX_GRID ? want : MAX_GRID);
  checksum_kernel<T, L><<<grid, WARPS * 32, 0, stream>>>(
      static_cast<const T*>(data), n, n_blocks, digests, total);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_block(int block, const void* data, long long n,
                           long long n_blocks, unsigned* digests,
                           unsigned* total, cudaStream_t stream) {
  switch (block) {
    case 256:
      return launch<T, 256>(data, n, n_blocks, digests, total, stream);
    case 1024:
      return launch<T, 1024>(data, n, n_blocks, digests, total, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = uint8, 1 = int32.  out: n_blocks + 1 uint32, the digests and
// then the total.  Returns a cudaError_t (0 = success).
int chunk_checksum_digests(int dtype, const void* data, long long n,
                           int block, void* out, long long n_blocks,
                           void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned* digests = static_cast<unsigned*>(out);
  unsigned* total = digests + n_blocks;
  cudaError_t err = cudaMemsetAsync(total, 0, sizeof(unsigned), st);
  if (err != cudaSuccess || n_blocks == 0) return err;
  if (dtype == 0)
    return dispatch_block<uint8_t>(block, data, n, n_blocks, digests, total,
                                   st);
  if (dtype == 1)
    return dispatch_block<int32_t>(block, data, n, n_blocks, digests, total,
                                   st);
  return cudaErrorInvalidValue;
}

const char* chunk_checksum_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
