// Flash attention forward for Hopper (sm_90a): causal / sliding-window GQA
// with an optional tanh logit softcap, one pass over K/V with an online
// softmax.
//
// Replaces: the Pallas TPU kernel `_flash_kernel` / `flash_attention` in
// src/repro/kernels/flash_attention.py.  It computes the same function:
// scale 1/sqrt(hd), softcap before the mask, causal and window masks,
// KV head h // (H / KV), fp32 running max / denominator / accumulator,
// output in q's dtype.
//
// What bounds it on this card: at gemma2-2b's prefill shapes (hd 256,
// S in the thousands) attention does ~2*S*hd operations per byte of q/k/v,
// far above the H100's ~295 operations per byte, so the bound is
// arithmetic.  This first version does its products on the CUDA cores in
// fp32 (no tensor cores), so it runs well below the bf16 tensor-core peak;
// wgmma, TMA and warp specialisation are later work.
//
// What the design does about it:
//   * one thread block per (64-row query tile, q-head, batch); the TPU
//     grid's sequential KV axis becomes a loop inside the block, which
//     carries the softmax state in registers;
//   * KV tiles that lie wholly outside the causal / window band are never
//     visited, so a windowed layer costs O(S * window), not O(S^2);
//   * K and V are read from KV head h // group in place, never repeated;
//   * the ragged edge (S not a multiple of the tile) is bounds-checked
//     on load and masked, with no padding in device memory;
//   * tiles live in shared memory as fp32 with an odd row stride, so the
//     Q·K^T inner loop reads K rows without bank conflicts; 256 threads
//     each own a 4x4 block of scores and a 4 x (hd/16) block of the output
//     accumulator, so every shared-memory read feeds several FMAs;
//   * shared memory is sized by head_dim (148 KB at hd 256, above the
//     48 KB default, so the launch raises the dynamic limit);
//   * heavy (late) query tiles are scheduled first to even out the tail
//     of a causal launch.
//
// Plain C interface, loaded with ctypes; it returns the cudaError_t of
// the launch and never synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int BQ = 64;       // query rows per block
constexpr int BK = 64;       // key/value rows per tile
constexpr int NT = 256;      // threads per block: 16 x 16
constexpr float NEG_INF = -1e30f;

template <typename T>
struct VecWidth {
  static constexpr int N = 16 / sizeof(T);  // elements in one 16-byte load
};

template <typename T>
__device__ __forceinline__ float to_float(T x);
template <>
__device__ __forceinline__ float to_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t(BQ) * (HD + 1) + size_t(BK) * (HD + 1) +
                          size_t(BQ) * (BK + 1));
}

// Copy rows [row0, row0 + ROWS) of one head (row stride `row_stride`
// elements) into shared memory as fp32 with row stride `ds`; rows at or
// beyond S are zero.
template <typename T, int HD, int ROWS>
__device__ __forceinline__ void load_tile(float* dst, int ds, const T* base,
                                          size_t row_stride, int row0,
                                          int S) {
  constexpr int V = VecWidth<T>::N;
  constexpr int PER_ROW = HD / V;
  for (int i = threadIdx.x; i < ROWS * PER_ROW; i += NT) {
    const int r = i / PER_ROW;
    const int d = (i % PER_ROW) * V;
    const int gr = row0 + r;
    float* out = dst + r * ds + d;
    if (gr < S) {
      const uint4 raw =
          *reinterpret_cast<const uint4*>(base + size_t(gr) * row_stride + d);
      const T* vals = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int e = 0; e < V; ++e) out[e] = to_float<T>(vals[e]);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) out[e] = 0.f;
    }
  }
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// q, o: (B, S, H, HD); k, v: (B, S, KV, HD); all contiguous.
// grid: (ceil(S / BQ), H, B); block: NT threads; smem_bytes<HD>() dynamic.
template <typename T, int HD>
__global__ void __launch_bounds__(NT)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o, int S,
                           int H, int KV, float scale, int causal, int window,
                           float softcap) {
  constexpr int RS = HD + 1;  // odd row stride: conflict-free K row reads
  constexpr int PS = BK + 1;
  constexpr int NJ = HD / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;              // BQ x RS
  float* sKV = sQ + BQ * RS;     // BK x RS: the K tile, then the V tile
  float* sP = sKV + BK * RS;     // BQ x PS: probabilities of this tile

  const int tx = threadIdx.x & 15;  // column group
  const int ty = threadIdx.x >> 4;  // row group: rows ty + 16 i
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const size_t q_stride = size_t(H) * HD;
  const size_t kv_stride = size_t(KV) * HD;
  const T* qb = q + (size_t(b) * S * H + h) * HD;
  const T* kb = k + (size_t(b) * S * KV + kvh) * HD;
  const T* vb = v + (size_t(b) * S * KV + kvh) * HD;
  T* ob = o + (size_t(b) * S * H + h) * HD;

  load_tile<T, HD, BQ>(sQ, RS, qb, q_stride, q0, S);

  // KV band of this query tile: tiles wholly outside it are skipped.
  const int q_last = min(q0 + BQ, S) - 1;
  const int kv_lo = window ? max(0, q0 - window + 1) : 0;
  const int kv_hi = causal ? q_last + 1 : S;  // exclusive
  const int t_lo = kv_lo / BK;
  const int t_hi = (kv_hi + BK - 1) / BK;

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  for (int t = t_lo; t < t_hi; ++t) {
    const int c0 = t * BK;
    __syncthreads();  // the previous tile's P·V is done with sKV and sP
    load_tile<T, HD, BK>(sKV, RS, kb, kv_stride, c0, S);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sQ[(ty + 16 * i) * RS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] = sKV[(tx + 16 * j) * RS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], c[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty + 16 * i;
      bool valid[4];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = c0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);  // before mask
        valid[j] = c < S && (!causal || c <= r) && (!window || c > r - window);
        s[i][j] = valid[j] ? x : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      // A row with no valid column so far keeps m = NEG_INF: corr is 1 and
      // every p is 0, so it stays empty instead of averaging masked V.
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = valid[j] ? expf(s[i][j] - m_new) : 0.f;
        sP[(ty + 16 * i) * PS + tx + 16 * j] = p;
        rs += p;
      }
      l[i] = l[i] * corr + half_warp_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= corr;
    }

    __syncthreads();  // all reads of the K tile are done; sP is complete
    load_tile<T, HD, BK>(sKV, RS, vb, kv_stride, c0, S);
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = sP[(ty + 16 * i) * PS + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float vv = sKV[c * RS + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= S) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);  // empty rows write 0
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      ob[size_t(r) * q_stride + tx + 16 * j] = from_float<T>(acc[i][j] * inv);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int S, int H, int KV, float scale, int causal,
                   int window, float softcap, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  auto kernel = flash_attention_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, H, KV, scale, causal,
      window, softcap);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_head_dim(int HD, const void* q, const void* k,
                              const void* v, void* o, int B, int S, int H,
                              int KV, float scale, int causal, int window,
                              float softcap, cudaStream_t stream) {
  // gemma2-2b's head_dim and the smoke config's; add others with a config
  switch (HD) {
    case 16:
      return launch<T, 16>(q, k, v, o, B, S, H, KV, scale, causal, window,
                           softcap, stream);
    case 256:
      return launch<T, 256>(q, k, v, o, B, S, H, KV, scale, causal, window,
                            softcap, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 = success).
int flash_attention_forward(int dtype, const void* q, const void* k,
                            const void* v, void* o, int B, int S, int H,
                            int KV, int HD, float scale, int causal,
                            int window, float softcap, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_head_dim<float>(HD, q, k, v, o, B, S, H, KV, scale,
                                    causal, window, softcap, st);
  if (dtype == 1)
    return dispatch_head_dim<__nv_bfloat16>(HD, q, k, v, o, B, S, H, KV,
                                            scale, causal, window, softcap,
                                            st);
  return cudaErrorInvalidValue;
}

// Dynamic shared memory of one block at this head_dim, or -1.
int flash_attention_smem_bytes(int HD) {
  switch (HD) {
    case 16: return int(smem_bytes<16>());
    case 256: return int(smem_bytes<256>());
    default: return -1;
  }
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
