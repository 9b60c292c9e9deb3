// Flash attention forward for Hopper (sm_90a): causal / sliding-window GQA
// with an optional tanh logit softcap, one pass over K/V with an online
// softmax.  Two designs, chosen explicitly by (dtype, head_dim):
//
//   wgmma  bf16 at head_dim 256 (gemma2-2b), 128 (mixtral-8x22b,
//          qwen2-7b, deepseek-coder-33b, phi3.5-moe), 96 (phi3-mini-3.8b)
//          and 64 (musicgen-medium): every launch of their serving paths.
//          Tensor cores, TMA and warp specialisation; one template over
//          the head dim.
//   simt   float32 at head_dim 16, 128 and 256, bf16 at head_dim 16 (the
//          smoke configs).  fp32 FMAs on the CUDA cores.  In float32 it is
//          level with the library, and TF32 tensor cores would break the
//          1e-4 float32 check.
//
// Any other (dtype, head_dim) is refused.  Neither design falls back to
// the other.
//
// Replaces: the Pallas TPU kernel `_flash_kernel` / `flash_attention` in
// src/repro/kernels/flash_attention.py.  Both designs compute the same
// function: scale 1/sqrt(hd), tanh softcap before the mask, causal and
// window masks (key c valid for row r iff c <= r and c > r - window),
// KV head h // (H / KV) read in place, fp32 running max / denominator /
// accumulator, rows with no valid key written as 0, output in q's dtype.
//
// What bounds the wgmma design on this card: at the served models'
// prefill shapes (hd 256 or 128, S in the thousands) attention does
// ~2*S*hd operations per byte of q/k/v, far above the H100's ~295 bf16
// operations per byte, so the tensor cores bound it: 4*hd operations per
// valid (row, key) pair at 989 TFLOP/s (6*hd here, with P.V run twice;
// see below).  Second comes the special-function unit (MUFU, ~16 results
// per clock per SM): the softmax's exp2 and the softcap's tanh cost 3 MUFU
// operations per pair, about 0.8 of the function's tensor-core time at hd
// 256.  At hd 128 with no softcap the exp2 alone is 1 MUFU operation per
// pair against half the products of hd 256, so it weighs about as much.
// At hd 96 and 64 the products per pair shrink with hd while the
// softmax's work per pair (the exp2, the max, the split of P) does not:
// at hd 64 the exp2 alone takes about 2/3 of the pair's tensor-core time
// (with P.V run twice), and the fp32 softmax about as much again, so
// there the softmax, not the tensor cores, is the expected limit.
//
// What the wgmma design does about it:
//   * one block per (128 query rows, q-head, batch): two consumer
//     warpgroups of 64 rows each (wgmma's M) and one producer warp; the
//     block's key tiles are those of the causal / window band of its
//     rows, and a warpgroup skips the products of a tile outside its own
//     band (the diagonal tile of the lower half, the window's first tile
//     of the upper half);
//   * shared memory: Q (128 x hd bf16) loaded once; a ring of K and V
//     tiles (64 keys x hd); every tile arrives by TMA as column slabs of
//     64 rows in the swizzle that wgmma reads without bank conflicts:
//     slabs of 64 columns with the 128-byte swizzle at hd 256, 128 and
//     64, and of 32 columns with the 64-byte swizzle at hd 96, which is
//     no multiple of 64 (three such slabs hold it exactly: no padded
//     columns, no extra products).  The ring holds 128 KB at every width
//     (see Shape): at hd 256 Q 64 KB and 2 stages of 32 KB tiles, 192 KB
//     in all; at 128, 4 stages, 160 KB; at 96, 5 stages of 12 KB tiles,
//     145 KB; at 64, 8 stages of 8 KB tiles, 145 KB.  K and V of a stage
//     have their own "full" barrier, so Q.K^T starts before V has landed;
//     an "empty" barrier per stage hands it back;
//   * S = Q.K^T: hd/16 wgmma m64n64k16 (16 at 256, 8 at 128, 6 at 96, 4
//     at 64), both operands K-major in shared memory, each k-step inside
//     one slab's swizzle atom.  Products of bf16 values are exact in
//     fp32, so the scores differ from the plain version only in the order
//     of sums;
//   * softmax on the accumulator fragment in registers: scale, softcap
//     and log2(e) folded into two constants; tanh(x) = 1 - 2/(2^(2x
//     log2 e) + 1) with ex2.approx and rcp.approx (2 MUFU operations; the
//     libm tanhf is a long sequence, and tanh.approx's 2^-11 relative
//     error moves a score of 15 by ~0.007, too much for a one-ulp
//     check); the mask is applied only on tiles that cross the diagonal,
//     the window edge or S; row max and sum are reduced over the 4
//     threads that share a row;
//   * O += P.V: P goes to bf16 in registers as the register A operand of
//     wgmma m64n{hd}k16 (the m64nN fp32 accumulator layout packs straight
//     into A's fragment); V (keys x hd, hd contiguous) is B, MN-major,
//     its slabs one swizzle atom apart along N.
//     P rounded once to bf16 misses the one-ulp check by 2.5x at hd 256
//     and 2.7-3.5x at hd 128: a weight of 0.3 off by 2^-9 of itself,
//     times |v| ~ 1, is ~6e-4 on an output near 0, and a few such keys
//     add up past the 1e-3 floor.  So P is split as hi + lo, both bf16
//     (hi = P rounded, lo = the rest rounded), and P.V runs twice: exact
//     to ~2^-17, at 1.5x the tensor-core work of the function;
//   * registers: the 64 x hd fp32 accumulator is hd/2 registers a thread
//     (128 at hd 256, 64 at 128, 48 at 96, 32 at 64); setmaxnreg gives the
//     consumers 240 and the producer 24 at every width;
//   * epilogue: multiply by 1/l, convert to bf16 and store; rows >= S are
//     not written.  Rows past S in Q, K, V arrive from TMA as zeros;
//   * the heaviest (latest) query tiles of all heads are scheduled
//     first.  Heavy-first within each head alone left the heaviest blocks
//     of the last heads to start late, and the tail to them.
//
// Tried at engine B's windowed shape and dropped, before the launch
// order above, against 0.50 ms for this design then: issuing tile t's
// Q.K^T with tile t-1's P.V and running the softmax under that P.V
// (0.62-0.68 ms); 80-key tiles (0.51 ms); ping-pong of the two
// warpgroups through named barriers (0.55 ms).
//
// The simt design: one block per (64-row query tile, q-head, batch), 256
// threads each owning a 4x4 block of scores and a 4 x (hd/16) block of the
// accumulator; tiles in shared memory as fp32 with an odd row stride;
// KV tiles outside the band skipped; the ragged edge bounds-checked.
//
// Plain C interface, loaded with ctypes; it returns the cudaError_t of
// the launch and never synchronises.  The TMA descriptors are encoded on
// the host with cuTensorMapEncodeTiled, fetched from the driver at run
// time (the library links no libcuda).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

namespace {

constexpr float NEG_INF = -1e30f;

// ---------------------------------------------------------------------------
// simt design
// ---------------------------------------------------------------------------
namespace simt {

constexpr int BQ = 64;       // query rows per block
constexpr int BK = 64;       // key/value rows per tile
constexpr int NT = 256;      // threads per block: 16 x 16

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
                           const T* __restrict__ v, T* __restrict__ o,
                           float* __restrict__ lse, int S, int H, int KV,
                           float scale, int causal, int window,
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
    if (lse != nullptr && tx == 0)
      lse[(size_t(b) * H + h) * S + r] =
          l[i] > 0.f ? m[i] + logf(l[i]) : -INFINITY;
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int S, int H, int KV, float scale,
                   int causal, int window, float softcap,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  auto kernel = flash_attention_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, S, H, KV, scale,
      causal, window, softcap);
  return cudaGetLastError();
}

}  // namespace simt

// ---------------------------------------------------------------------------
// wgmma design (bf16, head_dim 256 and 128)
// ---------------------------------------------------------------------------
namespace wg {

constexpr int BM = 128;                        // query rows per block
constexpr int BN = 64;                         // keys per tile
constexpr int THREADS = 384;                   // 2 consumer warpgroups + 1
constexpr int CONSUMERS = 256;

// What the head dim sets.  A K or V tile of 64 keys is a row of column
// slabs, each 64 rows of one swizzle span: 64 columns (128 B, the 128-byte
// swizzle) where the head dim is a multiple of 64, else 32 columns (64 B,
// the 64-byte swizzle), so that the slabs cover the head dim exactly: 4
// slabs at 256 (32 KB a tile), 2 at 128 (16 KB), 3 of 32 columns at 96
// (12 KB), 1 at 64 (8 KB).  The ring holds 128 KB of K and V at every
// width, 512/HD stages: a tile's products take time in proportion to the
// head dim, and a load's latency does not shrink with it, so a narrower
// tile needs more of them in flight to cover the same latency (2 stages
// at 256, 4 at 128, 5 at 96, 8 at 64; 145-192 KB of shared memory in
// all).  The accumulator is HD/2 registers a thread.
template <int HD>
struct Shape {
  static_assert(HD == 64 || HD == 96 || HD == 128 || HD == 256,
                "the wgmma design serves head dims 64, 96, 128 and 256");
  static constexpr int SPAN = HD % 64 == 0 ? 128 : 64;  // slab row, bytes
  static constexpr int SLAB_COLS = SPAN / 2;            // bf16 columns
  static constexpr int SLAB_BYTES = 64 * SPAN;          // 64 rows
  static constexpr int SLABS = HD / SLAB_COLS;
  static_assert(SLABS * SLAB_COLS == HD,
                "the slabs must cover the head dim exactly");
  static constexpr int KSTEPS = SPAN / 32;      // 16-column k-steps a slab
  static constexpr int TILE_BYTES = SLABS * SLAB_BYTES;  // 64 rows
  static constexpr int Q_BYTES = 2 * TILE_BYTES;         // 128 rows
  static constexpr int STAGES = 512 / HD;                // K/V ring depth
  static constexpr int NBARS = 1 + 3 * STAGES;  // q_full, k/v_full, empty
  static constexpr int ACC = HD / 2;            // accumulator registers
  // 1024 bytes of slack to align the swizzled tiles to 1024 bytes
  static constexpr size_t SMEM_BYTES =
      1024 + Q_BYTES + 2 * STAGES * TILE_BYTES + 8 * NBARS;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// One arrival that also expects `bytes` of TMA data on the barrier.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// One box (64 columns x 1 head x 64 rows x 1 batch) of a 4-D map.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int head,
                                         int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(head),
      "r"(row), "r"(batch)
      : "memory");
}

// Shared-memory matrix descriptor of a swizzled slab: start address,
// leading and stride byte offsets (in 16-byte units) and the swizzle in
// bits 62-63 (1: 128 bytes, 2: 64 bytes), whose atom is SPAN / 2 bf16
// columns wide on the K-major side (Q.K^T) and the MN-major side (P.V).
template <int SPAN>
__device__ __forceinline__ uint64_t slab_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  static_assert(SPAN == 128 || SPAN == 64, "128- or 64-byte swizzle");
  constexpr uint64_t LAYOUT = SPAN == 128 ? 1 : 2;
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(lbo >> 4) << 16) |
         (uint64_t(sbo >> 4) << 32) | (LAYOUT << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving reads or writes of an accumulator across
// the asynchronous products.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

#define F8(a, i)                                                         \
  "+f"(a[i]), "+f"(a[i + 1]), "+f"(a[i + 2]), "+f"(a[i + 3]),            \
      "+f"(a[i + 4]), "+f"(a[i + 5]), "+f"(a[i + 6]), "+f"(a[i + 7])

// d (64 x 64, fp32) (+)= A (64 x 16) . B (16 x 64), both bf16 K-major in
// shared memory.
__device__ __forceinline__ void mma_qk(float (&d)[32], uint64_t da,
                                       uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : F8(d, 0), F8(d, 8), F8(d, 16), F8(d, 24)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 256, fp32) += A (64 x 16, bf16 in registers) . B (16 x 256,
// bf16 MN-major in shared memory): P.V at head_dim 256.
__device__ __forceinline__ void mma_pv(float (&d)[128], uint32_t a0,
                                       uint32_t a1, uint32_t a2, uint32_t a3,
                                       uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %133, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
      "%127}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : F8(d, 0), F8(d, 8), F8(d, 16), F8(d, 24), F8(d, 32), F8(d, 40),
        F8(d, 48), F8(d, 56), F8(d, 64), F8(d, 72), F8(d, 80), F8(d, 88),
        F8(d, 96), F8(d, 104), F8(d, 112), F8(d, 120)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

// The same at head_dim 128: d (64 x 128) += A (64 x 16) . B (16 x 128).
__device__ __forceinline__ void mma_pv(float (&d)[64], uint32_t a0,
                                       uint32_t a1, uint32_t a2, uint32_t a3,
                                       uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : F8(d, 0), F8(d, 8), F8(d, 16), F8(d, 24), F8(d, 32), F8(d, 40),
        F8(d, 48), F8(d, 56)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

// At head_dim 96: d (64 x 96) += A (64 x 16) . B (16 x 96).
__device__ __forceinline__ void mma_pv(float (&d)[48], uint32_t a0,
                                       uint32_t a1, uint32_t a2, uint32_t a3,
                                       uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %53, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : F8(d, 0), F8(d, 8), F8(d, 16), F8(d, 24), F8(d, 32), F8(d, 40)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

// At head_dim 64: d (64 x 64) += A (64 x 16) . B (16 x 64).
__device__ __forceinline__ void mma_pv(float (&d)[32], uint32_t a0,
                                       uint32_t a1, uint32_t a2, uint32_t a3,
                                       uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : F8(d, 0), F8(d, 8), F8(d, 16), F8(d, 24)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

#undef F8

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float rcp(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two probabilities (p0 in the low half) as bf16 pairs hi + lo: hi is p
// rounded to bf16, lo the rest rounded to bf16, so hi + lo is p to ~2^-17.
__device__ __forceinline__ void split_bf16(float p0, float p1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
  const float2 back = __bfloat1622float2(h);
  const __nv_bfloat162 r = __floats2bfloat162_rn(p0 - back.x, p1 - back.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&r);
}

// Scores are taken to the log2 domain as z = acc * pre (no softcap), or
// z = post * tanh(acc * scale / softcap) with ex2's argument acc * pre =
// 2 log2(e) acc scale / softcap and post = softcap log2(e).
//
// q, o: (B, S, H, HD); k, v: (B, S, KV, HD); bf16, contiguous; q, k, v
// are read through the tensor maps.  grid: (ceil(S / BM) * H, B).
template <int HD, bool SOFTCAP>
__global__ void __launch_bounds__(THREADS, 1)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       __nv_bfloat16* __restrict__ o,
                       float* __restrict__ lse, int S, int H, int KV,
                       int causal, int window, float pre, float post) {
  using Sh = Shape<HD>;
  constexpr int SLABS = Sh::SLABS, TILE_BYTES = Sh::TILE_BYTES,
                STAGES = Sh::STAGES, ACC = Sh::ACC, SPAN = Sh::SPAN,
                SLAB_COLS = Sh::SLAB_COLS, SLAB_BYTES = Sh::SLAB_BYTES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sK = sQ + Sh::Q_BYTES;              // STAGES K tiles
  const uint32_t sV = sK + STAGES * TILE_BYTES;      // STAGES V tiles
  const uint32_t bars = sV + STAGES * TILE_BYTES;
  const uint32_t q_full = bars;
  auto k_full = [&](int st) { return bars + 8u * (1 + st); };
  auto v_full = [&](int st) { return bars + 8u * (1 + STAGES + st); };
  auto empty = [&](int st) { return bars + 8u * (1 + 2 * STAGES + st); };

  // x runs over (query tile, head), the heaviest tiles of every head
  // first, so that no heavy block is left to start late
  const int q0 = (gridDim.x / H - 1 - int(blockIdx.x) / H) * BM;
  const int h = blockIdx.x % H;
  const int b = blockIdx.y;
  const int kvh = h / (H / KV);
  // key tiles of the block's band
  const int q_last = min(q0 + BM, S) - 1;
  const int t_lo = (window ? max(0, q0 - window + 1) : 0) / BN;
  const int t_hi = ((causal ? q_last + 1 : S) + BN - 1) / BN;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(k_full(st), 1);
      mbar_init(v_full(st), 1);
      mbar_init(empty(st), CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wgi = threadIdx.x / 128;
  if (wgi == 2) {
    // ---- producer: one thread issues every TMA load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == CONSUMERS) {
      mbar_expect_tx(q_full, Sh::Q_BYTES);
      for (int half = 0; half < 2; ++half)
        for (int sl = 0; sl < SLABS; ++sl)
          tma_load(sQ + (half * SLABS + sl) * SLAB_BYTES, &tm_q, q_full,
                   sl * SLAB_COLS, h, q0 + 64 * half, b);
      for (int t = t_lo; t < t_hi; ++t) {
        const int i = t - t_lo;
        const int st = i % STAGES;
        mbar_wait(empty(st), ((i / STAGES) & 1) ^ 1);  // 1st pass: free
        mbar_expect_tx(k_full(st), TILE_BYTES);
        for (int sl = 0; sl < SLABS; ++sl)
          tma_load(sK + st * TILE_BYTES + sl * SLAB_BYTES, &tm_k, k_full(st),
                   sl * SLAB_COLS, kvh, t * BN, b);
        mbar_expect_tx(v_full(st), TILE_BYTES);
        for (int sl = 0; sl < SLABS; ++sl)
          tma_load(sV + st * TILE_BYTES + sl * SLAB_BYTES, &tm_v, v_full(st),
                   sl * SLAB_COLS, kvh, t * BN, b);
      }
    }
  } else {
    // ---- consumers: 64 query rows per warpgroup ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int r0 = q0 + 64 * wgi;                    // first row of the group
    const int row_a = r0 + 16 * warp + lane / 4;     // rows row_a, row_a + 8
    const int col_t = 2 * (lane % 4);
    const bool active = r0 < S;
    const int w_last = min(r0 + 63, S - 1);
    const int w_lo = (window ? max(0, r0 - window + 1) : 0) / BN;
    const int w_hi = ((causal ? w_last + 1 : S) + BN - 1) / BN;
    const uint32_t sQw = sQ + wgi * TILE_BYTES;

    float acc[ACC];
#pragma unroll
    for (int e = 0; e < ACC; ++e) acc[e] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.f, 0.f};

    mbar_wait(q_full, 0);
    for (int t = t_lo; t < t_hi; ++t) {
      const int i = t - t_lo;
      const int st = i % STAGES;
      const uint32_t parity = (i / STAGES) & 1;
      mbar_wait(k_full(st), parity);
      if (active && t >= w_lo && t < w_hi) {
        // S = Q . K^T over HD: SLABS slabs of KSTEPS k-steps of 16
        // columns (32 bytes), each inside a swizzle atom
        float s[32];
#pragma unroll
        for (int e = 0; e < 32; ++e) s[e] = 0.f;
        const uint32_t kst = sK + st * TILE_BYTES;
        fence_regs(s);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          const uint32_t off =
              (kk / Sh::KSTEPS) * SLAB_BYTES + (kk % Sh::KSTEPS) * 32;
          mma_qk(s, slab_desc<SPAN>(sQw + off, 16, 8 * SPAN),
                 slab_desc<SPAN>(kst + off, 16, 8 * SPAN), kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(s);

        // s[e]: row row_a + 8 ((e >> 1) & 1), key t BN + 8 (e >> 2) +
        // col_t + (e & 1)
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          if (SOFTCAP)
            s[e] = fmaf(-2.f * post, rcp(ex2(s[e] * pre) + 1.f), post);
          else
            s[e] *= pre;
        }
        const int c0 = t * BN;
        if (c0 + BN > S || (causal && c0 + BN - 1 > r0) ||
            (window && c0 <= r0 + 63 - window)) {
#pragma unroll
          for (int e = 0; e < 32; ++e) {
            const int r = row_a + 8 * ((e >> 1) & 1);
            const int c = c0 + 8 * (e >> 2) + col_t + (e & 1);
            if (!(c < S && (!causal || c <= r) && (!window || c > r - window)))
              s[e] = -INFINITY;
          }
        }
        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int e = 0; e < 32; ++e)
          mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], s[e]);
        float mu[2], corr[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          // a row with no valid key yet keeps m = -inf; its p are 0
          mu[r] = mx[r] == -INFINITY ? 0.f : mx[r];
          corr[r] = ex2(m[r] - mu[r]);
          m[r] = mx[r];
          l[r] *= corr[r];
        }
        // P as bf16 hi + lo: the A fragments of 4 k-steps each
        uint32_t ph[16], pl[16];
#pragma unroll
        for (int e = 0; e < 32; e += 2) {
          const int r = (e >> 1) & 1;
          const float p0 = ex2(s[e] - mu[r]);
          const float p1 = ex2(s[e + 1] - mu[r]);
          l[r] += p0 + p1;
          split_bf16(p0, p1, ph[e >> 1], pl[e >> 1]);
        }
#pragma unroll
        for (int e = 0; e < ACC; ++e) acc[e] *= corr[(e >> 1) & 1];

        // O += P . V: 4 k-steps of 16 keys; V's slabs SLAB_BYTES apart
        // along the head dim (LBO), 8-key groups 8 SPAN bytes apart (SBO)
        mbar_wait(v_full(st), parity);
        const uint32_t vst = sV + st * TILE_BYTES;
        fence_regs(acc);
        fence_regs(ph);
        fence_regs(pl);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t dv =
              slab_desc<SPAN>(vst + kk * 16 * SPAN, SLAB_BYTES, 8 * SPAN);
          mma_pv(acc, ph[4 * kk], ph[4 * kk + 1], ph[4 * kk + 2],
                 ph[4 * kk + 3], dv);
          mma_pv(acc, pl[4 * kk], pl[4 * kk + 1], pl[4 * kk + 2],
                 pl[4 * kk + 3], dv);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(acc);
      } else {
        mbar_wait(v_full(st), parity);
      }
      mbar_arrive(empty(st));
    }

    // epilogue: acc[e] is row row_a + 8 ((e >> 1) & 1), column
    // 8 (e >> 2) + col_t + (e & 1)
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      inv[r] = l[r] > 0.f ? 1.f / l[r] : 0.f;  // empty rows write 0
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row_a + 8 * r;
      if (row >= S) continue;
      // m is in the log2 domain: lse = (m + log2 l) ln 2
      if (lse != nullptr && lane % 4 == 0)
        lse[(size_t(b) * H + h) * S + row] =
            l[r] > 0.f ? (m[r] + log2f(l[r])) * 0.6931471805599453f
                       : -INFINITY;
      __nv_bfloat16* orow = o + ((size_t(b) * S + row) * H + h) * HD + col_t;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
            __floats2bfloat162_rn(acc[4 * j + 2 * r] * inv[r],
                                  acc[4 * j + 2 * r + 1] * inv[r]);
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

cudaError_t encode_tiled(EncodeTiled* fn) {
  static EncodeTiled cached = nullptr;
  if (!cached) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || p == nullptr)
      return cudaErrorSymbolNotFound;
    cached = reinterpret_cast<EncodeTiled>(p);
  }
  *fn = cached;
  return cudaSuccess;
}

// Make the current device's primary context current on the calling
// thread.  cuTensorMapEncodeTiled fails without one, and a thread that
// has made no runtime call yet has none: autograd's device thread
// reaching the backward first, say.
cudaError_t bind_context() {
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  return err == cudaSuccess ? cudaSetDevice(dev) : err;
}

// A (B, S, heads, HD) bf16 tensor as 4-D (HD, heads, S, B), read in
// boxes of one slab (Shape<HD>::SLAB_COLS columns x 64 rows of one head)
// with the slab's swizzle; rows past S read as zeros.
template <int HD>
cudaError_t make_map(CUtensorMap* map, const void* ptr, int B, int S,
                     int heads) {
  using Sh = Shape<HD>;
  EncodeTiled encode;
  const cudaError_t err = encode_tiled(&encode);
  if (err != cudaSuccess) return err;
  const cuuint64_t elem = sizeof(__nv_bfloat16);
  const cuuint64_t dims[4] = {cuuint64_t(HD), cuuint64_t(heads),
                              cuuint64_t(S), cuuint64_t(B)};
  const cuuint64_t strides[3] = {HD * elem, cuuint64_t(heads) * HD * elem,
                                 cuuint64_t(S) * heads * HD * elem};
  const cuuint32_t box[4] = {Sh::SLAB_COLS, 1, 64, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      Sh::SPAN == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                      : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int HD, bool SOFTCAP>
cudaError_t launch_softcap(const CUtensorMap& tq, const CUtensorMap& tk,
                           const CUtensorMap& tv, void* o, float* lse, int B,
                           int S, int H, int KV, int causal, int window,
                           float pre, float post, cudaStream_t stream) {
  constexpr size_t smem = Shape<HD>::SMEM_BYTES;
  auto kernel = flash_wgmma_kernel<HD, SOFTCAP>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BM - 1) / BM * H, B);
  kernel<<<grid, THREADS, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, S, H, KV, causal,
      window, pre, post);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int S, int H, int KV, float scale,
                   int causal, int window, float softcap,
                   cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  cudaError_t err = make_map<HD>(&tq, q, B, S, H);
  if (err == cudaSuccess) err = make_map<HD>(&tk, k, B, S, KV);
  if (err == cudaSuccess) err = make_map<HD>(&tv, v, B, S, KV);
  if (err != cudaSuccess) return err;
  constexpr float LOG2E = 1.4426950408889634f;
  if (softcap > 0.f)
    return launch_softcap<HD, true>(tq, tk, tv, o, lse, B, S, H, KV, causal,
                                    window, 2.f * LOG2E * scale / softcap,
                                    softcap * LOG2E, stream);
  return launch_softcap<HD, false>(tq, tk, tv, o, lse, B, S, H, KV, causal,
                                   window, scale * LOG2E, 0.f, stream);
}

}  // namespace wg

// ---------------------------------------------------------------------------
// Backward (FlashAttention-2's algorithm).  Two designs, chosen explicitly
// by (dtype, head_dim) in `backward_design_of`:
//
//   wgmma  bf16 at head_dim 256 (gemma2-2b, with its softcap and window),
//          128 (qwen2-7b and the other hd-128 configs), 96 (phi3-mini-3.8b)
//          and 64 (musicgen-medium): every launch of their training paths.
//          Tensor cores, TMA and warp specialisation; one template over
//          the head dim (namespace bwg).
//   simt   float32 at head_dim 16 (the smoke configs' training).  fp32
//          FMAs on the CUDA cores (namespace bwd).
//
// Any other pair is refused.  The reference has no backward kernel: it
// differentiates its plain attention (`jax.value_and_grad` through
// models/attention.py).
//
// Given q, k, v, dO and the forward's lse (float32 (B, H, S), m + log l of
// the scaled, softcapped scores) both write dQ, dK and dV in q's dtype,
// every sum in fp32:
//   P   = exp(s - lse') on the valid (row, key) pairs, else 0
//   dP  = dO . V^T,  D = rowsum(P * dP)
//   dS  = P * (dP - D) * (1 - tanh^2(raw / cap) if softcap)
//   dV += P^T . dO,  dK += dS^T . Q * scale,  dQ += dS . K * scale
// with raw = q.k * scale and s = cap tanh(raw / cap) (or raw), the masks the
// forward's (key c valid for row r iff c < S, c <= r when causal, c > r -
// window when windowed).  A row with no valid key contributes nothing.
//
// D is not FlashAttention-2's rowsum(dO * O) over the stored output: O is
// bf16, and where the softmax is saturated (qwen2-7b's random init gives
// scores of std ~300) the winning key's true dS is ~0 while dO . (O_bf16 -
// O) is 2^-9 of |dO| |O|, which then is the whole gradient (its signs
// agreed with autograd's on half the elements).  The row pass forms D from
// the same P and dP as dS, and renormalises P over the backward's own
// scores: l' = sum exp(s - lse), lse' = lse + log l', D = sum P dP / l'.
// A saturated row then gets dS ~ 0 for its winner, as autograd's softmax
// gives it.
//
// Both designs take three launches and no atomics, so two runs give the
// same bits (and a restarted training run replays an uninterrupted one):
//   rows  a block a q tile: lse' and D;
//   dkdv  a block a KV tile, heavy (earliest) tiles first; it loops over
//         the q-heads of its GQA group and the q tiles that see its keys,
//         recomputing P and dS tile by tile; dK and dV stay in registers
//         and sum the group's q-heads there;
//   dq    a block a q tile, latest rows first; it loops over the key tiles
//         its rows see.
// (FlashAttention-3's fused design accumulates dQ across the KV blocks
// with float atomics, or in a fixed order behind a semaphore; the three
// launches recompute S and dP instead, which costs tensor-core work and
// keeps every sum in one fixed order without any cross-block wait.)
//
// The simt design: tiles fp32 in shared memory with odd row strides, as
// the forward's simt design keeps them; a block of 256 threads, a thread
// 4 x 4 scores and 4 keys or rows x hd/16 columns of its output.  It ran
// qwen2-7b's training at hd 128 before the wgmma design (9.89 ms at B4
// S1024 H32 KV4, 113x its tensor-core bound: 18 hd fp32 FMAs a pair on
// the CUDA cores).
//
// The wgmma design.  What bounds it: the function's products, 10 hd
// operations a visible pair (S, dP, dV, dK and dQ, 2 hd each), on the
// tensor cores at 989 TFLOP/s take longer than its bytes (q, k, v, dO and
// lse read once, dq, dk, dv written once) at 3.35 TB/s at every training
// shape: 0.087 against 0.045 ms at qwen2-7b's B4 S1024 H32 KV4 hd 128.
// What the design runs on the tensor cores, a visible pair:
//   rows  S, dP                        4 hd
//   dkdv  S, dP, dV and dK hi + lo     12 hd  (14 hd at hd 256, below)
//   dq    S, dP, dQ hi + lo            8 hd
// 24 hd in all (26 hd at 256), 2.4x the function's 10 hd.  Second, the
// special-function unit: 3 exp2 a pair (one a pass) and with the softcap
// 3 more exp2 and 3 rcp (tanh recomputed a pass).
//
// What the wgmma design does about it:
//   * every product is wgmma (bf16 in, fp32 out) from the forward's TMA
//     slabs: 64-column slabs with the 128-byte swizzle at hd 256, 128 and
//     64, 32-column slabs with the 64-byte swizzle at hd 96 (three of them
//     hold it exactly); `Shape<HD>` and `make_map<HD>` are the forward's;
//   * dkdv: a block owns 128 keys (64 at hd 256), each consumer warpgroup
//     64 of them; K and V of the block stay in shared memory; a producer
//     warp streams the q tiles (64 rows) of every q-head of the group that
//     see the keys through a ring of Q, dO, lse' and D (TMA for the tiles,
//     a bulk copy of 256 B for each row vector, from a scratch padded to
//     64 rows).  S^T = K . Q^T and dP^T = V . dO^T are m64n64k16 with both
//     operands K-major, as the forward's Q . K^T; P^T and dS^T then sit in
//     the accumulator layout, which packs straight into wgmma's register A
//     fragment, so dV += P^T . dO and dK += dS^T . Q are m64n{hd}k16 with
//     the stage's dO and Q tiles as B, MN-major, as the forward's P . V
//     reads V.  A warpgroup skips the q tiles outside its keys' band and
//     masks only the tiles that cross the diagonal, the window's edge or S.
//     Tried and dropped: blocks of 64 keys whose two warpgroups take
//     alternate q tiles and add their sums in shared memory at the end
//     (more, lighter blocks under the causal mask): 0.59 against 0.62 ms
//     at hd 128, but 0.51 against 0.46 at hd 96 and 0.33 against 0.30 at
//     hd 64, since each stage of the ring then feeds one warpgroup;
//   * hd 256: dK and dV of 64 keys x 256 columns are 128 fp32 registers a
//     thread each, 256 together with nothing else, past setmaxnreg's 240.
//     So at 256 the block's two warpgroups own the same 64 keys and split
//     the outputs: warpgroup 0 forms S^T and dV, warpgroup 1 S^T, dP^T,
//     dS^T and dK (S^T is formed twice: 2 hd a pair more);
//   * rows and dq: a block a 128-row q tile (two warpgroups of 64 rows,
//     wgmma's M), Q and dO resident, a ring of K and V tiles as the
//     forward's; S = Q . K^T and dP = dO . V^T are m64n64k16, and in dq
//     dS packs into the A fragment of dQ += dS . K (K's tile as B,
//     MN-major).  The row pass reads the forward's lse for its two rows a
//     thread, the dq pass lse' and D; the heaviest (latest) q tiles of all
//     heads start first;
//   * precision: P for dV and dS for dK and dQ are split hi + lo, both bf16
//     (hi = x rounded, lo = the rest rounded), and each of those products
//     runs twice, exact to ~2^-17 as in the forward's P . V: the forward's
//     one-ulp check failed by 2.5-3.5x with P rounded once, and dS has the
//     same 2^-9 rounding against sums that cancel (every row of dS sums to
//     0).  S and dP take bf16 inputs whose products are exact in fp32;
//   * exp2 in the log2 domain (the scale and log2 e folded into one
//     constant, the softcap's tanh as 1 - 2 / (2^(2x log2 e) + 1) with
//     ex2.approx and rcp.approx, as the forward's); lse' and D are kept in
//     the scratch in the log2 domain and padded to a multiple of 64 rows
//     (lse' = +inf and D = 0 past S, so a padded row has P = 0);
//   * shared memory, rings of 512/hd stages where they fit below 227 KB:
//     dkdv 2, 4, 5 and 8 stages at hd 256, 128, 96, 64 (194-199 KB at 256
//     and 128); rows and dq 1, 4, 5 and 8 (193 KB at 256, where Q and dO
//     of 128 rows take 128 KB); one block an SM, 384 threads, setmaxnreg
//     240 for the consumers, 24 for the producer.
//
// What ptxas and the SASS say (nvcc for sm_90a, kernel_probe.py bwd):
// every kernel at every head dim reports 168 registers (the launch
// bound's share; setmaxnreg then moves 240 to each consumer thread) and
// no spill, but for dkdv at hd 128, whose two accumulators (64 + 64) meet
// S^T, dP^T and their packed halves: 20 B of spill stores (48 B with the
// softcap).  HGMMA instructions a kernel (rows, dkdv, dq): 32, 64, 40 at
// hd 256; 16, 32, 24 at 128; 12, 28, 20 at 96; 8, 24, 16 at 64.
//
// Measured on an H100 80GB HBM3 at 700 W (chip_smoke.py's
// phase_flash_backward, against the plain version with the one-bf16-ulp
// tolerance): qwen2-7b's shape 0.62 ms, err/tol 0.96 (the simt design it
// replaces 9.89 ms); gemma2-2b's (B1 S8192 H16 KV4, window 4096, softcap
// 50) 5.04 ms, 0.94; phi3-mini's (B4 S1024 H32 KV32 hd 96) 0.46 ms,
// 0.93; musicgen's (B4 S1024 H24 KV24 hd 64) 0.30 ms, 0.91.  At the
// models' own q, k, v at random init (qwen2-7b's scores of std ~200, rows
// saturated on one key) float32 sums in any order move P on near-tied
// rows: against the float64 backward (kernel_probe.py saturated) this
// design's dk is 2.2-2.5 bf16 ulps off at qwen2-7b's first two layers and
// dq 1.4-2.3, the plain float32 version's dk 3.5-8.8 and dq 1.1-2.0; both
// within one ulp at the other models' layers and at a fan-in-scaled init.

// The simt design.
namespace bwd {

using simt::BK;
using simt::BQ;
using simt::NT;
using simt::from_float;
using simt::half_warp_sum;
using simt::load_tile;

template <int HD>
constexpr size_t dkdv_smem_bytes() {
  return sizeof(float) * (4 * size_t(64) * (HD + 1) + 2 * size_t(64) * 65 +
                          2 * 64);
}

template <int HD>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (4 * size_t(64) * (HD + 1) + size_t(64) * 65 +
                          2 * 64);
}

// One (row tile, key tile) pair: p = exp(s - lse) on the valid pairs (0
// elsewhere), dp = dO . v and the softcap's chain factor dt, for rows
// row0 + ty + 16 a and keys key0 + tx + 16 c: sQ/sdO hold the rows, sK/sV
// the keys, sL the rows' lse.
template <int HD>
__device__ __forceinline__ void tile_p_dp(
    const float* sQ, const float* sdO, const float* sK, const float* sV,
    const float* sL, int row0, int key0, int S, float scale, int causal,
    int window, float softcap, int ty, int tx, float (&p)[4][4],
    float (&dp)[4][4], float (&dt)[4][4]) {
  constexpr int RS = HD + 1;
  float s[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[a][c] = dp[a][c] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    float qa[4], oa[4], kc[4], vc[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      qa[a] = sQ[(ty + 16 * a) * RS + d];
      oa[a] = sdO[(ty + 16 * a) * RS + d];
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      kc[c] = sK[(tx + 16 * c) * RS + d];
      vc[c] = sV[(tx + 16 * c) * RS + d];
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[a][c] = fmaf(qa[a], kc[c], s[a][c]);
        dp[a][c] = fmaf(oa[a], vc[c], dp[a][c]);
      }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = row0 + ty + 16 * a;
    const float lse = sL[ty + 16 * a];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = key0 + tx + 16 * c;
      const bool valid = r < S && col < S && (!causal || col <= r) &&
                         (!window || col > r - window);
      float x = s[a][c] * scale;
      dt[a][c] = 1.f;
      if (softcap > 0.f) {
        const float t = tanhf(x / softcap);
        x = softcap * t;
        dt[a][c] = 1.f - t * t;
      }
      p[a][c] = valid ? expf(x - lse) : 0.f;
    }
  }
}

// Rows [row0, row0 + 64) of one head: `a` into sL and `b` into sD (0
// past S).
__device__ __forceinline__ void load_rows(float* sL, float* sD,
                                          const float* a, const float* b,
                                          size_t head_off, int row0, int S) {
  for (int i = threadIdx.x; i < 64; i += NT) {
    const int r = row0 + i;
    sL[i] = r < S ? a[head_off + r] : 0.f;
    if (sD != nullptr) sD[i] = r < S ? b[head_off + r] : 0.f;
  }
}

// The key tiles of the band of rows [row0, row0 + BQ), as the forward's.
__device__ __forceinline__ void key_band(int row0, int S, int causal,
                                         int window, int& t_lo, int& t_hi) {
  const int row_last = min(row0 + BQ, S) - 1;
  t_lo = (window ? max(0, row0 - window + 1) : 0) / BK;
  t_hi = ((causal ? row_last + 1 : S) + BK - 1) / BK;
}

// lse' = lse + log l' and D = sum P dP / l' for each row, l' = sum exp(s -
// lse) over the row's valid keys.  grid: (ceil(S / BQ), H, B); NT
// threads; dq_smem_bytes<HD>() dynamic.
template <typename T, int HD>
__global__ void __launch_bounds__(NT)
    flash_bwd_rows_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          const float* __restrict__ lse,
                          float* __restrict__ lse_out,
                          float* __restrict__ dsum, int S, int S_pad, int H,
                          int KV, float scale, int causal, int window,
                          float softcap) {
  constexpr int RS = HD + 1;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sdO = sQ + BQ * RS;
  float* sK = sdO + BQ * RS;
  float* sV = sK + BK * RS;
  float* sL = sV + BK * RS;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int row0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // latest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const size_t q_stride = size_t(H) * HD, kv_stride = size_t(KV) * HD;
  const size_t q_off = (size_t(b) * S * H + h) * HD;
  const size_t kv_off = (size_t(b) * S * KV + kvh) * HD;
  const size_t head_off = (size_t(b) * H + h) * S;
  load_tile<T, HD, BQ>(sQ, RS, q + q_off, q_stride, row0, S);
  load_tile<T, HD, BQ>(sdO, RS, dout + q_off, q_stride, row0, S);
  load_rows(sL, nullptr, lse, nullptr, head_off, row0, S);
  int t_lo, t_hi;
  key_band(row0, S, causal, window, t_lo, t_hi);

  float l[4] = {0.f, 0.f, 0.f, 0.f}, d[4] = {0.f, 0.f, 0.f, 0.f};
  for (int t = t_lo; t < t_hi; ++t) {
    __syncthreads();  // the last tile's products are done with sK, sV
    load_tile<T, HD, BK>(sK, RS, k + kv_off, kv_stride, t * BK, S);
    load_tile<T, HD, BK>(sV, RS, v + kv_off, kv_stride, t * BK, S);
    __syncthreads();
    float p[4][4], dp[4][4], dt[4][4];
    tile_p_dp<HD>(sQ, sdO, sK, sV, sL, row0, t * BK, S, scale, causal,
                  window, softcap, ty, tx, p, dp, dt);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        l[a] += p[a][c];
        d[a] = fmaf(p[a][c], dp[a][c], d[a]);
      }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    l[a] = half_warp_sum(l[a]);
    d[a] = half_warp_sum(d[a]);
    const int r = row0 + ty + 16 * a;
    if (tx == 0 && r < S) {
      const bool empty = !(l[a] > 0.f);
      const size_t at = (size_t(b) * H + h) * S_pad + r;
      lse_out[at] = empty ? sL[ty + 16 * a] : sL[ty + 16 * a] + logf(l[a]);
      dsum[at] = empty ? 0.f : d[a] / l[a];
    }
  }
}

// grid: (ceil(S / BK), KV, B); NT threads; dkdv_smem_bytes<HD>() dynamic.
template <typename T, int HD>
__global__ void __launch_bounds__(NT)
    flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ dsum, T* __restrict__ dk,
                          T* __restrict__ dv, int S, int S_pad, int H, int KV,
                          float scale, int causal, int window,
                          float softcap) {
  constexpr int RS = HD + 1, PS = BK + 1, NJ = HD / 16;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + BK * RS;
  float* sQ = sV + BK * RS;
  float* sdO = sQ + BQ * RS;
  float* sP = sdO + BQ * RS;
  float* sdS = sP + BQ * PS;
  float* sL = sdS + BQ * PS;
  float* sD = sL + BQ;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int key0 = blockIdx.x * BK;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int group = H / KV;
  const size_t q_stride = size_t(H) * HD, kv_stride = size_t(KV) * HD;
  const size_t kv_off = (size_t(b) * S * KV + kvh) * HD;
  load_tile<T, HD, BK>(sK, RS, k + kv_off, kv_stride, key0, S);
  load_tile<T, HD, BK>(sV, RS, v + kv_off, kv_stride, key0, S);

  // the rows that see a key of this tile
  const int key_last = min(key0 + BK, S) - 1;
  const int row_lo = causal ? key0 : 0;
  const int row_hi = window ? min(S, key_last + window) : S;  // exclusive
  const int qt_lo = row_lo / BQ, qt_hi = (row_hi + BQ - 1) / BQ;

  float acc_k[4][NJ], acc_v[4][NJ];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc_k[a][j] = acc_v[a][j] = 0.f;

  for (int hh = 0; hh < group; ++hh) {
    const int h = kvh * group + hh;
    const size_t q_off = (size_t(b) * S * H + h) * HD;
    const size_t head_off = (size_t(b) * H + h) * S_pad;
    for (int qt = qt_lo; qt < qt_hi; ++qt) {
      const int row0 = qt * BQ;
      __syncthreads();  // the last tile's products are done with sQ .. sD
      load_tile<T, HD, BQ>(sQ, RS, q + q_off, q_stride, row0, S);
      load_tile<T, HD, BQ>(sdO, RS, dout + q_off, q_stride, row0, S);
      load_rows(sL, sD, lse, dsum, head_off, row0, S);
      __syncthreads();
      float p[4][4], dp[4][4], dt[4][4];
      tile_p_dp<HD>(sQ, sdO, sK, sV, sL, row0, key0, S, scale, causal,
                    window, softcap, ty, tx, p, dp, dt);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          sP[(ty + 16 * a) * PS + tx + 16 * c] = p[a][c];
          sdS[(ty + 16 * a) * PS + tx + 16 * c] =
              p[a][c] * (dp[a][c] - sD[ty + 16 * a]) * dt[a][c];
        }
      __syncthreads();
      // dV[key][d] += P[i][key] dO[i][d]; dK[key][d] += dS[i][key] Q[i][d]
#pragma unroll 2
      for (int i = 0; i < BQ; ++i) {
        float pa[4], da[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          pa[a] = sP[i * PS + ty + 16 * a];
          da[a] = sdS[i * PS + ty + 16 * a];
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float o_ = sdO[i * RS + tx + 16 * j];
          const float q_ = sQ[i * RS + tx + 16 * j];
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            acc_v[a][j] = fmaf(pa[a], o_, acc_v[a][j]);
            acc_k[a][j] = fmaf(da[a], q_, acc_k[a][j]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int key = key0 + ty + 16 * a;
    if (key >= S) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const size_t at = kv_off + size_t(key) * kv_stride + tx + 16 * j;
      dk[at] = from_float<T>(acc_k[a][j] * scale);
      dv[at] = from_float<T>(acc_v[a][j]);
    }
  }
}

// grid: (ceil(S / BQ), H, B); NT threads; dq_smem_bytes<HD>() dynamic.
template <typename T, int HD>
__global__ void __launch_bounds__(NT)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ dsum, T* __restrict__ dq,
                        int S, int S_pad, int H, int KV, float scale,
                        int causal, int window, float softcap) {
  constexpr int RS = HD + 1, PS = BK + 1, NJ = HD / 16;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sdO = sQ + BQ * RS;
  float* sK = sdO + BQ * RS;
  float* sV = sK + BK * RS;
  float* sdS = sV + BK * RS;
  float* sL = sdS + BQ * PS;
  float* sD = sL + BQ;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int row0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // latest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const size_t q_stride = size_t(H) * HD, kv_stride = size_t(KV) * HD;
  const size_t q_off = (size_t(b) * S * H + h) * HD;
  const size_t kv_off = (size_t(b) * S * KV + kvh) * HD;
  load_tile<T, HD, BQ>(sQ, RS, q + q_off, q_stride, row0, S);
  load_tile<T, HD, BQ>(sdO, RS, dout + q_off, q_stride, row0, S);
  load_rows(sL, sD, lse, dsum, (size_t(b) * H + h) * S_pad, row0, S);
  int t_lo, t_hi;
  key_band(row0, S, causal, window, t_lo, t_hi);

  float acc[4][NJ];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[a][j] = 0.f;

  for (int t = t_lo; t < t_hi; ++t) {
    const int key0 = t * BK;
    __syncthreads();  // the last tile's products are done with sK, sV, sdS
    load_tile<T, HD, BK>(sK, RS, k + kv_off, kv_stride, key0, S);
    load_tile<T, HD, BK>(sV, RS, v + kv_off, kv_stride, key0, S);
    __syncthreads();
    float p[4][4], dp[4][4], dt[4][4];
    tile_p_dp<HD>(sQ, sdO, sK, sV, sL, row0, key0, S, scale, causal,
                  window, softcap, ty, tx, p, dp, dt);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        sdS[(ty + 16 * a) * PS + tx + 16 * c] =
            p[a][c] * (dp[a][c] - sD[ty + 16 * a]) * dt[a][c];
    __syncthreads();
    // dQ[row][d] += dS[row][c] K[c][d]
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float da[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) da[a] = sdS[(ty + 16 * a) * PS + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float k_ = sK[c * RS + tx + 16 * j];
#pragma unroll
        for (int a = 0; a < 4; ++a) acc[a][j] = fmaf(da[a], k_, acc[a][j]);
      }
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = row0 + ty + 16 * a;
    if (r >= S) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      dq[q_off + size_t(r) * q_stride + tx + 16 * j] =
          from_float<T>(acc[a][j] * scale);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, float* lse_rows,
                   float* dsum, void* dq, void* dk, void* dv, int B, int S,
                   int H, int KV, float scale, int causal, int window,
                   float softcap, cudaStream_t stream) {
  const T *q_ = static_cast<const T*>(q), *k_ = static_cast<const T*>(k),
          *v_ = static_cast<const T*>(v), *do_ = static_cast<const T*>(dout);
  constexpr size_t smem_q = dq_smem_bytes<HD>();
  const dim3 row_grid((S + BQ - 1) / BQ, H, B);
  const int S_pad = (S + 63) / 64 * 64;
  auto rows_kernel = flash_bwd_rows_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem_q));
  if (err != cudaSuccess) return err;
  rows_kernel<<<row_grid, NT, smem_q, stream>>>(
      q_, k_, v_, do_, lse, lse_rows, dsum, S, S_pad, H, KV, scale, causal,
      window, softcap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  constexpr size_t smem_kv = dkdv_smem_bytes<HD>();
  auto kv_kernel = flash_bwd_dkdv_kernel<T, HD>;
  err = cudaFuncSetAttribute(
      kv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem_kv));
  if (err != cudaSuccess) return err;
  kv_kernel<<<dim3((S + BK - 1) / BK, KV, B), NT, smem_kv, stream>>>(
      q_, k_, v_, do_, lse_rows, dsum, static_cast<T*>(dk),
      static_cast<T*>(dv), S, S_pad, H, KV, scale, causal, window, softcap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto q_kernel = flash_bwd_dq_kernel<T, HD>;
  err = cudaFuncSetAttribute(
      q_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem_q));
  if (err != cudaSuccess) return err;
  q_kernel<<<row_grid, NT, smem_q, stream>>>(
      q_, k_, v_, do_, lse_rows, dsum, static_cast<T*>(dq), S, S_pad, H, KV,
      scale, causal, window, softcap);
  return cudaGetLastError();
}

}  // namespace bwd

// ---------------------------------------------------------------------------
// Backward, design wgmma (bf16, head_dim 256, 128, 96 and 64)
// ---------------------------------------------------------------------------
namespace bwg {

using wg::CONSUMERS;
using wg::THREADS;
using wg::Shape;
using wg::ex2;
using wg::fence_regs;
using wg::mbar_arrive;
using wg::mbar_expect_tx;
using wg::mbar_init;
using wg::mbar_wait;
using wg::mma_pv;
using wg::mma_qk;
using wg::rcp;
using wg::slab_desc;
using wg::smem_u32;
using wg::split_bf16;
using wg::tma_load;
using wg::wgmma_commit;
using wg::wgmma_fence;
using wg::wgmma_wait_all;

constexpr int SMEM_LIMIT = 232448;  // 227 KB, the most a block may take
constexpr int ROWS = 64;            // rows of a q tile, keys of a key tile
constexpr float LOG2E = 1.4426950408889634f;

constexpr int cmin(int a, int b) { return a < b ? a : b; }

// What the head dim sets for the two kernels (see the notes above).  A
// tile of 64 rows is Shape<HD>::TILE_BYTES of slabs, as the forward's.
template <int HD>
struct Plan {
  static constexpr int TILE = Shape<HD>::TILE_BYTES;
  // dkdv: at hd 256 the two warpgroups share 64 keys and split dK and dV
  static constexpr bool SPLIT = HD == 256;
  static constexpr int KEYS = SPLIT ? 64 : 128;            // keys a block
  static constexpr int KV_TILES = KEYS / ROWS;
  static constexpr int KV_RESIDENT = 2 * KV_TILES * TILE;  // K and V
  static constexpr int KV_STAGE = 2 * TILE + 2 * ROWS * 4; // Q, dO, lse', D
  static constexpr int KV_STAGES = cmin(
      512 / HD, (SMEM_LIMIT - 1024 - KV_RESIDENT - 256) / KV_STAGE);
  static constexpr size_t KV_SMEM = 1024 + KV_RESIDENT +
                                    size_t(KV_STAGES) * KV_STAGE +
                                    8 * (1 + 3 * KV_STAGES);
  // rows and dq: Q and dO of 128 rows resident, a ring of K and V tiles
  static constexpr int Q_RESIDENT = 4 * TILE;
  static constexpr int Q_STAGES = cmin(
      512 / HD, (SMEM_LIMIT - 1024 - Q_RESIDENT - 256) / (2 * TILE));
  static constexpr size_t Q_SMEM = 1024 + Q_RESIDENT +
                                   size_t(Q_STAGES) * 2 * TILE +
                                   8 * (1 + 3 * Q_STAGES);
  static_assert(KV_STAGES >= 1 && Q_STAGES >= 1, "a ring needs a stage");
  static_assert(KV_SMEM <= SMEM_LIMIT && Q_SMEM <= SMEM_LIMIT,
                "a block's shared memory");
};

// `bytes` (a multiple of 16) from global `src` to shared `dst`, both
// 16-byte aligned, counted on `bar`'s transaction count.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// A score in the log2 domain and the softcap's chain factor: z = acc * pre
// (dt 1) without a softcap; with one, t = tanh(acc * scale / cap) as the
// forward forms it, z = post * t and dt = 1 - t^2.
template <bool SOFTCAP>
__device__ __forceinline__ float log2_score(float acc, float pre, float post,
                                            float& dt) {
  if (SOFTCAP) {
    const float t = fmaf(-2.f, rcp(ex2(acc * pre) + 1.f), 1.f);
    dt = fmaf(-t, t, 1.f);
    return post * t;
  }
  dt = 1.f;
  return acc * pre;
}

// acc (64 x 64) = A (64 rows at `a`) . B (64 rows at `b`)^T over HD, both
// K-major slabs: S = Q.K^T, S^T = K.Q^T, dP = dO.V^T, dP^T = V.dO^T.
template <int HD>
__device__ __forceinline__ void mma_rows(float (&acc)[32], uint32_t a,
                                         uint32_t b) {
  using Sh = Shape<HD>;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t off =
        (kk / Sh::KSTEPS) * Sh::SLAB_BYTES + (kk % Sh::KSTEPS) * 32;
    mma_qk(acc, slab_desc<Sh::SPAN>(a + off, 16, 8 * Sh::SPAN),
           slab_desc<Sh::SPAN>(b + off, 16, 8 * Sh::SPAN), kk > 0);
  }
}

// acc (64 x HD) += X (64 x 64, its A fragments hi + lo) . the tile at
// `tile` (64 rows x HD, read MN-major): dV += P^T.dO, dK += dS^T.Q,
// dQ += dS.K.
template <int HD>
__device__ __forceinline__ void mma_cols(float (&acc)[HD / 2],
                                         const uint32_t (&hi)[16],
                                         const uint32_t (&lo)[16],
                                         uint32_t tile) {
  using Sh = Shape<HD>;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t db = slab_desc<Sh::SPAN>(tile + kk * 16 * Sh::SPAN,
                                            Sh::SLAB_BYTES, 8 * Sh::SPAN);
    mma_pv(acc, hi[4 * kk], hi[4 * kk + 1], hi[4 * kk + 2], hi[4 * kk + 3],
           db);
    mma_pv(acc, lo[4 * kk], lo[4 * kk + 1], lo[4 * kk + 2], lo[4 * kk + 3],
           db);
  }
}

// 32 accumulator values (pairs along a row) as 16 bf16x2 hi + lo.
__device__ __forceinline__ void pack(const float (&x)[32], uint32_t (&hi)[16],
                                     uint32_t (&lo)[16]) {
#pragma unroll
  for (int j = 0; j < 16; ++j)
    split_bf16(x[2 * j], x[2 * j + 1], hi[j], lo[j]);
}

// One consumer warpgroup of the dK/dV kernel: keys kw0 .. kw0 + 63 of KV
// head kvh, over the `n_iter` q tiles the producer streams (q-head kvh *
// group + i / nq, tile qt_lo + i % nq).  With WANT_DV it forms S^T, P^T
// and dV; with WANT_DK S^T, dP^T, dS^T and dK.
template <int HD, bool SOFTCAP, bool WANT_DV, bool WANT_DK>
__device__ __forceinline__ void dkdv_consumer(
    uint32_t sKw, uint32_t sVw, uint32_t sQ, uint32_t sO,
    const float* lring, const float* dring, uint32_t kv_full,
    uint32_t bars, int kw0, int kvh, int b, int qt_lo, int nq, int n_iter,
    int S, int KV, int causal, int window, float pre, float post,
    float scale, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv) {
  using P = Plan<HD>;
  constexpr int TILE = P::TILE, STAGES = P::KV_STAGES, ACC = HD / 2;
  auto q_full = [&](int st) { return bars + 8u * (1 + st); };
  auto o_full = [&](int st) { return bars + 8u * (1 + STAGES + st); };
  auto empty = [&](int st) { return bars + 8u * (1 + 2 * STAGES + st); };
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const int key_a = kw0 + 16 * warp + lane / 4;  // keys key_a, key_a + 8
  const int col_t = 2 * (lane % 4);
  const bool active = kw0 < S;
  const int kw_last = min(kw0 + ROWS - 1, S - 1);
  // the q tiles whose rows see one of this warpgroup's keys
  const int w_lo = (causal ? kw0 : 0) / ROWS;
  const int w_hi =
      ((window ? min(S, kw_last + window) : S) + ROWS - 1) / ROWS;

  float acc_v[WANT_DV ? ACC : 1], acc_k[WANT_DK ? ACC : 1];
#pragma unroll
  for (int e = 0; e < ACC; ++e) {
    if constexpr (WANT_DV) acc_v[e] = 0.f;
    if constexpr (WANT_DK) acc_k[e] = 0.f;
  }

  mbar_wait(kv_full, 0);
  for (int i = 0; i < n_iter; ++i) {
    const int qt = qt_lo + i % nq;
    const int r0 = qt * ROWS;
    const int st = i % STAGES;
    const uint32_t parity = (i / STAGES) & 1;
    const uint32_t qst = sQ + st * TILE, ost = sO + st * TILE;
    mbar_wait(q_full(st), parity);
    if (active && qt >= w_lo && qt < w_hi) {
      float s[32], dp[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) s[e] = dp[e] = 0.f;
      fence_regs(s);
      wgmma_fence();
      mma_rows<HD>(s, sKw, qst);  // S^T = K . Q^T
      wgmma_commit();
      mbar_wait(o_full(st), parity);
      if constexpr (WANT_DK) {
        fence_regs(dp);
        wgmma_fence();
        mma_rows<HD>(dp, sVw, ost);  // dP^T = V . dO^T
        wgmma_commit();
      }
      wgmma_wait_all();
      fence_regs(s);
      fence_regs(dp);

      // s[e], dp[e]: key key_a + 8 ((e >> 1) & 1), row r0 + cc with cc =
      // 8 (e >> 2) + col_t + (e & 1)
      const float* L = lring + st * ROWS;
      const float* D = dring + st * ROWS;
      const bool edge = r0 + ROWS > S || kw0 + ROWS > S ||
                        (causal && kw0 + ROWS - 1 > r0) ||
                        (window && kw0 <= r0 + ROWS - 1 - window);
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int cc = 8 * (e >> 2) + col_t + (e & 1);
        float dt;
        const float z = log2_score<SOFTCAP>(s[e], pre, post, dt);
        float p = ex2(z - L[cc]);
        if (edge) {
          const int key = key_a + 8 * ((e >> 1) & 1), r = r0 + cc;
          if (!(r < S && key < S && (!causal || key <= r) &&
                (!window || key > r - window)))
            p = 0.f;
        }
        s[e] = p;
        if constexpr (WANT_DK) dp[e] = p * (dp[e] - D[cc]) * dt;
      }
      uint32_t ph[16], pl[16], dh[16], dl[16];
      if constexpr (WANT_DV) {
        pack(s, ph, pl);
        fence_regs(acc_v);
        fence_regs(ph);
        fence_regs(pl);
      }
      if constexpr (WANT_DK) {
        pack(dp, dh, dl);
        fence_regs(acc_k);
        fence_regs(dh);
        fence_regs(dl);
      }
      wgmma_fence();
      if constexpr (WANT_DV) mma_cols<HD>(acc_v, ph, pl, ost);  // dV += P^T.dO
      if constexpr (WANT_DK) mma_cols<HD>(acc_k, dh, dl, qst);  // dK += dS^T.Q
      wgmma_commit();
      wgmma_wait_all();
      if constexpr (WANT_DV) fence_regs(acc_v);
      if constexpr (WANT_DK) fence_regs(acc_k);
    } else {
      mbar_wait(o_full(st), parity);
    }
    mbar_arrive(empty(st));
  }

  // acc[e]: key key_a + 8 ((e >> 1) & 1), column 8 (e >> 2) + col_t +
  // (e & 1)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key_a + 8 * r;
    if (key >= S) continue;
    const size_t at = ((size_t(b) * S + key) * KV + kvh) * HD + col_t;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      if constexpr (WANT_DK)
        *reinterpret_cast<__nv_bfloat162*>(dk + at + 8 * j) =
            __floats2bfloat162_rn(acc_k[4 * j + 2 * r] * scale,
                                  acc_k[4 * j + 2 * r + 1] * scale);
      if constexpr (WANT_DV)
        *reinterpret_cast<__nv_bfloat162*>(dv + at + 8 * j) =
            __floats2bfloat162_rn(acc_v[4 * j + 2 * r],
                                  acc_v[4 * j + 2 * r + 1]);
    }
  }
}

// dK and dV.  q, dO: (B, S, H, HD); k, v, dk, dv: (B, S, KV, HD); bf16;
// lse2, dsum: the row pass's lse' (log2 domain) and D, float32 (B, H,
// S_pad).  grid: (ceil(S / KEYS) * KV, B), the earliest keys (which the
// most rows see under the causal mask) first.
template <int HD, bool SOFTCAP>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_wgmma_kv_kernel(const __grid_constant__ CUtensorMap tm_q,
                              const __grid_constant__ CUtensorMap tm_k,
                              const __grid_constant__ CUtensorMap tm_v,
                              const __grid_constant__ CUtensorMap tm_o,
                              const float* __restrict__ lse2,
                              const float* __restrict__ dsum,
                              __nv_bfloat16* __restrict__ dk,
                              __nv_bfloat16* __restrict__ dv, int S,
                              int S_pad, int H, int KV, int causal,
                              int window, float pre, float post,
                              float scale) {
  using Sh = Shape<HD>;
  using P = Plan<HD>;
  constexpr int TILE = P::TILE, STAGES = P::KV_STAGES, SLABS = Sh::SLABS,
                SLAB_COLS = Sh::SLAB_COLS, SLAB_BYTES = Sh::SLAB_BYTES,
                KT = P::KV_TILES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = smem_u32(smem_raw);
  const uint32_t sK = (base + 1023u) & ~1023u;  // KT tiles
  const uint32_t sV = sK + KT * TILE;           // KT tiles
  const uint32_t sQ = sV + KT * TILE;           // STAGES tiles
  const uint32_t sO = sQ + STAGES * TILE;       // STAGES tiles
  const uint32_t sL = sO + STAGES * TILE;       // STAGES x 64 floats
  const uint32_t sD = sL + STAGES * ROWS * 4;   // STAGES x 64 floats
  const uint32_t bars = sD + STAGES * ROWS * 4;
  const uint32_t kv_full = bars;
  auto q_full = [&](int st) { return bars + 8u * (1 + st); };
  auto o_full = [&](int st) { return bars + 8u * (1 + STAGES + st); };
  auto empty = [&](int st) { return bars + 8u * (1 + 2 * STAGES + st); };

  const int k0 = int(blockIdx.x) / KV * P::KEYS;
  const int kvh = int(blockIdx.x) % KV;
  const int b = blockIdx.y;
  const int group = H / KV;
  // the q tiles whose rows see a key of the block
  const int key_last = min(k0 + P::KEYS, S) - 1;
  const int qt_lo = (causal ? k0 : 0) / ROWS;
  const int qt_hi =
      ((window ? min(S, key_last + window) : S) + ROWS - 1) / ROWS;
  const int nq = qt_hi - qt_lo;
  const int n_iter = group * nq;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(q_full(st), 1);
      mbar_init(o_full(st), 1);
      mbar_init(empty(st), CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wgi = threadIdx.x / 128;
  if (wgi == 2) {
    // ---- producer: one thread issues every copy ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == CONSUMERS) {
      mbar_expect_tx(kv_full, 2 * KT * TILE);
      for (int kt = 0; kt < KT; ++kt)
        for (int sl = 0; sl < SLABS; ++sl) {
          tma_load(sK + kt * TILE + sl * SLAB_BYTES, &tm_k, kv_full,
                   sl * SLAB_COLS, kvh, k0 + ROWS * kt, b);
          tma_load(sV + kt * TILE + sl * SLAB_BYTES, &tm_v, kv_full,
                   sl * SLAB_COLS, kvh, k0 + ROWS * kt, b);
        }
      for (int i = 0; i < n_iter; ++i) {
        const int h = kvh * group + i / nq;
        const int row0 = (qt_lo + i % nq) * ROWS;
        const int st = i % STAGES;
        const size_t roff = (size_t(b) * H + h) * S_pad + row0;
        mbar_wait(empty(st), ((i / STAGES) & 1) ^ 1);  // 1st pass: free
        mbar_expect_tx(q_full(st), TILE + ROWS * 4);
        for (int sl = 0; sl < SLABS; ++sl)
          tma_load(sQ + st * TILE + sl * SLAB_BYTES, &tm_q, q_full(st),
                   sl * SLAB_COLS, h, row0, b);
        bulk_load(sL + st * ROWS * 4, lse2 + roff, ROWS * 4, q_full(st));
        mbar_expect_tx(o_full(st), TILE + ROWS * 4);
        for (int sl = 0; sl < SLABS; ++sl)
          tma_load(sO + st * TILE + sl * SLAB_BYTES, &tm_o, o_full(st),
                   sl * SLAB_COLS, h, row0, b);
        bulk_load(sD + st * ROWS * 4, dsum + roff, ROWS * 4, o_full(st));
      }
    }
  } else {
    // ---- consumers ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const float* lring =
        reinterpret_cast<const float*>(smem_raw + (sL - base));
    const float* dring =
        reinterpret_cast<const float*>(smem_raw + (sD - base));
    if constexpr (P::SPLIT) {
      if (wgi == 0)
        dkdv_consumer<HD, SOFTCAP, true, false>(
            sK, sV, sQ, sO, lring, dring, kv_full, bars, k0, kvh, b, qt_lo,
            nq, n_iter, S, KV, causal, window, pre, post, scale, dk, dv);
      else
        dkdv_consumer<HD, SOFTCAP, false, true>(
            sK, sV, sQ, sO, lring, dring, kv_full, bars, k0, kvh, b, qt_lo,
            nq, n_iter, S, KV, causal, window, pre, post, scale, dk, dv);
    } else {
      dkdv_consumer<HD, SOFTCAP, true, true>(
          sK + wgi * TILE, sV + wgi * TILE, sQ, sO, lring, dring, kv_full,
          bars, k0 + ROWS * wgi, kvh, b, qt_lo, nq, n_iter, S, KV, causal,
          window, pre, post, scale, dk, dv);
    }
  }
}

// The row pass (DQ false: lse' and D from the forward's lse) and the dQ
// pass (DQ true: dQ from lse' and D).  q, dO, dq: (B, S, H, HD); k, v:
// (B, S, KV, HD); bf16.  lse: the forward's, float32 (B, H, S); lse2 and
// dsum float32 (B, H, S_pad), written by the row pass (rows S .. S_pad - 1
// as lse' = +inf, D = 0) and read by the dQ pass.  grid: (ceil(S / 128) *
// H, B), the latest q tiles of every head first.
template <int HD, bool SOFTCAP, bool DQ>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_wgmma_q_kernel(const __grid_constant__ CUtensorMap tm_q,
                             const __grid_constant__ CUtensorMap tm_k,
                             const __grid_constant__ CUtensorMap tm_v,
                             const __grid_constant__ CUtensorMap tm_o,
                             const float* __restrict__ lse,
                             float* __restrict__ lse2,
                             float* __restrict__ dsum,
                             __nv_bfloat16* __restrict__ dq, int S,
                             int S_pad, int H, int KV, int causal,
                             int window, float pre, float post,
                             float scale) {
  using Sh = Shape<HD>;
  using P = Plan<HD>;
  constexpr int TILE = P::TILE, STAGES = P::Q_STAGES, SLABS = Sh::SLABS,
                SLAB_COLS = Sh::SLAB_COLS, SLAB_BYTES = Sh::SLAB_BYTES,
                ACC = HD / 2, BM = 2 * ROWS;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;  // 2 tiles
  const uint32_t sO = sQ + 2 * TILE;                           // 2 tiles
  const uint32_t sK = sO + 2 * TILE;                           // STAGES
  const uint32_t sV = sK + STAGES * TILE;                      // STAGES
  const uint32_t bars = sV + STAGES * TILE;
  const uint32_t q_full = bars;
  auto k_full = [&](int st) { return bars + 8u * (1 + st); };
  auto v_full = [&](int st) { return bars + 8u * (1 + STAGES + st); };
  auto empty = [&](int st) { return bars + 8u * (1 + 2 * STAGES + st); };

  const int q0 = (int(gridDim.x) / H - 1 - int(blockIdx.x) / H) * BM;
  const int h = int(blockIdx.x) % H;
  const int b = blockIdx.y;
  const int kvh = h / (H / KV);
  const int q_last = min(q0 + BM, S) - 1;
  const int t_lo = (window ? max(0, q0 - window + 1) : 0) / ROWS;
  const int t_hi = ((causal ? q_last + 1 : S) + ROWS - 1) / ROWS;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(k_full(st), 1);
      mbar_init(v_full(st), 1);
      mbar_init(empty(st), CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wgi = threadIdx.x / 128;
  if (wgi == 2) {
    // ---- producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == CONSUMERS) {
      mbar_expect_tx(q_full, 4 * TILE);
      for (int half = 0; half < 2; ++half)
        for (int sl = 0; sl < SLABS; ++sl) {
          tma_load(sQ + half * TILE + sl * SLAB_BYTES, &tm_q, q_full,
                   sl * SLAB_COLS, h, q0 + ROWS * half, b);
          tma_load(sO + half * TILE + sl * SLAB_BYTES, &tm_o, q_full,
                   sl * SLAB_COLS, h, q0 + ROWS * half, b);
        }
      for (int t = t_lo; t < t_hi; ++t) {
        const int i = t - t_lo;
        const int st = i % STAGES;
        mbar_wait(empty(st), ((i / STAGES) & 1) ^ 1);
        mbar_expect_tx(k_full(st), TILE);
        for (int sl = 0; sl < SLABS; ++sl)
          tma_load(sK + st * TILE + sl * SLAB_BYTES, &tm_k, k_full(st),
                   sl * SLAB_COLS, kvh, t * ROWS, b);
        mbar_expect_tx(v_full(st), TILE);
        for (int sl = 0; sl < SLABS; ++sl)
          tma_load(sV + st * TILE + sl * SLAB_BYTES, &tm_v, v_full(st),
                   sl * SLAB_COLS, kvh, t * ROWS, b);
      }
    }
  } else {
    // ---- consumers: 64 rows a warpgroup ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int r0 = q0 + ROWS * wgi;
    const int row_a = r0 + 16 * warp + lane / 4;  // rows row_a, row_a + 8
    const int col_t = 2 * (lane % 4);
    const bool active = r0 < S;
    const int w_last = min(r0 + ROWS - 1, S - 1);
    const int w_lo = (window ? max(0, r0 - window + 1) : 0) / ROWS;
    const int w_hi = ((causal ? w_last + 1 : S) + ROWS - 1) / ROWS;
    const uint32_t sQw = sQ + wgi * TILE, sOw = sO + wgi * TILE;
    const size_t head = size_t(b) * H + h;

    // each row's lse in the log2 domain (the forward's, or lse'), and D
    float L[2], D[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row_a + 8 * r;
      if (DQ) {
        L[r] = row < S ? lse2[head * S_pad + row] : 0.f;
        D[r] = row < S ? dsum[head * S_pad + row] : 0.f;
      } else {
        L[r] = row < S ? lse[head * S + row] * LOG2E : 0.f;
        D[r] = 0.f;
      }
    }
    float acc[DQ ? ACC : 1];
#pragma unroll
    for (int e = 0; e < (DQ ? ACC : 1); ++e) acc[e] = 0.f;
    float l[2] = {0.f, 0.f}, d[2] = {0.f, 0.f};

    mbar_wait(q_full, 0);
    for (int t = t_lo; t < t_hi; ++t) {
      const int i = t - t_lo;
      const int st = i % STAGES;
      const uint32_t parity = (i / STAGES) & 1;
      const uint32_t kst = sK + st * TILE;
      mbar_wait(k_full(st), parity);
      if (active && t >= w_lo && t < w_hi) {
        float s[32], dp[32];
#pragma unroll
        for (int e = 0; e < 32; ++e) s[e] = dp[e] = 0.f;
        fence_regs(s);
        wgmma_fence();
        mma_rows<HD>(s, sQw, kst);  // S = Q . K^T
        wgmma_commit();
        mbar_wait(v_full(st), parity);
        fence_regs(dp);
        wgmma_fence();
        mma_rows<HD>(dp, sOw, sV + st * TILE);  // dP = dO . V^T
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(s);
        fence_regs(dp);

        // s[e]: row row_a + 8 ((e >> 1) & 1), key c0 + 8 (e >> 2) + col_t
        // + (e & 1)
        const int c0 = t * ROWS;
        const bool edge = c0 + ROWS > S || (causal && c0 + ROWS - 1 > r0) ||
                          (window && c0 <= r0 + ROWS - 1 - window);
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int r = (e >> 1) & 1;
          float dt;
          const float z = log2_score<SOFTCAP>(s[e], pre, post, dt);
          bool valid = true;
          if (edge) {
            const int row = row_a + 8 * r;
            const int c = c0 + 8 * (e >> 2) + col_t + (e & 1);
            valid = c < S && (!causal || c <= row) &&
                    (!window || c > row - window);
          }
          const float p = valid ? ex2(z - L[r]) : 0.f;
          if (DQ) {
            s[e] = p * (dp[e] - D[r]) * dt;
          } else {
            l[r] += p;
            d[r] = fmaf(p, dp[e], d[r]);
          }
        }
        if constexpr (DQ) {
          uint32_t dh[16], dl[16];
          pack(s, dh, dl);
          fence_regs(acc);
          fence_regs(dh);
          fence_regs(dl);
          wgmma_fence();
          mma_cols<HD>(acc, dh, dl, kst);  // dQ += dS . K
          wgmma_commit();
          wgmma_wait_all();
          fence_regs(acc);
        }
      } else {
        mbar_wait(v_full(st), parity);
      }
      mbar_arrive(empty(st));
    }

    if constexpr (DQ) {
      // acc[e]: row row_a + 8 ((e >> 1) & 1), column 8 (e >> 2) + col_t +
      // (e & 1)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row_a + 8 * r;
        if (row >= S) continue;
        __nv_bfloat16* orow =
            dq + ((size_t(b) * S + row) * H + h) * HD + col_t;
#pragma unroll
        for (int j = 0; j < HD / 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
              __floats2bfloat162_rn(acc[4 * j + 2 * r] * scale,
                                    acc[4 * j + 2 * r + 1] * scale);
      }
    } else {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        d[r] += __shfl_xor_sync(0xffffffffu, d[r], 1);
        d[r] += __shfl_xor_sync(0xffffffffu, d[r], 2);
        const int row = row_a + 8 * r;
        if (lane % 4 == 0 && row < S_pad) {
          // padded rows and rows with no valid key: P = 0 downstream
          const bool none = !(row < S && l[r] > 0.f);
          lse2[head * S_pad + row] = none ? INFINITY : L[r] + log2f(l[r]);
          dsum[head * S_pad + row] = none ? 0.f : d[r] / l[r];
        }
      }
    }
  }
}

template <int HD, bool SOFTCAP>
cudaError_t launch_softcap(const CUtensorMap& tq, const CUtensorMap& tk,
                           const CUtensorMap& tv, const CUtensorMap& to,
                           const float* lse, float* lse2, float* dsum,
                           void* dq, void* dk, void* dv, int B, int S,
                           int H, int KV, int causal, int window, float pre,
                           float post, float scale, cudaStream_t stream) {
  using P = Plan<HD>;
  const int S_pad = (S + ROWS - 1) / ROWS * ROWS;
  const dim3 q_grid((S + 2 * ROWS - 1) / (2 * ROWS) * H, B);
  auto rows = flash_bwd_wgmma_q_kernel<HD, SOFTCAP, false>;
  auto kv = flash_bwd_wgmma_kv_kernel<HD, SOFTCAP>;
  auto dqk = flash_bwd_wgmma_q_kernel<HD, SOFTCAP, true>;
  cudaError_t err = cudaFuncSetAttribute(
      rows, cudaFuncAttributeMaxDynamicSharedMemorySize, int(P::Q_SMEM));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        dqk, cudaFuncAttributeMaxDynamicSharedMemorySize, int(P::Q_SMEM));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kv, cudaFuncAttributeMaxDynamicSharedMemorySize, int(P::KV_SMEM));
  if (err != cudaSuccess) return err;
  rows<<<q_grid, THREADS, P::Q_SMEM, stream>>>(
      tq, tk, tv, to, lse, lse2, dsum, nullptr, S, S_pad, H, KV, causal,
      window, pre, post, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  kv<<<dim3((S + P::KEYS - 1) / P::KEYS * KV, B), THREADS, P::KV_SMEM,
       stream>>>(tq, tk, tv, to, lse2, dsum,
                 static_cast<__nv_bfloat16*>(dk),
                 static_cast<__nv_bfloat16*>(dv), S, S_pad, H, KV, causal,
                 window, pre, post, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dqk<<<q_grid, THREADS, P::Q_SMEM, stream>>>(
      tq, tk, tv, to, lse, lse2, dsum, static_cast<__nv_bfloat16*>(dq), S,
      S_pad, H, KV, causal, window, pre, post, scale);
  return cudaGetLastError();
}

// lse2 and dsum: float32 scratch of (B, H, S_pad), S_pad = S rounded up
// to 64.
template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, float* lse2,
                   float* dsum, void* dq, void* dk, void* dv, int B, int S,
                   int H, int KV, float scale, int causal, int window,
                   float softcap, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, to;
  cudaError_t err = wg::bind_context();
  if (err == cudaSuccess) err = wg::make_map<HD>(&tq, q, B, S, H);
  if (err == cudaSuccess) err = wg::make_map<HD>(&tk, k, B, S, KV);
  if (err == cudaSuccess) err = wg::make_map<HD>(&tv, v, B, S, KV);
  if (err == cudaSuccess) err = wg::make_map<HD>(&to, dout, B, S, H);
  if (err != cudaSuccess) return err;
  if (softcap > 0.f)
    return launch_softcap<HD, true>(tq, tk, tv, to, lse, lse2, dsum, dq, dk,
                                    dv, B, S, H, KV, causal, window,
                                    2.f * LOG2E * scale / softcap,
                                    softcap * LOG2E, scale, stream);
  return launch_softcap<HD, false>(tq, tk, tv, to, lse, lse2, dsum, dq, dk,
                                   dv, B, S, H, KV, causal, window,
                                   scale * LOG2E, 0.f, scale, stream);
}

}  // namespace bwg

enum Design { NONE = -1, SIMT = 0, WGMMA = 1 };

// dtype: 0 = float32, 1 = bfloat16.
Design design_of(int dtype, int HD) {
  if (dtype == 1 && (HD == 64 || HD == 96 || HD == 128 || HD == 256))
    return WGMMA;
  if ((dtype == 0 && (HD == 16 || HD == 128 || HD == 256)) ||
      (dtype == 1 && HD == 16))
    return SIMT;
  return NONE;
}

// The backward's designs: bf16 at 256, 128, 96 and 64 on wgmma, float32
// at 16 on simt.
Design backward_design_of(int dtype, int HD) {
  if (dtype == 1 && (HD == 64 || HD == 96 || HD == 128 || HD == 256))
    return WGMMA;
  if (dtype == 0 && HD == 16) return SIMT;
  return NONE;
}

}  // namespace

extern "C" {

// The design that serves (dtype, head_dim): 1 = wgmma, 0 = simt, -1 =
// none.  dtype: 0 = float32, 1 = bfloat16.
int flash_attention_design(int dtype, int HD) { return design_of(dtype, HD); }

// Returns a cudaError_t (0 = success).  `lse`, float32 (B, H, S), takes
// each row's log-sum-exp of its scaled (softcapped) scores, m + log l,
// where it is given (the training path's forward, for the backward); a
// null `lse` writes none (serving).
int flash_attention_forward(int dtype, const void* q, const void* k,
                            const void* v, void* o, int B, int S, int H,
                            int KV, int HD, float scale, int causal,
                            int window, float softcap, void* lse_,
                            void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* lse = static_cast<float*>(lse_);
  switch (design_of(dtype, HD)) {
    case WGMMA:
      switch (HD) {
        case 64:
          return wg::launch<64>(q, k, v, o, lse, B, S, H, KV, scale, causal,
                                window, softcap, st);
        case 96:
          return wg::launch<96>(q, k, v, o, lse, B, S, H, KV, scale, causal,
                                window, softcap, st);
        case 128:
          return wg::launch<128>(q, k, v, o, lse, B, S, H, KV, scale, causal,
                                 window, softcap, st);
        default:
          return wg::launch<256>(q, k, v, o, lse, B, S, H, KV, scale, causal,
                                 window, softcap, st);
      }
    case SIMT:
      if (dtype == 1)
        return simt::launch<__nv_bfloat16, 16>(q, k, v, o, lse, B, S, H, KV,
                                               scale, causal, window, softcap,
                                               st);
      if (HD == 16)
        return simt::launch<float, 16>(q, k, v, o, lse, B, S, H, KV, scale,
                                       causal, window, softcap, st);
      if (HD == 128)
        return simt::launch<float, 128>(q, k, v, o, lse, B, S, H, KV, scale,
                                        causal, window, softcap, st);
      return simt::launch<float, 256>(q, k, v, o, lse, B, S, H, KV, scale,
                                      causal, window, softcap, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// Dynamic shared memory of one block for (dtype, head_dim), or -1.
int flash_attention_smem_bytes(int dtype, int HD) {
  switch (design_of(dtype, HD)) {
    case WGMMA: return int(HD == 64    ? wg::Shape<64>::SMEM_BYTES
                           : HD == 96  ? wg::Shape<96>::SMEM_BYTES
                           : HD == 128 ? wg::Shape<128>::SMEM_BYTES
                                       : wg::Shape<256>::SMEM_BYTES);
    case SIMT: return int(HD == 16    ? simt::smem_bytes<16>()
                          : HD == 128 ? simt::smem_bytes<128>()
                                      : simt::smem_bytes<256>());
    default: return -1;
  }
}

// The backward's design for (dtype, head_dim): 1 = wgmma, 0 = simt, -1 =
// none.
int flash_attention_backward_design(int dtype, int HD) {
  return backward_design_of(dtype, HD);
}

// Dynamic shared memory of the dK/dV kernel's block (`which` 0) or the
// row pass's and the dQ kernel's (1) for (dtype, head_dim), or -1.
int flash_attention_backward_smem_bytes(int dtype, int HD, int which) {
  switch (backward_design_of(dtype, HD)) {
    case WGMMA:
      switch (HD) {
        case 64: return int(which ? bwg::Plan<64>::Q_SMEM
                                  : bwg::Plan<64>::KV_SMEM);
        case 96: return int(which ? bwg::Plan<96>::Q_SMEM
                                  : bwg::Plan<96>::KV_SMEM);
        case 128: return int(which ? bwg::Plan<128>::Q_SMEM
                                   : bwg::Plan<128>::KV_SMEM);
        default: return int(which ? bwg::Plan<256>::Q_SMEM
                                  : bwg::Plan<256>::KV_SMEM);
      }
    case SIMT:
      return int(which ? bwd::dq_smem_bytes<16>() : bwd::dkdv_smem_bytes<16>());
    default: return -1;
  }
}

// dQ, dK, dV (q's dtype, q's and k's shapes) of the attention the forward
// computed, from q, k, v, dO and the forward's lse (float32 (B, H, S));
// `lse_rows` and `dsum` are float32 scratch for the row pass's lse' and D,
// (B, H, S rounded up to 64) for both designs.  Three launches on `stream`;
// returns a cudaError_t (0 = success).
int flash_attention_backward(int dtype, const void* q, const void* k,
                             const void* v, const void* dout, const void* lse,
                             void* lse_rows, void* dsum, void* dq, void* dk,
                             void* dv, int B, int S, int H, int KV, int HD,
                             float scale, int causal, int window,
                             float softcap, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* lr = static_cast<float*>(lse_rows);
  float* d = static_cast<float*>(dsum);
  switch (backward_design_of(dtype, HD)) {
    case WGMMA:
      switch (HD) {
        case 64:
          return bwg::launch<64>(q, k, v, dout, l, lr, d, dq, dk, dv, B, S, H,
                                 KV, scale, causal, window, softcap, st);
        case 96:
          return bwg::launch<96>(q, k, v, dout, l, lr, d, dq, dk, dv, B, S, H,
                                 KV, scale, causal, window, softcap, st);
        case 128:
          return bwg::launch<128>(q, k, v, dout, l, lr, d, dq, dk, dv, B, S,
                                  H, KV, scale, causal, window, softcap, st);
        default:
          return bwg::launch<256>(q, k, v, dout, l, lr, d, dq, dk, dv, B, S,
                                  H, KV, scale, causal, window, softcap, st);
      }
    case SIMT:
      return bwd::launch<float, 16>(q, k, v, dout, l, lr, d, dq, dk, dv, B, S,
                                    H, KV, scale, causal, window, softcap,
                                    st);
    default:
      return cudaErrorInvalidValue;
  }
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
