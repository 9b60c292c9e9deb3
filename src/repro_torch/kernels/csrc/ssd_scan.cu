// Mamba-2 SSD intra-chunk term and its gradient for Hopper (sm_90a),
// float32:
//
//   Y[i] = sum_{j <= i} (C_i . B_j) * exp(cum_i - cum_j) * dt_j * x_j
//
// within each chunk of Q rows, per head, with B and C shared by all heads
// (ngroups 1).  Three designs, chosen explicitly by (P, N):
//
//   wgmma       (P, N) = (64, 128), mamba2-780m's widths: every launch of
//               its serving path.  Both products on the tensor cores in
//               TF32 at 3xTF32 precision.
//   wgmma_p128  (P, N) = (128, 128), jamba-1.5-large's widths: every
//               launch of its serving path.  The same kernel, a template
//               over P, walking each head's P in two 64-column passes
//               (see the last note below).
//   simt        (P, N) = (16, 16), the smoke config's widths.  fp32 FMAs
//               on the CUDA cores.
//
// Any other (P, N) is refused.  No design falls back to another.
//
// Replaces: the Pallas TPU kernel `_ssd_kernel` / `ssd_intra` in
// src/repro/kernels/ssd_scan.py, which holds a whole Q x Q tile of one
// (batch, chunk, head) in VMEM and does two MXU products.  The chunk
// states and the inter-chunk recurrence stay outside, as they do there.
//
// What bounds it on this card: per (batch, chunk) the function needs
// Q(Q+1)/2 * (2N + 2*H*P) operations (scores once, then one product per
// head) against (Q*H*P*2 + Q*H*2 + Q*N*2) * 4 bytes.  At mamba2-780m's
// widths (Q 256, H 48, P 64, N 128) that is ~32 operations per byte.  On
// the CUDA cores (67 TFLOP/s fp32) that is above the card's 20 per byte,
// so operations bound it; on the tensor cores in 3xTF32 (three TF32
// products per product, 495 TFLOP/s) the line is ~49 per byte, so bytes
// bound it (3.35 TB/s; H100 SXM data sheet, 700 W).
//
// What the wgmma design does about it:
//   * precision: one TF32 product (10-bit mantissa) misses the 1e-4 +
//     1e-4|want| float32 check by two orders of magnitude.  Every operand
//     is split as hi = tf32(v) (rounded to nearest, ties away, as cvt.rna
//     does), lo = tf32(v - hi), and each product is hi.hi + hi.lo + lo.hi
//     summed in fp32: wgmma .tf32, three instructions per k-step of 8
//     (m64n32k8 for the scores, m64n64k8 per head).  The tensor cores' sums
//     are not rounded to nearest: each instruction's sum loses about an
//     ulp of the accumulator's magnitude.  So the scores, whose 48
//     instructions ran the check to its limit in one accumulator, sum
//     each 32-column chunk's hi.hi and cross terms in accumulators of
//     their own and add those into the scores on the CUDA cores;
//   * one block is two warpgroups for (64 query rows, a group of heads,
//     batch x chunk).  Phase 1 forms the scores C_i . B_j^T once for the
//     block's heads: per 64-key tile up to the diagonal (tiles above it
//     are never visited), C and B stream through shared memory in
//     32-column chunks (128 bytes a row, the 128-byte swizzle, K-major as
//     wgmma's TF32 operands must be), split hi/lo on the way through
//     registers; each warpgroup forms 32 of the tile's keys (m64n32k8).
//     The fp32 fragments go to shared memory in the accumulator's layout,
//     where a thread of either warpgroup finds its own fragment's values;
//   * phase 2: each warpgroup takes every other head of the block, in
//     steps of 32 keys.  M_h = S * exp(cum_i - cum_j) * dt_j is formed in
//     registers from the stored fragment, masked before exp is formed
//     (above the diagonal exp overflows over a 256-row chunk, and 0 * inf
//     would be NaN), split hi/lo, and fed to the per-head product as the
//     register A operand.  The accumulator gives a thread keys {2t, 2t+1}
//     of each 8-key group; the TF32 A fragment wants k {t, t+4}.  So the
//     k order of the product is the keys permuted, k = t <- key 2t, k =
//     t + 4 <- key 2t + 1, and X_h^T is staged in that order: no shuffles;
//   * X arrives as (keys, P), P contiguous: MN-major, which TF32 wgmma does
//     not take (its transpose flags are for 16-bit types only).  Threads
//     stage X_h^T (P x keys, keys contiguous), hi and lo, through registers:
//     each holds 4 keys of one parity x 4 P and writes the 16-byte chunks
//     of 4 permuted keys; the 8 lanes of a quarter-warp hold the 8 chunks
//     of one row, so every store hits 8 distinct bank groups.  The next
//     step's X loads are issued before this step's M and products, so
//     they arrive meanwhile;
//   * occupancy: a block of one warpgroup (8 warps an SM) left loads,
//     staging, barriers and product chains each exposed (0.32 ms at
//     engine D's shape, H100 SXM at 700 W); a second warpgroup sharing the
//     scores doubles the warps at the same shared memory, 32 KB of
//     operands plus 16 KB of scores per key tile (97.5 KB at Q 256): two
//     blocks, 16 warps an SM, at 128 registers a thread;
//   * Q is a runtime value (the model's chunk, or a prompt shorter than
//     it); rows at or beyond Q are zero on load and not written.  Up to
//     12 key tiles (Q <= 768) fit;
//   * the heaviest (latest) query tiles of every (batch, chunk, head
//     group) are scheduled first; the head group shrinks (16, 8, 4) when
//     the grid would not give each SM two blocks.
//
// The wgmma_p128 design (P 128): what doubles at P = 128 is each head's
// accumulator (64 registers a thread), each 32-key step's X_h^T staging
// (32 KB of hi + lo a warpgroup) and the bytes.  Two ways were open: one
// m64n128k8 product a k-step, or two passes over the head's P of 64
// columns each.  The first holds 64 accumulator registers beside M's 32
// (hi and lo) and the 16 of the next step's X loads: past the 128
// registers that two blocks an SM allow, so one block of 8 warps an SM,
// the occupancy that left loads, barriers and product chains exposed
// above, and 64 KB of staging beside the scores.  The passes keep the P 64
// design's registers (128 a thread), its 97.5 KB of shared memory at Q 256
// and its two blocks an SM; a pass is a unit of phase 2 as a head was
// (the two warpgroups take alternate passes, so each takes one half of
// every head).  The scores are still formed once per (query tile, head
// group, batch x chunk) and read by both passes; what the second pass
// repeats is M (the exp and the split, on the CUDA cores) and the reads
// of the scores from shared memory.  X is read once and Y written once.
// It is not the P 64 design over 2H heads: that would form the scores of
// every head group twice.  ptxas (-Xptxas -v, sm_90a) gives it 128
// registers a thread with 36 B of spill stores and 48 B of spill loads
// (the P 64 instance: 24 and 40 B); its dynamic shared memory is the P 64
// design's, 99,840 B a block at Q 256 (1 KB of alignment, 32 KB of
// staging, 16 KB a key tile of scores, 512 B of cum and dt), so two
// blocks an SM.
//
// Its bound at jamba-1.5-large's 8,000-token prompt (B 1, NC 32, Q 256,
// H 128, P 128, N 128): x in and y out are 1.07 GB, 0.32 ms at 3.35
// TB/s; the operations, Q(Q+1)/2 (2N + 2HP) a chunk, are 3.48e10, or
// 1.04e11 in 3xTF32, 0.21 ms at 495 TFLOP/s.  So bytes bound it, as at
// P 64.
//
// The simt design: one block per (64 query rows, 4 heads, batch x chunk)
// and 256 threads each owning 4 x 4 scores and 4 x (P/16) outputs per
// head; tiles in shared memory as fp32 with an odd row stride; the score
// tile formed once per key tile for the block's 4 heads.
//
// The backward (namespace bwd): the gradient of this function, which the
// reference takes by jax.grad of its plain jnp (it has no backward
// kernel).  With S = C . B^T, E_ij = exp(cum_i - cum_j) and M = S E dt_j
// masked to j <= i, G_ij = dY_i . X_j (per head), T = G M:
//
//   dX_j = sum_i M_ij dY_i          ddt_j = sum_i G_ij S_ij E_ij
//   dS_ij = sum_h G_ij E_ij dt_j    dC = dS . B,  dB = dS^T . C
//   dcum_k = sum_j T_kj - sum_i T_ik   (the decay's two ends)
//
// with dS summed over the heads (B and C are shared).  One design, a
// template over (P, N), at the three (P, N) the forward serves (simt_p64,
// simt_p128, simt); Q up to 768 at each; anything else refused.
//
// What bounds it on this card: per (batch, chunk) it needs Q(Q+1)/2 (6N +
// 4HP) operations (the scores again, dC and dB; G and dX per head), about
// 6.9 GFLOP at mamba2-780m's training shape (B 4, NC 4, Q 256, H 48, P 64,
// N 128), 0.10 ms on the CUDA cores at 67 TFLOP/s, against x, dy and dx of
// 50 MB each (0.05 ms for all bytes at 3.35 TB/s): operations bound it.
//
// What the design does about it: it is a straightforward one on the fp32
// CUDA cores (tensor cores at 3xTF32 come next), deterministic without
// atomics, in three launches:
//   1. the scores of every tile on or below the diagonal into a workspace
//      (4 MB at the training shape), once rather than once a head group;
//   2. a block a (64-key tile, group of 8 heads, batch x chunk), walking
//      each head and, inside, every query tile from the diagonal down: G
//      and dX_j in 4 x 4 and 4 x P/16 register tiles over odd-stride
//      shared memory, E formed only below the diagonal (above it exp
//      overflows over a 256-row chunk: the gradient of the masked
//      function is what is wanted, and 0 * inf would be NaN).  dX_j, ddt_j
//      and T's column sums (= dt_j ddt_j) are the block's own; T's row
//      sums go to the key tile's slot and G E dt_j, summed over the
//      group's heads by each thread on its own elements, to the group's
//      slot of a partial dS;
//   3. a block a (tile, role, batch x chunk): the partials of dS summed
//      in group order, then dC of a query tile (and dcum's row sums over
//      the key tiles, in order) or dB of a key tile.
// Every sum has a fixed order, so two launches give the same bits (the
// training launcher's restart replay depends on it).
//
// Plain C interface, loaded with ctypes; it returns the cudaError_t of
// the launch and never synchronises.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

// ---------------------------------------------------------------------------
// simt design (the smoke widths)
// ---------------------------------------------------------------------------
namespace simt {

constexpr int BQ = 64;   // query rows per block
constexpr int BK = 64;   // key rows per tile
constexpr int NT = 256;  // threads per block: 16 x 16
constexpr int HG = 4;    // heads per block, sharing one score tile

template <int P, int N>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (size_t(BQ) * (N + 1) + size_t(BK) * (N + 1) +  // C, B tiles
          size_t(BQ) * (BK + 1) +                        // M = masked weights
          size_t(BK) * P +                               // x tile
          size_t(HG) * (BQ + 2 * BK));                   // cum_i, cum_j, dt_j
}

// Copy rows [row0, row0 + 64) of a (rows, W) float array with row stride
// `stride` into shared memory with row stride `ds`; rows at or beyond
// `rows` are zero.  W is a multiple of 4 and rows are 16-byte aligned.
template <int W>
__device__ __forceinline__ void load_rows(float* dst, int ds,
                                          const float* src, size_t stride,
                                          int row0, int rows) {
  constexpr int PER_ROW = W / 4;
  for (int i = threadIdx.x; i < 64 * PER_ROW; i += NT) {
    const int r = i / PER_ROW;
    const int d = (i % PER_ROW) * 4;
    const int gr = row0 + r;
    const float4 v =
        gr < rows ? *reinterpret_cast<const float4*>(src + gr * stride + d)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    float* o = dst + r * ds + d;
    o[0] = v.x;
    o[1] = v.y;
    o[2] = v.z;
    o[3] = v.w;
  }
}

// x, y: (B, NC, Q, H, P); dt, cum: (B, NC, Q, H); b, c: (B, NC, Q, N); all
// contiguous float32.  grid: (ceil(Q / BQ), ceil(H / HG), B * NC).
template <int P, int N>
__global__ void __launch_bounds__(NT)
    ssd_simt_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ cum,
                    const float* __restrict__ bm,
                    const float* __restrict__ cm, float* __restrict__ y,
                    int Q, int H) {
  constexpr int RS = N + 1;  // odd row stride: conflict-free B row reads
  constexpr int MS = BK + 1;
  constexpr int NJ = P / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* sC = smem;                 // BQ x RS
  float* sB = sC + BQ * RS;         // BK x RS
  float* sM = sB + BK * RS;         // BQ x MS
  float* sX = sM + BQ * MS;         // BK x P
  float* sCumQ = sX + BK * P;       // HG x BQ
  float* sCumK = sCumQ + HG * BQ;   // HG x BK
  float* sDt = sCumK + HG * BK;     // HG x BK

  const int tx = threadIdx.x & 15;  // column group: columns tx + 16 j
  const int ty = threadIdx.x >> 4;  // row group: rows ty + 16 i
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h0 = blockIdx.y * HG;
  const size_t bc = blockIdx.z;
  const float* cb = cm + bc * Q * N;
  const float* bb = bm + bc * Q * N;
  const float* xb = x + bc * Q * H * P;
  const float* dtb = dt + bc * Q * H;
  const float* cumb = cum + bc * Q * H;
  float* yb = y + bc * Q * H * P;

  load_rows<N>(sC, RS, cb, N, q0, Q);
  for (int i = threadIdx.x; i < HG * BQ; i += NT) {
    const int r = q0 + i % BQ, h = h0 + i / BQ;
    sCumQ[i] = (r < Q && h < H) ? cumb[size_t(r) * H + h] : 0.f;
  }

  float acc[HG][4][NJ];
#pragma unroll
  for (int g = 0; g < HG; ++g)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[g][i][j] = 0.f;

  const int n_tiles = (min(q0 + BQ, Q) - 1) / BK + 1;  // up to the diagonal
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile is done with sB, sCumK, sDt
    load_rows<N>(sB, RS, bb, N, k0, Q);
    for (int i = threadIdx.x; i < HG * BK; i += NT) {
      const int r = k0 + i % BK, h = h0 + i / BK;
      const bool ok = r < Q && h < H;
      sCumK[i] = ok ? cumb[size_t(r) * H + h] : 0.f;
      sDt[i] = ok ? dtb[size_t(r) * H + h] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < N; ++d) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sC[(ty + 16 * i) * RS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = sB[(tx + 16 * j) * RS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }

#pragma unroll
    for (int g = 0; g < HG; ++g) {
      if (h0 + g >= H) break;  // the same for every thread of the block
      // M[i][j] = s * exp(cum_i - cum_j) * dt_j for j <= i < Q, else 0;
      // the mask is tested before exp is formed.
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = q0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = k0 + tx + 16 * j;
          float m = 0.f;
          if (c <= r && r < Q)
            m = s[i][j] *
                expf(sCumQ[g * BQ + ty + 16 * i] - sCumK[g * BK + tx + 16 * j]) *
                sDt[g * BK + tx + 16 * j];
          sM[(ty + 16 * i) * MS + tx + 16 * j] = m;
        }
      }
      load_rows<P>(sX, P, xb + size_t(h0 + g) * P, size_t(H) * P, k0, Q);
      __syncthreads();
#pragma unroll 4
      for (int c = 0; c < BK; ++c) {
        float p[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) p[i] = sM[(ty + 16 * i) * MS + c];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float xv = sX[c * P + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            acc[g][i][j] = fmaf(p[i], xv, acc[g][i][j]);
        }
      }
      __syncthreads();  // the next head overwrites sM and sX
    }
  }

#pragma unroll
  for (int g = 0; g < HG; ++g) {
    const int h = h0 + g;
    if (h >= H) break;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty + 16 * i;
      if (r >= Q) continue;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        yb[(size_t(r) * H + h) * P + tx + 16 * j] = acc[g][i][j];
    }
  }
}

template <int P, int N>
cudaError_t launch(const void* x, const void* dt, const void* cum,
                   const void* b, const void* c, void* y, int B, int NC,
                   int Q, int H, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<P, N>();
  auto kernel = ssd_simt_kernel<P, N>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((Q + BQ - 1) / BQ, (H + HG - 1) / HG, B * NC);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(cum), static_cast<const float*>(b),
      static_cast<const float*>(c), static_cast<float*>(y), Q, H);
  return cudaGetLastError();
}

}  // namespace simt

// ---------------------------------------------------------------------------
// wgmma designs (P 64 and P 128, N 128)
// ---------------------------------------------------------------------------
namespace wg {

constexpr int PH = 64;                  // P columns a pass: the product's N
constexpr int N = 128;
constexpr int BQ = 64;                  // query rows per block: wgmma's M
constexpr int BK = 64;                  // keys per tile
constexpr int NT = 256;                 // two warpgroups
constexpr int KC = 32;                  // state columns per staged chunk
constexpr int SLAB = 64 * 128;          // 64 rows x 128 bytes, one swizzle span
constexpr int OPS_BYTES = 4 * SLAB;     // phase 1: C, B hi/lo; 2: X^T hi/lo x 2
constexpr int S_TILE_BYTES = 32 * 128 * 4;  // one score tile's fragments
constexpr int MAX_TILES = 12;           // Q <= 768
constexpr int SMALL_BYTES = 2 * 64 * 4;    // cum_j, dt_j of each group's step

size_t smem_bytes(int Q) {
  const int tiles = (Q + BK - 1) / BK;
  return 1024 + OPS_BYTES + size_t(tiles) * S_TILE_BYTES + SMALL_BYTES;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// v as TF32, rounded to nearest with ties away from zero (what
// cvt.rna.tf32.f32 gives, in two integer operations): the low 13 bits
// zero.  v is finite here.
__device__ __forceinline__ uint32_t tf32(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;
}

// v = hi + lo to ~2^-22 of v: hi = tf32(v), lo = tf32(v - hi).
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32(v);
  lo = tf32(v - __uint_as_float(hi));
}

__device__ __forceinline__ void st_split(uint32_t hi_addr, uint32_t lo_addr,
                                         float a, float b, float c, float d) {
  uint32_t h0, h1, h2, h3, l0, l1, l2, l3;
  split(a, h0, l0);
  split(b, h1, l1);
  split(c, h2, l2);
  split(d, h3, l3);
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(hi_addr),
               "r"(h0), "r"(h1), "r"(h2), "r"(h3)
               : "memory");
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(lo_addr),
               "r"(l0), "r"(l1), "r"(l2), "r"(l3)
               : "memory");
}

// Byte offset of 16-byte chunk `c` (0..7) of row `r` in a slab of 128-byte
// rows with the 128-byte swizzle (slab 1024-byte aligned).
__device__ __forceinline__ uint32_t sw128(int r, int c) {
  return uint32_t(r * 128 + ((c ^ (r & 7)) << 4));
}

// Writes by threads become visible to wgmma (the async proxy).
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The 128 threads of warpgroup `wgi` meet (barrier 0 is the block's).
__device__ __forceinline__ void wg_sync(int wgi) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wgi) : "memory");
}

// K-major shared-memory matrix descriptor with the 128-byte swizzle: start
// address, leading and stride byte offsets (in 16-byte units).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(16 >> 4) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
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

// Keep the compiler from moving reads or writes of registers across the
// asynchronous products.
template <int M>
__device__ __forceinline__ void fence_regs(float (&d)[M]) {
#pragma unroll
  for (int i = 0; i < M; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int M>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[M]) {
#pragma unroll
  for (int i = 0; i < M; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

#define F8(a, i)                                                         \
  "+f"(a[i]), "+f"(a[i + 1]), "+f"(a[i + 2]), "+f"(a[i + 3]),            \
      "+f"(a[i + 4]), "+f"(a[i + 5]), "+f"(a[i + 6]), "+f"(a[i + 7])

// d (64 x 32, fp32) (+)= A (64 x 8) . B (8 x 32), both TF32 K-major in
// shared memory.
__device__ __forceinline__ void mma_ss(float (&d)[16], uint64_t da,
                                       uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %18, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1;\n}\n"
      : F8(d, 0), F8(d, 8)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64, fp32) += A (64 x 8, TF32 in registers) . B (8 x 64, TF32
// K-major in shared memory).
__device__ __forceinline__ void mma_rs(float (&d)[32], uint32_t a0,
                                       uint32_t a1, uint32_t a2, uint32_t a3,
                                       uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : F8(d, 0), F8(d, 8), F8(d, 16), F8(d, 24)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

#undef F8

// Rows [row0, row0 + 64) x state columns [col0, col0 + 32) of a (rows, N)
// array into a slab, hi and lo; rows at or beyond Q are zero.  Eight
// threads take one row's eight 16-byte chunks: distinct banks.
__device__ __forceinline__ void stage_rows(uint32_t hi, uint32_t lo,
                                           const float* src, int row0,
                                           int col0, int Q) {
#pragma unroll
  for (int it = 0; it < 64 * 8 / NT; ++it) {
    const int i = threadIdx.x + it * NT;
    const int r = i / 8, c = i % 8;
    const int gr = row0 + r;
    const float4 v =
        gr < Q ? *reinterpret_cast<const float4*>(src + size_t(gr) * N +
                                                  col0 + 4 * c)
               : make_float4(0.f, 0.f, 0.f, 0.f);
    const uint32_t off = sw128(r, c);
    st_split(hi + off, lo + off, v.x, v.y, v.z, v.w);
  }
}

// A step of phase 2 is 32 keys [k0, k0 + 32) of one head's pass, the 64
// P columns from c0 of rows XP long.  This thread (of its warpgroup's 128)
// loads X keys k0 + 8 g8 + 2 m + par (m < 4) at P columns c0 + 4 pq ..
// c0 + 4 pq + 3, and (threads < 64) cum or dt of key k0 + tid % 32.  Keys
// at or beyond Q are zero.
template <int XP>
__device__ __forceinline__ void load_step(float4 (&v)[4], float& side,
                                          const float* xb, const float* cumb,
                                          const float* dtb, int h, int c0,
                                          int k0, int H, int Q, int g8,
                                          int par, int pq, int tid) {
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int key = k0 + 8 * g8 + 2 * m + par;
    v[m] = key < Q ? *reinterpret_cast<const float4*>(
                         xb + (size_t(key) * H + h) * XP + c0 + 4 * pq)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const int key = k0 + tid % 32;
  side = tid < 64 && key < Q ? (tid < 32 ? cumb : dtb)[size_t(key) * H + h]
                             : 0.f;
}

// The step into its stage: X^T (64 P rows x 32 keys, one slab, hi then
// lo) with key 2 m + par of each 8-key group at position 4 par + m, and
// cum, dt of its keys (small[0..31], small[32..63]).  The 8 lanes of a
// quarter-warp hold the 8 (g8, par) pairs of one pq, so each store's 16
// bytes land in 8 distinct bank groups.
__device__ __forceinline__ void store_step(uint32_t stage, float* small,
                                           const float4 (&v)[4], float side,
                                           int g8, int par, int pq, int tid) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = 4 * pq + i;
    const uint32_t off = sw128(p, 2 * g8 + par);
    const float a = i == 0 ? v[0].x : i == 1 ? v[0].y : i == 2 ? v[0].z
                                                               : v[0].w;
    const float b = i == 0 ? v[1].x : i == 1 ? v[1].y : i == 2 ? v[1].z
                                                               : v[1].w;
    const float c = i == 0 ? v[2].x : i == 1 ? v[2].y : i == 2 ? v[2].z
                                                               : v[2].w;
    const float d = i == 0 ? v[3].x : i == 1 ? v[3].y : i == 2 ? v[3].z
                                                               : v[3].w;
    st_split(stage + off, stage + SLAB + off, a, b, c, d);
  }
  if (tid < 64) small[tid] = side;
}

// x, y: (B, NC, Q, H, XP); dt, cum: (B, NC, Q, H); b, c: (B, NC, Q, 128);
// all contiguous float32.  grid: ceil(Q / BQ) * n_groups * B * NC blocks,
// the latest query tiles first; head group g holds heads [g hg, g hg + hg).
// Phase 2 walks the group's passes, a pass being one head's 64 P columns
// (XP / 64 passes a head), and warpgroup w takes every other pass from
// the group's first plus w.
template <int XP>
__global__ void __launch_bounds__(NT, 2)
    ssd_wgmma_kernel(const float* __restrict__ x,
                     const float* __restrict__ dt,
                     const float* __restrict__ cum,
                     const float* __restrict__ bm,
                     const float* __restrict__ cm, float* __restrict__ y,
                     int Q, int H, int hg, int BNC) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t ops = smem_u32(base);           // 4 slabs, 1024-aligned
  float* sS = reinterpret_cast<float*>(base + OPS_BYTES);
  const int n_qt = (Q + BQ - 1) / BQ;
  float* sSmall = sS + size_t(n_qt) * (S_TILE_BYTES / 4);  // 2 x 64

  const int n_groups = (H + hg - 1) / hg;
  const int rest = n_groups * BNC;
  const int q0 = (n_qt - 1 - int(blockIdx.x) / rest) * BQ;
  const int grp = int(blockIdx.x) % rest % n_groups;
  const size_t bc = size_t(blockIdx.x) % rest / n_groups;
  const int h0 = grp * hg;
  const int h1 = min(H, h0 + hg);
  const float* cb = cm + bc * Q * N;
  const float* bb = bm + bc * Q * N;
  const float* xb = x + bc * Q * H * XP;
  const float* dtb = dt + bc * Q * H;
  const float* cumb = cum + bc * Q * H;
  float* yb = y + bc * Q * H * XP;

  const int wgi = threadIdx.x / 128;             // warpgroup
  const int tid = threadIdx.x % 128;             // thread in it
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int row_a = q0 + 16 * warp + lane / 4;  // rows row_a, row_a + 8
  const int tq = lane % 4;
  const int n_tiles = (min(q0 + BQ, Q) - 1) / BK + 1;  // up to the diagonal

  // ---- phase 1: scores S = C . B^T of every key tile, once ----
  // Warpgroup w forms keys 32 w .. 32 w + 31 of each tile: its 64 x 32
  // fragment goes to sS[tile][w][register][thread], where a thread of
  // either warpgroup finds its own fragment's values in phase 2.
  {
    const uint32_t cHi = ops, cLo = ops + SLAB, bHi = ops + 2 * SLAB,
                   bLo = ops + 3 * SLAB;
    const uint32_t bw = wgi * 32 * 128;  // this group's 32 keys of B
    for (int t = 0; t < n_tiles; ++t) {
      float s[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) s[e] = 0.f;
      for (int kc = 0; kc < N / KC; ++kc) {
        __syncthreads();  // the last products are done with the slabs
        stage_rows(cHi, cLo, cb, q0, kc * KC, Q);
        stage_rows(bHi, bLo, bb, t * BK, kc * KC, Q);
        fence_async_smem();
        __syncthreads();
        // hi.hi and the two cross terms in accumulators of their own,
        // fresh for each chunk, summed into s in fp32 (see the note)
        float big[16], small[16];
#pragma unroll
        for (int e = 0; e < 16; ++e) big[e] = small[e] = 0.f;
        fence_regs(big);
        fence_regs(small);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KC / 8; ++kk) {
          const uint32_t off = kk * 32;
          const uint64_t ch = sw128_desc(cHi + off), cl = sw128_desc(cLo + off),
                         bh = sw128_desc(bHi + bw + off),
                         bl = sw128_desc(bLo + bw + off);
          mma_ss(big, ch, bh, kk > 0);
          mma_ss(small, ch, bl, kk > 0);
          mma_ss(small, cl, bh, 1);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(big);
        fence_regs(small);
#pragma unroll
        for (int e = 0; e < 16; ++e) s[e] = s[e] + big[e] + small[e];
      }
      // s[e]: row row_a + 8 ((e >> 1) & 1), key t BK + 32 wgi + 8 (e >> 2)
      // + 2 tq + (e & 1)
#pragma unroll
      for (int e = 0; e < 16; ++e)
        sS[((t * 2 + wgi) * 16 + e) * 128 + tid] = s[e];
    }
  }
  __syncthreads();  // every score stored; the slabs are free

  // ---- phase 2: per pass, Y_h = M_h . X_h, 32 keys a step ----
  // Each warpgroup runs its own passes through its own stage (16 KB of the
  // slabs) and its own barrier; the next step's X loads are issued before
  // this step's M and products, so they arrive meanwhile.
  constexpr int NPASS = XP / PH;  // passes a head
  const uint32_t stage = ops + wgi * 2 * SLAB;
  float* small = sSmall + wgi * 64;
  const int g8 = (lane % 8) / 2, par = lane % 2, pq = lane / 8 + 4 * warp;
  const int sph = 2 * n_tiles;  // steps per pass
  for (int u = h0 * NPASS + wgi; u < h1 * NPASS; u += 2) {
    const int h = u / NPASS, c0 = (u % NPASS) * PH;
    float acc[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[e] = 0.f;
    float cum_r[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row_a + 8 * r;
      cum_r[r] = row < Q ? cumb[size_t(row) * H + h] : 0.f;
    }
    float4 v[4];
    float side;
    load_step<XP>(v, side, xb, cumb, dtb, h, c0, 0, H, Q, g8, par, pq,
                  tid);
    for (int st = 0; st < sph; ++st) {
      const int t = st / 2, half = st % 2;
      wg_sync(wgi);  // the last products are done with the stage
      store_step(stage, small, v, side, g8, par, pq, tid);
      fence_async_smem();
      wg_sync(wgi);
      if (st + 1 < sph)
        load_step<XP>(v, side, xb, cumb, dtb, h, c0, (st + 1) * 32, H, Q, g8,
                      par, pq, tid);
      // M in the accumulator layout of the step's 32 keys, masked before
      // exp is formed, as hi + lo
      uint32_t mh[16], ml[16];
      const float* s_frag = sS + size_t(st) * 16 * 128 + tid;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int r = (i >> 1) & 1;
        const int row = row_a + 8 * r;
        const int kh = 8 * (i >> 2) + 2 * tq + (i & 1);  // key in the step
        float m = 0.f;
        if (t * BK + 32 * half + kh <= row && row < Q)
          m = s_frag[i * 128] * expf(cum_r[r] - small[kh]) * small[32 + kh];
        split(m, mh[i], ml[i]);
      }
      fence_regs(mh);
      fence_regs(ml);
      wgmma_fence();
      // k-step jj: keys 8 jj .. 8 jj + 7 of the step in the permuted
      // order; the A fragment (rows g, g + 8; k t, t + 4) is (e0, e2, e1,
      // e3) of the accumulator's group jj
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int i = 4 * jj;
        const uint64_t dh = sw128_desc(stage + jj * 32),
                       dl = sw128_desc(stage + SLAB + jj * 32);
        mma_rs(acc, mh[i], mh[i + 2], mh[i + 1], mh[i + 3], dh);
        mma_rs(acc, mh[i], mh[i + 2], mh[i + 1], mh[i + 3], dl);
        mma_rs(acc, ml[i], ml[i + 2], ml[i + 1], ml[i + 3], dh);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(mh);
      fence_regs(ml);
    }
    fence_regs(acc);
    // acc[e]: row row_a + 8 ((e >> 1) & 1), column 8 (e >> 2) + 2 tq +
    // (e & 1)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row_a + 8 * r;
      if (row >= Q) continue;
      float* out = yb + (size_t(row) * H + h) * XP + c0 + 2 * tq;
#pragma unroll
      for (int j = 0; j < PH / 8; ++j)
        *reinterpret_cast<float2*>(out + 8 * j) =
            make_float2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
    }
  }
}

// Heads per block: the largest of 16, 8, 4 that still gives every SM two
// blocks; scores are formed once per block, so larger groups repeat them
// less.
int head_group(int blocks_per_group, int H) {
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      sms = 132;
  }
  for (int hg = 16; hg > 4; hg /= 2)
    if (blocks_per_group * ((H + hg - 1) / hg) >= 2 * sms) return hg;
  return 4;
}

template <int XP>
cudaError_t launch(const void* x, const void* dt, const void* cum,
                   const void* b, const void* c, void* y, int B, int NC,
                   int Q, int H, cudaStream_t stream) {
  if (Q > MAX_TILES * BK) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(Q);
  auto kernel = ssd_wgmma_kernel<XP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const int n_qt = (Q + BQ - 1) / BQ;
  const int hg = head_group(n_qt * B * NC, H);
  const long long blocks =
      (long long)n_qt * ((H + hg - 1) / hg) * B * NC;
  if (blocks > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  kernel<<<unsigned(blocks), NT, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(cum), static_cast<const float*>(b),
      static_cast<const float*>(c), static_cast<float*>(y), Q, H, hg,
      B * NC);
  return cudaGetLastError();
}

}  // namespace wg

// ---------------------------------------------------------------------------
// backward (every (P, N) the forward serves): fp32 CUDA cores
// ---------------------------------------------------------------------------
namespace bwd {

constexpr int BT = 64;        // rows (queries or keys) a tile
constexpr int NT = 256;       // threads: 16 x 16, each 4 x 4 of a tile
constexpr int HG = 8;         // heads a block of the head pass
constexpr int MAX_Q = 768;    // the forward's wgmma bound, for every design
constexpr int MS = BT + 1;    // odd row stride of a 64 x 64 tile

// The workspace, in floats: the scores S (BC, Qp, Qp), the head groups'
// partial dS (G, BC, Qp, Qp) and each key tile's row sums of T (nt, BC,
// Qp, H), Qp = 64 nt.  Only tiles on or below the diagonal are written
// and read.
struct Work {
  size_t s, ds, row, total;
  __host__ __device__ Work(int BC, int Q, int H) {
    const size_t nt = (Q + BT - 1) / BT, qp = nt * BT;
    const size_t groups = (H + HG - 1) / HG;
    s = 0;
    ds = size_t(BC) * qp * qp;
    row = ds + groups * BC * qp * qp;
    total = row + nt * BC * qp * H;
  }
};

template <int N>
constexpr size_t scores_smem() { return sizeof(float) * 2 * BT * (N + 1); }
template <int P>
constexpr size_t heads_smem() {
  return sizeof(float) * (2 * BT * (P + 1) + BT * MS + 3 * BT + 16 * BT);
}
template <int N>
constexpr size_t reduce_smem() { return sizeof(float) * (BT * MS + BT * (N + 1)); }

// Launch 1: S = C . B^T of every tile (it, jt) with jt <= it.  grid:
// (nt * nt, BC); the tiles above the diagonal return at once.
template <int N>
__global__ void __launch_bounds__(NT)
    ssd_bwd_scores(const float* __restrict__ bm, const float* __restrict__ cm,
                   float* __restrict__ work, int Q) {
  constexpr int RS = N + 1;
  const int nt = (Q + BT - 1) / BT, qp = nt * BT;
  const int it = blockIdx.x / nt, jt = blockIdx.x % nt;
  if (jt > it) return;
  extern __shared__ float smem[];
  float* sC = smem;
  float* sB = sC + BT * RS;
  const size_t bc = blockIdx.y;
  simt::load_rows<N>(sC, RS, cm + bc * Q * N, N, it * BT, Q);
  simt::load_rows<N>(sB, RS, bm + bc * Q * N, N, jt * BT, Q);
  __syncthreads();
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float s[4][4] = {};
#pragma unroll 8
  for (int d = 0; d < N; ++d) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = sC[(ty + 16 * i) * RS + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = sB[(tx + 16 * j) * RS + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
  }
  float* out = work + bc * qp * qp;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      out[size_t(it * BT + ty + 16 * i) * qp + jt * BT + tx + 16 * j] =
          s[i][j];
}

// Launch 2: per key tile jt and head h of a group, over every query tile
// it >= jt: G = dY_i . X_j^T, then (masked, exp formed only below the
// diagonal) E, M = S E dt_j, T = G M; dX_j += M^T dY_i, ddt_j += column
// sums of G S E, T's row sums into the key tile's slot of the workspace,
// and G E dt_j summed over the group's heads into its partial dS (each
// thread reads, adds and writes back its own 16 elements: no other thread
// touches them).  T's column sums are dt_j ddt_j, so dcum_j starts at
// -dt_j ddt_j; launch 3 adds the row sums.  grid: nt * BC * G blocks, the
// key tiles with the most query tiles first.
template <int P>
__global__ void __launch_bounds__(NT)
    ssd_bwd_heads(const float* __restrict__ x, const float* __restrict__ dt,
                  const float* __restrict__ cum,
                  const float* __restrict__ dy, float* __restrict__ work,
                  float* __restrict__ dx, float* __restrict__ ddt,
                  float* __restrict__ dcum, int Q, int H, int BC) {
  constexpr int RS = P + 1;
  constexpr int NJ = P / 16;
  const int nt = (Q + BT - 1) / BT, qp = nt * BT;
  const int groups = (H + HG - 1) / HG;
  const int g = blockIdx.x % groups;
  const size_t bc = blockIdx.x / groups % BC;
  const int jt = blockIdx.x / groups / BC;
  const int h0 = g * HG, h1 = min(H, h0 + HG);
  const int k0 = jt * BT;
  const Work w(BC, Q, H);
  const float* S = work + w.s + bc * qp * qp;
  float* DS = work + w.ds + (size_t(g) * BC + bc) * qp * qp;
  float* ROW = work + w.row + (size_t(jt) * BC + bc) * qp * H;

  extern __shared__ float smem[];
  float* sX = smem;               // BT x RS: X_j of head h
  float* sDy = sX + BT * RS;      // BT x RS: dY_i of head h
  float* sM = sDy + BT * RS;      // BT x MS: M (query rows, key columns)
  float* sCumK = sM + BT * MS;    // BT
  float* sDt = sCumK + BT;        // BT
  float* sCumQ = sDt + BT;        // BT
  float* sRed = sCumQ + BT;       // 16 x BT: column sums, one row a ty

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const size_t xs = size_t(H) * P;
  const float* xb = x + bc * Q * xs;
  const float* dyb = dy + bc * Q * xs;
  const float* dtb = dt + bc * Q * H;
  const float* cumb = cum + bc * Q * H;

  for (int h = h0; h < h1; ++h) {
    __syncthreads();  // the last head is done with sX, sCumK, sDt, sRed
    simt::load_rows<P>(sX, RS, xb + size_t(h) * P, xs, k0, Q);
    for (int i = threadIdx.x; i < BT; i += NT) {
      const int r = k0 + i;
      sCumK[i] = r < Q ? cumb[size_t(r) * H + h] : 0.f;
      sDt[i] = r < Q ? dtb[size_t(r) * H + h] : 0.f;
    }
    float acc[4][NJ] = {};
    float col[4] = {};
    for (int it = jt; it < nt; ++it) {
      const int q0 = it * BT;
      __syncthreads();  // the last query tile is done with sDy, sM, sCumQ
      simt::load_rows<P>(sDy, RS, dyb + size_t(h) * P, xs, q0, Q);
      for (int i = threadIdx.x; i < BT; i += NT) {
        const int r = q0 + i;
        sCumQ[i] = r < Q ? cumb[size_t(r) * H + h] : 0.f;
      }
      __syncthreads();
      float gm[4][4] = {};
#pragma unroll 8
      for (int p = 0; p < P; ++p) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = sDy[(ty + 16 * i) * RS + p];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = sX[(tx + 16 * j) * RS + p];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) gm[i][j] = fmaf(a[i], b[j], gm[i][j]);
      }
      float row[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = q0 + ty + 16 * i;
        row[i] = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = k0 + tx + 16 * j;
          float m = 0.f, ed = 0.f;
          if (c <= r && r < Q) {  // the mask, tested before exp is formed
            const float e = expf(sCumQ[ty + 16 * i] - sCumK[tx + 16 * j]);
            const float se = S[size_t(r) * qp + c] * e;
            ed = e * sDt[tx + 16 * j];
            m = se * sDt[tx + 16 * j];
            col[j] = fmaf(gm[i][j], se, col[j]);
          }
          row[i] = fmaf(gm[i][j], m, row[i]);
          float* ds = DS + size_t(r) * qp + c;
          *ds = h == h0 ? gm[i][j] * ed : fmaf(gm[i][j], ed, *ds);
          sM[(ty + 16 * i) * MS + tx + 16 * j] = m;
        }
      }
      // T's row sums over the 16 threads of a half-warp (one ty), in a
      // fixed order
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int o = 8; o > 0; o >>= 1)
          row[i] += __shfl_xor_sync(0xffffffffu, row[i], o);
        if (tx == 0) ROW[size_t(q0 + ty + 16 * i) * H + h] = row[i];
      }
      __syncthreads();  // sM complete
      // dX_j[key][p] += sum_r M[r][key] dY_i[r][p]: keys ty + 16 i,
      // columns tx + 16 j
#pragma unroll 4
      for (int r = 0; r < BT; ++r) {
        float m[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) m[i] = sM[r * MS + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float v = sDy[r * RS + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(m[i], v, acc[i][j]);
        }
      }
    }
    // ddt_j: the column sums over the 16 row groups, in a fixed order
#pragma unroll
    for (int j = 0; j < 4; ++j) sRed[ty * BT + tx + 16 * j] = col[j];
    __syncthreads();
    if (threadIdx.x < BT) {
      const int c = k0 + threadIdx.x;
      float s = 0.f;
      for (int t = 0; t < 16; ++t) s += sRed[t * BT + threadIdx.x];
      if (c < Q) {
        ddt[(bc * Q + c) * H + h] = s;
        dcum[(bc * Q + c) * H + h] = -sDt[threadIdx.x] * s;
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = k0 + ty + 16 * i;
      if (c >= Q) continue;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        dx[(bc * Q + c) * xs + size_t(h) * P + tx + 16 * j] = acc[i][j];
    }
  }
}

// Launch 3: dS = the head groups' partials summed in group order; blocks
// (t, 0) form dC_i = sum_{j <= i} dS_ij B_j for query tile t and add T's
// row sums of every key tile jt <= t into dcum_i; blocks (t, 1) form dB_j
// = sum_{i >= j} dS_ij C_i for key tile t.  grid: (nt, 2, BC).
template <int N>
__global__ void __launch_bounds__(NT)
    ssd_bwd_reduce(const float* __restrict__ bm, const float* __restrict__ cm,
                   const float* __restrict__ work, float* __restrict__ db,
                   float* __restrict__ dc, float* __restrict__ dcum, int Q,
                   int H, int BC) {
  constexpr int RS = N + 1;
  constexpr int NJ = N / 16;
  const int nt = (Q + BT - 1) / BT, qp = nt * BT;
  const int groups = (H + HG - 1) / HG;
  const int t = blockIdx.x;
  const bool rows = blockIdx.y == 0;  // dC (and dcum) of query tile t
  const size_t bc = blockIdx.z;
  const Work w(BC, Q, H);
  const float* DS = work + w.ds + bc * qp * qp;
  const size_t ds_group = size_t(BC) * qp * qp;
  extern __shared__ float smem[];
  float* sDS = smem;            // BT x MS: (query rows, key columns)
  float* sOp = sDS + BT * MS;   // BT x RS: B of the key tile, or C
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const float* op = (rows ? bm : cm) + bc * Q * N;
  float acc[4][NJ] = {};
  const int first = rows ? 0 : t, last = rows ? t : nt - 1;
  for (int u = first; u <= last; ++u) {
    const int it = rows ? t : u, jt = rows ? u : t;
    __syncthreads();  // the last tile is done with sDS, sOp
    for (int e = threadIdx.x; e < BT * BT; e += NT) {
      const int r = e / BT, c = e % BT;
      const float* p = DS + size_t(it * BT + r) * qp + jt * BT + c;
      float s = 0.f;
      for (int gi = 0; gi < groups; ++gi) s += p[gi * ds_group];
      sDS[r * MS + c] = s;
    }
    simt::load_rows<N>(sOp, RS, op, N, (rows ? jt : it) * BT, Q);
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < BT; ++k) {
      float a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = rows ? sDS[(ty + 16 * i) * MS + k] : sDS[k * MS + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float v = sOp[k * RS + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(a[i], v, acc[i][j]);
      }
    }
  }
  float* out = rows ? dc : db;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = t * BT + ty + 16 * i;
    if (r >= Q) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      out[(bc * Q + r) * N + tx + 16 * j] = acc[i][j];
  }
  if (!rows) return;
  const float* row = work + w.row;
  const size_t row_tile = size_t(BC) * qp * H;
  for (int e = threadIdx.x; e < BT * H; e += NT) {
    const int r = t * BT + e / H, h = e % H;
    if (r >= Q) continue;
    float s = dcum[(bc * Q + r) * H + h];
    for (int jt = 0; jt <= t; ++jt)
      s += row[jt * row_tile + (bc * qp + r) * H + h];
    dcum[(bc * Q + r) * H + h] = s;
  }
}

template <int P, int N>
cudaError_t launch(const void* x, const void* dt, const void* cum,
                   const void* b, const void* c, const void* dy, void* dx,
                   void* ddt, void* dcum, void* db, void* dc, void* work,
                   int B, int NC, int Q, int H, cudaStream_t stream) {
  if (Q > MAX_Q) return cudaErrorInvalidValue;
  const int nt = (Q + BT - 1) / BT, BC = B * NC;
  const int groups = (H + HG - 1) / HG;
  auto k1 = ssd_bwd_scores<N>;
  auto k2 = ssd_bwd_heads<P>;
  auto k3 = ssd_bwd_reduce<N>;
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(k1, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  int(scores_smem<N>()))) != cudaSuccess ||
      (err = cudaFuncSetAttribute(k2, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  int(heads_smem<P>()))) != cudaSuccess ||
      (err = cudaFuncSetAttribute(k3, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  int(reduce_smem<N>()))) != cudaSuccess)
    return err;
  const float* fx = static_cast<const float*>(x);
  const float* fdt = static_cast<const float*>(dt);
  const float* fcum = static_cast<const float*>(cum);
  const float* fb = static_cast<const float*>(b);
  const float* fc = static_cast<const float*>(c);
  float* fw = static_cast<float*>(work);
  k1<<<dim3(nt * nt, BC), NT, scores_smem<N>(), stream>>>(fb, fc, fw, Q);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long blocks = (long long)nt * BC * groups;
  if (blocks > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  k2<<<unsigned(blocks), NT, heads_smem<P>(), stream>>>(
      fx, fdt, fcum, static_cast<const float*>(dy), fw,
      static_cast<float*>(dx), static_cast<float*>(ddt),
      static_cast<float*>(dcum), Q, H, BC);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  k3<<<dim3(nt, 2, BC), NT, reduce_smem<N>(), stream>>>(
      fb, fc, fw, static_cast<float*>(db), static_cast<float*>(dc),
      static_cast<float*>(dcum), Q, H, BC);
  return cudaGetLastError();
}

}  // namespace bwd

enum Design { NONE = -1, SIMT = 0, WGMMA = 1, WGMMA_P128 = 2 };

Design design_of(int P, int N) {
  if (P == 64 && N == 128) return WGMMA;
  if (P == 128 && N == 128) return WGMMA_P128;
  if (P == 16 && N == 16) return SIMT;
  return NONE;
}

// The backward's designs: one fp32 CUDA-core design, a template over
// (P, N), instanced at each (P, N) the forward serves, and only there.
enum BackwardDesign { BWD_NONE = -1, BWD_SIMT = 0, BWD_SIMT_P64 = 1,
                      BWD_SIMT_P128 = 2 };

BackwardDesign backward_design_of(int P, int N) {
  switch (design_of(P, N)) {
    case WGMMA: return BWD_SIMT_P64;
    case WGMMA_P128: return BWD_SIMT_P128;
    case SIMT: return BWD_SIMT;
    default: return BWD_NONE;
  }
}

}  // namespace

extern "C" {

// The design that serves (P, N): 2 = wgmma_p128, 1 = wgmma, 0 = simt,
// -1 = none.
int ssd_scan_design(int P, int N) { return design_of(P, N); }

// Returns a cudaError_t (0 = success).
int ssd_scan_intra(const void* x, const void* dt, const void* cum,
                   const void* b, const void* c, void* y, int B, int NC,
                   int Q, int H, int P, int N, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (design_of(P, N)) {
    case WGMMA:
      return wg::launch<64>(x, dt, cum, b, c, y, B, NC, Q, H, st);
    case WGMMA_P128:
      return wg::launch<128>(x, dt, cum, b, c, y, B, NC, Q, H, st);
    case SIMT:
      return simt::launch<16, 16>(x, dt, cum, b, c, y, B, NC, Q, H, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// The backward's design for (P, N): 2 = simt_p128, 1 = simt_p64, 0 = simt,
// -1 = none.
int ssd_scan_bwd_design(int P, int N) { return backward_design_of(P, N); }

// Bytes of the workspace the backward takes at (B, NC, Q, H).
long long ssd_scan_bwd_work_bytes(int B, int NC, int Q, int H) {
  return (long long)(sizeof(float) * bwd::Work(B * NC, Q, H).total);
}

// dx, ddt, dcum, db, dc of the intra-chunk term given dy, in three
// launches over `work` (ssd_scan_bwd_work_bytes).  Returns a cudaError_t.
int ssd_scan_intra_bwd(const void* x, const void* dt, const void* cum,
                       const void* b, const void* c, const void* dy, void* dx,
                       void* ddt, void* dcum, void* db, void* dc, void* work,
                       int B, int NC, int Q, int H, int P, int N,
                       void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (backward_design_of(P, N)) {
    case BWD_SIMT_P64:
      return bwd::launch<64, 128>(x, dt, cum, b, c, dy, dx, ddt, dcum, db, dc,
                                  work, B, NC, Q, H, st);
    case BWD_SIMT_P128:
      return bwd::launch<128, 128>(x, dt, cum, b, c, dy, dx, ddt, dcum, db,
                                   dc, work, B, NC, Q, H, st);
    case BWD_SIMT:
      return bwd::launch<16, 16>(x, dt, cum, b, c, dy, dx, ddt, dcum, db, dc,
                                 work, B, NC, Q, H, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// Dynamic shared memory of one block at (P, N) and chunk length Q, or -1.
int ssd_scan_smem_bytes(int P, int N, int Q) {
  switch (design_of(P, N)) {
    case WGMMA:
    case WGMMA_P128: return int(wg::smem_bytes(Q));
    case SIMT: return int(simt::smem_bytes<16, 16>());
    default: return -1;
  }
}

const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
