// Mamba-2 SSD intra-chunk term for Hopper (sm_90a), float32:
//
//   Y[i] = sum_{j <= i} (C_i . B_j) * exp(cum_i - cum_j) * dt_j * x_j
//
// within each chunk of Q rows, per head, with B and C shared by all heads
// (ngroups 1).
//
// Replaces: the Pallas TPU kernel `_ssd_kernel` / `ssd_intra` in
// src/repro/kernels/ssd_scan.py, which holds a whole Q x Q tile of one
// (batch, chunk, head) in VMEM and does two MXU products.  The chunk
// states and the inter-chunk recurrence stay outside, as they do there.
//
// What bounds it on this card: per (batch, chunk) the function needs
// Q(Q+1)/2 * (2N + 2*H*P) operations (scores once, then one product per
// head) against (Q*H*P*2 + Q*H*2 + Q*N*2) * 4 bytes.  At mamba2-780m's
// widths (Q 256, H 48, P 64, N 128) that is ~32 operations per byte,
// above the 20 of the H100's fp32 peak over its memory rate (67 TFLOP/s,
// 3.35 TB/s; H100 SXM data sheet, 700 W), so the bound is arithmetic.
// This first version does fp32 FMAs on the CUDA cores; TF32 wgmma and
// TMA are later work.
//
// What the design does about it:
//   * a Q x N tile of C and of B in fp32 is 128 KB each at Q 256, N 128,
//     so the TPU's whole-chunk tile does not fit the 227 KB a block may
//     have.  One block handles (64 query rows, HG heads, batch x chunk)
//     and loops over 64-row key tiles up to the diagonal, summing into
//     registers; key tiles above the diagonal are never visited;
//   * the score tile C_i . B_j^T is computed once per key tile and used
//     by the block's HG heads, so scores cost H / HG times, not H times;
//   * masking comes before the product: exp(cum_i - cum_j) is formed only
//     for j <= i, where cum_i - cum_j <= 0.  For j > i it overflows to
//     inf over a 256-row chunk, and 0 * inf would be NaN;
//   * Q is a runtime value (the model's chunk, or a prompt shorter than
//     it); rows at or beyond Q are zero on load and not written;
//   * tiles sit in shared memory as fp32 with an odd row stride for the
//     score product, so B rows are read without bank conflicts; 256
//     threads each own 4 x 4 scores and 4 x (P/16) outputs per head;
//   * heavy (late) query tiles are scheduled first.
//
// Plain C interface, loaded with ctypes; it returns the cudaError_t of
// the launch and never synchronises.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

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
    ssd_intra_kernel(const float* __restrict__ x, const float* __restrict__ dt,
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
  auto kernel = ssd_intra_kernel<P, N>;
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

}  // namespace

extern "C" {

// (P, N): mamba2-780m's (64, 128) and its smoke config's (16, 16); add
// others with a config.  Returns a cudaError_t (0 = success).
int ssd_scan_intra(const void* x, const void* dt, const void* cum,
                   const void* b, const void* c, void* y, int B, int NC,
                   int Q, int H, int P, int N, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (P == 64 && N == 128)
    return launch<64, 128>(x, dt, cum, b, c, y, B, NC, Q, H, st);
  if (P == 16 && N == 16)
    return launch<16, 16>(x, dt, cum, b, c, y, B, NC, Q, H, st);
  return cudaErrorInvalidValue;
}

// Dynamic shared memory of one block at (P, N), or -1.
int ssd_scan_smem_bytes(int P, int N) {
  if (P == 64 && N == 128) return int(smem_bytes<64, 128>());
  if (P == 16 && N == 16) return int(smem_bytes<16, 16>());
  return -1;
}

const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
