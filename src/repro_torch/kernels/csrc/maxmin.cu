// Max-min fair-share waterfilling for Hopper (sm_90a): the whole solve of
// a problem in one thread block, float32 like the reference, for a batch
// of B independent problems (one block each) in one launch.
//
// Replaces: the jitted `solve_waterfill` of src/repro/kernels/maxmin.py:36
// (the simulator's solver, one problem) and its `jax.vmap` in
// src/repro/kernels/batched_maxmin.py:38 (the sweeps' pricing, a batch).
// Neither is a Pallas kernel; the port carried them as ~30 torch ops and
// one host read a round, which is now the plain version.
//
// Semantics, branch for branch those of the reference's loop body
// (src/repro/kernels/maxmin.py:64-98):
//   share_l  = cap_left_l / n_l over links with active flows, inf elsewhere
//   fs_f     = min over f's links of share_l; best = min over active fs_f
//   capped   = active & (flow_cap < best), strict: if any, they take their
//              own caps; else if best is inf every active flow does; else
//              the flows with fs_f <= best take best and every link with
//              share_l <= best is zeroed (the float-safety clamp);
//   cap_left = max(cap_left - used, 0);
// padding rows (all dummy) start retired, and the loop ends after
// num_flows + num_links + 2 rounds.  The loopback fix-up (flows with no
// links take their own cap) stays on the host.
//
// Determinism (the sanitizer demands byte-identical replays): no float
// atomics and no order that depends on scheduling.
//   * n_l is an integer count, and fs_f a min (atomicMin on the bits of
//     non-negative floats): both exact in any order;
//   * used_l is summed in float64 and rounded once to float32.  In the
//     bottleneck branch every fixed flow takes the same best, so the sum is
//     best x count, exact in float64.  In the capped branch it is the sum
//     of distinct float32 caps, taken in a fixed order: each link's list
//     (below) in flow order, by its thread when the list is short, else
//     lane j of the link's warp summing entries j, j + 32, ... and the
//     lanes folded by a fixed xor-shuffle tree.  Exact
//     whenever the caps' exponents lie within 29 bits of each other, so it
//     then equals the plain version's float64 sum in any order; the same
//     bits in every run in any case.
//   Every float32 operation is a _rn intrinsic, so nvcc contracts nothing
//   into an FMA that the plain version rounds twice.
//
// Layout on the device: per problem, link caps (Lp) and flow caps (Fp) as
// float32 and link ids (Fp x width) as int32, the last link (Lp - 1) the
// dummy every padding id points at.  The per-link flow lists are built in
// the block, not on the host: a counting sort by link, stable in flow
// order.  Warp w of the first `build_warps` counts the links of a
// contiguous range of flows in tiles of 32 entries, 8 tiles' loads in
// flight at once (__match_any_sync groups a tile's equal links; the
// group's lowest lane adds its size), the counts are scanned in
// link-major, warp-minor order (32 links a warp, then the chunks' sums),
// and each warp walks its range again, writing each entry at its link's
// cursor plus its rank in its group.  The ids are read from device memory
// (L2) only there and at the start: the rounds use the lists alone.
//
// Per round, in shared memory: a link whose list holds at most 32 flows
// is owned by thread l mod threads, a longer one by a warp (the longer
// lists are listed once, after the build, and dealt out to the warps);
// the owner walks its list (A: n_l and share_l, then fs_f by atomicMin),
// barrier; every thread takes the min of its flows' fs (best) through a
// warp reduction and one slot a warp, barrier; the capped test through
// __syncthreads_or; the fix (mask, rates written out, state) and the
// test for flows still active through a second __syncthreads_or; then
// each owner updates its own links' cap_left (F), which no other thread
// reads before the next round's barrier.  A thread per short list keeps
// H's rounds (487 links, most with 1-3 flows) from serialising 32 links'
// warp reductions on each warp; each warp reconverges (__syncwarp) after
// the threads' uneven walks, before its collective operations.  Four
// barriers a round, no host read:
// the block writes its rates and its round count, and the host reads them
// with one copy when the launch is done.
//
// Shared memory per block (dynamic): link state 4 x (3 Lp + 1) B, build
// counters 4 x build_warps x Lp B and 33 words of reductions; flow state,
// flow caps and fs 8 Fp B and a state byte a flow (rounded up to 4 B); and
// room for Fp x width list entries of 2 B (4 B when Fp > 65536).  Storm
// H's peak bucket (Fp 512, Lp 512, width 8) needs 51,848 B, sweep I's (Fp
// 8192, Lp 32, width 8) 209,416 B.  Four designs by that size:
//   `smem`, everything in shared memory, where it fits;
//   `global`, the lists in a workspace in device memory (Fp x width
//   entries a problem, the wrapper's), read through L1 and L2, everything
//   else as before: a two-tier OSDF sweep's pricing bucket (Fp 16384, Lp
//   256, width 8) needs 183,432 B so;
//   `global_flows`, the flow state too in the workspace (caps, fs by
//   atomicMin in device memory, state bytes), the link state and build
//   counters alone in shared memory: a sweep cell of more than 16,384
//   storm flows (Fp 32768: 294,912 B of flow state) and every bucket of
//   more than 65,536 flows;
//   `global_links`, the link state and build counters there too (16 B a
//   link once Lp >= 8192, so over 227 KB from Lp 16384: 8,192 links or
//   more in one bucket), the 33 words of reductions alone in shared
//   memory.
// The arithmetic and its order are the same in all four designs, so a
// problem gets the same bits in each.
//
// What bounds it: the rounds' chain of barriers and reductions (a problem
// takes 1-20 rounds), not bytes: H's peak problem is 34 KB of input.
//
// Plain C interface, loaded with ctypes: it returns the cudaError_t of the
// attribute call and the launch, and never synchronises.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned INF_BITS = 0x7f800000u;
constexpr int BUILD_COUNTERS = 8192;  // ints of build counters at most
constexpr int BUILD_TILES = 8;        // tiles of ids a warp loads at once

constexpr int SHORT_LIST = 32;       // flows a list has for one thread
// where the flow state and the lists live (maxmin_design's codes)
constexpr int kSmem = 0, kGlobal = 1, kGlobalFlows = 2, kGlobalLinks = 3;

__device__ __forceinline__ float inf_f() { return __uint_as_float(INF_BITS); }

// A link's capacity after a round: max(cap_left - used, 0), used rounded
// once; in the bottleneck branch a link at the bottleneck saturates.
__device__ __forceinline__ float retire(float cap_left, double used,
                                        bool by_cap, float share, float best) {
  const float c = fmaxf(__fsub_rn(cap_left, __double2float_rn(used)), 0.0f);
  return !by_cap && share <= best ? 0.0f : c;
}

// A template over the design, so that the compiler knows which state
// lies in shared memory and addresses it so (a pointer chosen at run
// time would be a generic one for every design).
template <typename Idx, int kDesign>
__global__ void __launch_bounds__(1024)
waterfill(const float* __restrict__ link_caps,
          const float* __restrict__ flow_caps,
          const int* __restrict__ link_ids, int fp, int lp, int width,
          int build_warps, unsigned char* work, long long work_stride,
          float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = blockDim.x, nwarps = nthreads >> 5;
  const int dummy = lp - 1;

  // this problem's part of the workspace; the link state lies in shared
  // memory, or at the workspace's start (global_links)
  unsigned char* work_b = kDesign == kSmem ? nullptr
                                            : work + b * work_stride;
  unsigned char* link_base = kDesign == kGlobalLinks ? work_b : smem;
  float* cap_left = reinterpret_cast<float*>(link_base);  // lp
  float* share = cap_left + lp;                            // lp
  int* off = reinterpret_cast<int*>(share + lp);           // lp + 1
  int* cnt = off + lp + 1;                                 // build_warps*lp
  // 32 warps' minima and a count, always in shared memory; then the flow
  // state and the lists: in shared memory (design smem), the lists in the
  // workspace (global), or both there (global_flows, global_links: after
  // the link state, at a 16-byte boundary)
  unsigned* red = kDesign == kGlobalLinks
      ? reinterpret_cast<unsigned*>(smem)
      : reinterpret_cast<unsigned*>(cnt + build_warps * lp);
  const long long link_state =
      (4 * (3LL * lp + 1 + (long long)build_warps * lp) + 15) & ~15LL;
  unsigned char* flows = kDesign == kGlobalFlows ? work_b
      : kDesign == kGlobalLinks ? work_b + link_state
      : reinterpret_cast<unsigned char*>(red + 33);
  float* fcap = reinterpret_cast<float*>(flows);           // fp
  unsigned* fs = reinterpret_cast<unsigned*>(fcap + fp);   // fp
  unsigned char* state = reinterpret_cast<unsigned char*>(fs + fp);  // fp
  Idx* list = reinterpret_cast<Idx*>(
      kDesign == kGlobal ? work_b : state + ((fp + 3) & ~3));

  const float* caps_b = link_caps + (long long)b * lp;
  const float* fcaps_b = flow_caps + (long long)b * fp;
  const int* ids_b = link_ids + (long long)b * fp * width;
  float* out_b = out + (long long)b * (fp + 1);

  // ---- set-up: link and flow state; padding rows start retired
  for (int l = tid; l < lp; l += nthreads) cap_left[l] = caps_b[l];
  for (int i = tid; i < build_warps * lp; i += nthreads) cnt[i] = 0;
  for (int f = tid; f < fp; f += nthreads) {
    fcap[f] = fcaps_b[f];
    fs[f] = INF_BITS;
    out_b[f] = 0.0f;
    bool real = false;
    for (int s = 0; s < width; ++s) real |= ids_b[f * width + s] < dummy;
    state[f] = real ? 1 : 0;          // bit 0 active, bit 1 fixed this round
  }
  __syncthreads();

  // ---- the per-link lists: a counting sort by link, stable in flow order
  const int chunk = (fp + build_warps - 1) / build_warps;
  const int e0 = min(warp * chunk, fp) * width;
  const int e1 = min((warp + 1) * chunk, fp) * width;
  if (warp < build_warps) {
    int* mine = cnt + warp * lp;
    for (int base = e0; base < e1; base += 32 * BUILD_TILES) {
      int links[BUILD_TILES];          // the loads in flight together
#pragma unroll
      for (int u = 0; u < BUILD_TILES; ++u) {
        const int e = base + 32 * u + lane;
        links[u] = e < e1 ? ids_b[e] : dummy;
      }
#pragma unroll
      for (int u = 0; u < BUILD_TILES; ++u) {
        const int l = links[u];
        const bool real = l < dummy;
        const unsigned peers = __match_any_sync(FULL, real ? l : -1);
        if (real && lane == __ffs(peers) - 1) mine[l] += __popc(peers);
        __syncwarp();
      }
    }
  }
  __syncthreads();
  // link offsets: each link's total, scanned by chunks of 32 links (a
  // warp each), then the chunks' sums by warp 0
  int* chunk_sum = reinterpret_cast<int*>(share);    // free until the rounds
  for (int l = tid; l < lp; l += nthreads) {
    int v = 0;
    for (int w = 0; w < build_warps; ++w) v += cnt[w * lp + l];
    off[l + 1] = v;
  }
  if (tid == 0) {
    off[0] = 0;
    red[32] = 0;                       // the count of long lists
  }
  __syncthreads();
  for (int c = warp; c * 32 < lp; c += nwarps) {
    const int l = c * 32 + lane;
    int incl = l < lp ? off[l + 1] : 0;
    for (int d = 1; d < 32; d <<= 1) {
      const int up = __shfl_up_sync(FULL, incl, d);
      if (lane >= d) incl += up;
    }
    if (l < lp) off[l + 1] = incl;
    if (lane == 31) chunk_sum[c] = incl;
  }
  __syncthreads();
  if (warp == 0) {
    int carry = 0;
    for (int base = 0; base * 32 < lp; base += 32) {
      const int c = base + lane;
      const int v = c * 32 < lp ? chunk_sum[c] : 0;
      int incl = v;
      for (int d = 1; d < 32; d <<= 1) {
        const int up = __shfl_up_sync(FULL, incl, d);
        if (lane >= d) incl += up;
      }
      if (c * 32 < lp) chunk_sum[c] = carry + incl - v;   // exclusive
      carry += __shfl_sync(FULL, incl, 31);
    }
  }
  __syncthreads();
  for (int l = tid; l < lp; l += nthreads) off[l + 1] += chunk_sum[l >> 5];
  __syncthreads();
  for (int l = tid; l < lp; l += nthreads) {   // each warp's cursor
    int run = off[l];
    for (int w = 0; w < build_warps; ++w) {
      const int c = cnt[w * lp + l];
      cnt[w * lp + l] = run;
      run += c;
    }
  }
  __syncthreads();
  if (warp < build_warps) {
    int* cursor = cnt + warp * lp;
    const unsigned below = (1u << lane) - 1u;
    for (int base = e0; base < e1; base += 32 * BUILD_TILES) {
      int links[BUILD_TILES];
#pragma unroll
      for (int u = 0; u < BUILD_TILES; ++u) {
        const int e = base + 32 * u + lane;
        links[u] = e < e1 ? ids_b[e] : dummy;
      }
#pragma unroll
      for (int u = 0; u < BUILD_TILES; ++u) {
        const int e = base + 32 * u + lane;
        const int l = links[u];
        const bool real = l < dummy;
        const unsigned peers = __match_any_sync(FULL, real ? l : -1);
        if (real) {
          list[cursor[l] + __popc(peers & below)] =
              static_cast<Idx>(e / width);
          if (lane == __ffs(peers) - 1) cursor[l] += __popc(peers);
        }
        __syncwarp();
      }
    }
  }
  __syncthreads();
  // the links whose lists a warp walks (in any order: each is one warp's
  // alone, and nothing a link computes depends on which warp that is)
  int* long_links = cnt;                       // free from here on
  for (int l = tid; l < lp; l += nthreads)
    if (off[l + 1] - off[l] > SHORT_LIST)
      long_links[atomicAdd(&red[32], 1u)] = l;
  __syncthreads();
  const int n_long = red[32];

  // ---- the rounds
  const int limit = fp + lp + 2;
  int rounds = 0;
  bool any_left = false;
  for (int f = tid; f < fp; f += nthreads) any_left |= state[f] & 1;
  any_left = __syncthreads_or(any_left);
  while (any_left && rounds < limit) {
    // A: n_l, share_l, and each active flow's tightest share; a list of
    // at most SHORT_LIST flows by one thread, a longer one by a warp
    for (int l = tid; l < lp; l += nthreads) {
      const int s0 = off[l], s1 = off[l + 1];
      if (s1 - s0 > SHORT_LIST) continue;
      unsigned n = 0;
      for (int i = s0; i < s1; ++i) n += state[list[i]] & 1;
      const float sh = n ? __fdiv_rn(cap_left[l], (float)n) : inf_f();
      share[l] = sh;
      const unsigned bits = __float_as_uint(sh) & 0x7fffffffu;
      for (int i = s0; i < s1 && n; ++i) {
        const int f = list[i];
        if (state[f] & 1) atomicMin(&fs[f], bits);
      }
    }
    __syncwarp();                      // the warp reconverges
    for (int i = warp; i < n_long; i += nwarps) {
      const int l = long_links[i];
      const int s0 = off[l], s1 = off[l + 1];
      unsigned n = 0;
      for (int i = s0 + lane; i < s1; i += 32) n += state[list[i]] & 1;
      n = __reduce_add_sync(FULL, n);
      const float sh = n ? __fdiv_rn(cap_left[l], (float)n) : inf_f();
      if (lane == 0) share[l] = sh;
      // the bits of a non-negative float order as the float: -0 as +0
      const unsigned bits = __float_as_uint(sh) & 0x7fffffffu;
      for (int i = s0 + lane; i < s1 && n; i += 32) {
        const int f = list[i];
        if (state[f] & 1) atomicMin(&fs[f], bits);
      }
    }
    __syncthreads();
    // best: the min over active flows (a retired flow's fs is inf)
    unsigned m = INF_BITS;
    for (int f = tid; f < fp; f += nthreads) m = min(m, fs[f]);
    m = __reduce_min_sync(FULL, m);
    if (lane == 0) red[warp] = m;
    __syncthreads();
    unsigned best_bits = red[0];
    for (int w = 1; w < nwarps; ++w) best_bits = min(best_bits, red[w]);
    const float best = __uint_as_float(best_bits);
    bool capped = false;
    for (int f = tid; f < fp; f += nthreads)
      capped |= (state[f] & 1) && fcap[f] < best;
    const bool any_capped = __syncthreads_or(capped);
    const bool no_links = best_bits == INF_BITS;
    const bool by_cap = any_capped || no_links;
    bool left = false;
    for (int f = tid; f < fp; f += nthreads) {
      const bool active = state[f] & 1;
      const bool mask =
          active && (any_capped ? fcap[f] < best
                                : no_links || __uint_as_float(fs[f]) <= best);
      if (mask) out_b[f] = by_cap ? fcap[f] : best;
      state[f] = (active && !mask) | (mask << 1);
      fs[f] = INF_BITS;
      left |= active && !mask;
    }
    any_left = __syncthreads_or(left);
    // F: the capacity each link gives up, in float64, rounded once: a
    // short list summed by its thread in list order, a long one by its
    // warp's lanes (entries j, j + 32, ...) and an xor tree
    for (int l = tid; l < lp; l += nthreads) {
      const int s0 = off[l], s1 = off[l + 1];
      if (s1 - s0 > SHORT_LIST) continue;
      double used = 0.0;
      unsigned k = 0;
      for (int i = s0; i < s1; ++i) {
        const int f = list[i];
        if (state[f] & 2) {
          ++k;
          if (by_cap) used += (double)fcap[f];
        }
      }
      if (!by_cap) used = (double)best * (double)k;
      cap_left[l] = retire(cap_left[l], used, by_cap, share[l], best);
    }
    __syncwarp();
    for (int i = warp; i < n_long; i += nwarps) {
      const int l = long_links[i];
      const int s0 = off[l], s1 = off[l + 1];
      double used = 0.0;
      unsigned k = 0;
      for (int i = s0 + lane; i < s1; i += 32) {
        const int f = list[i];
        if (state[f] & 2) {
          ++k;
          if (by_cap) used += (double)fcap[f];
        }
      }
      if (by_cap) {
        for (int d = 16; d; d >>= 1) used += __shfl_xor_sync(FULL, used, d);
      } else {
        k = __reduce_add_sync(FULL, k);
        used = (double)best * (double)k;
      }
      if (lane == 0)
        cap_left[l] = retire(cap_left[l], used, by_cap, share[l], best);
    }
    __syncwarp();      // a warp's lane 0 wrote cap_left: the next A reads it
    ++rounds;
  }
  if (tid == 0) out_b[fp] = (float)rounds;
}

constexpr size_t BLOCK_SMEM = 232448;  // what a block may have on Hopper
constexpr size_t RED_BYTES = 4 * 33;   // the reductions' words

size_t index_bytes(int fp) { return fp <= 65536 ? 2 : 4; }
size_t round16(size_t n) { return (n + 15) & ~(size_t)15; }

// Bytes of the link state and build counters; of those and the
// reductions; of the flow state; of the lists.
size_t link_state_bytes(int lp, int build_warps) {
  return 4 * (3 * (size_t)lp + 1 + (size_t)build_warps * lp);
}
size_t link_bytes(int lp, int build_warps) {
  return link_state_bytes(lp, build_warps) + RED_BYTES;
}
size_t flow_bytes(int fp) {
  return 8 * (size_t)fp + (((size_t)fp + 3) & ~(size_t)3);
}
size_t list_bytes(int fp, int width) {
  return index_bytes(fp) * (size_t)fp * width;
}

int design_for(int fp, int lp, int width, int build_warps) {
  const size_t links = link_bytes(lp, build_warps);
  if (links + flow_bytes(fp) + list_bytes(fp, width) <= BLOCK_SMEM)
    return kSmem;
  if (links + flow_bytes(fp) <= BLOCK_SMEM) return kGlobal;
  if (links <= BLOCK_SMEM) return kGlobalFlows;
  return kGlobalLinks;
}

// What a design keeps in shared memory, and in the workspace a problem.
size_t smem_bytes(int design, int fp, int lp, int width, int build_warps) {
  const size_t links = link_bytes(lp, build_warps);
  switch (design) {
    case kSmem: return links + flow_bytes(fp) + list_bytes(fp, width);
    case kGlobal: return links + flow_bytes(fp);
    case kGlobalFlows: return links;
    default: return RED_BYTES;
  }
}
size_t work_bytes(int design, int fp, int lp, int width, int build_warps) {
  switch (design) {
    case kGlobal: return round16(list_bytes(fp, width));
    case kGlobalFlows: return round16(flow_bytes(fp) + list_bytes(fp, width));
    case kGlobalLinks:
      return round16(link_state_bytes(lp, build_warps)) +
             round16(flow_bytes(fp) + list_bytes(fp, width));
    default: return 0;
  }
}

int threads_for(int fp) {
  int t = fp < 64 ? 64 : fp;
  return t > 1024 ? 1024 : t;
}

int build_warps_for(int fp, int lp) {
  const int nw = threads_for(fp) / 32;
  int bw = BUILD_COUNTERS / (lp > 0 ? lp : 1);
  if (bw < 1) bw = 1;
  return bw < nw ? bw : nw;
}

// One design's launch, after raising its instantiation's shared-memory
// limit where this bucket needs more than it was raised to on this
// device (the simulator solves hundreds of small problems a second).
template <typename Idx, int kDesign>
cudaError_t launch(const float* link_caps, const float* flow_caps,
                   const int* link_ids, int batch, int fp, int lp, int width,
                   int bw, int threads, size_t smem, unsigned char* ws,
                   long long stride, float* out, cudaStream_t s) {
  static size_t raised[64] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  size_t* limit = device < 64 ? &raised[device] : nullptr;
  if (!limit || smem > *limit) {
    err = cudaFuncSetAttribute(waterfill<Idx, kDesign>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               int(smem));
    if (err != cudaSuccess) {
      cudaGetLastError();  // reported here: not to a later launch
      return err;
    }
    if (limit) *limit = smem;
  }
  waterfill<Idx, kDesign><<<batch, threads, smem, s>>>(
      link_caps, flow_caps, link_ids, fp, lp, width, bw, ws, stride, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* maxmin_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The design for an (Fp, Lp, width) bucket: 0 smem, 1 global (the lists
// in a workspace of maxmin_work_bytes a problem), 2 global_flows (the
// flow state there too), 3 global_links (the link state too).
int maxmin_design(int fp, int lp, int width) {
  return design_for(fp, lp, width, build_warps_for(fp, lp));
}

// Dynamic shared memory a block of the bucket's design needs.
long long maxmin_smem_bytes(int fp, int lp, int width) {
  const int bw = build_warps_for(fp, lp);
  return (long long)smem_bytes(design_for(fp, lp, width, bw), fp, lp, width,
                               bw);
}

long long maxmin_work_bytes(int fp, int lp, int width) {
  const int bw = build_warps_for(fp, lp);
  return (long long)work_bytes(design_for(fp, lp, width, bw), fp, lp, width,
                               bw);
}

int maxmin_threads(int fp) { return threads_for(fp); }

// link_caps (B x lp) f32, flow_caps (B x fp) f32, link_ids (B x fp x width)
// int32 → out (B x (fp + 1)) f32: each problem's rates, then its round
// count.  work: B x maxmin_work_bytes for the designs other than smem,
// else null.
int maxmin_waterfill(const float* link_caps, const float* flow_caps,
                     const int* link_ids, int batch, int fp, int lp,
                     int width, void* work, float* out, void* stream) {
  const int threads = threads_for(fp);
  const int bw = build_warps_for(fp, lp);
  const int design = design_for(fp, lp, width, bw);
  const size_t smem = smem_bytes(design, fp, lp, width, bw);
  const long long stride =
      (long long)work_bytes(design, fp, lp, width, bw);
  if (stride && !work)
    return cudaErrorInvalidValue;     // the design needs its workspace
  unsigned char* ws = stride ? static_cast<unsigned char*>(work) : nullptr;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // Fp > 65536 (4-byte list entries): over 589,824 B of flow state, so
  // global_flows or global_links
  if (fp > 65536)
    return design == kGlobalLinks
        ? launch<int, kGlobalLinks>(link_caps, flow_caps, link_ids, batch,
                                    fp, lp, width, bw, threads, smem, ws,
                                    stride, out, s)
        : launch<int, kGlobalFlows>(link_caps, flow_caps, link_ids, batch,
                                    fp, lp, width, bw, threads, smem, ws,
                                    stride, out, s);
  switch (design) {
    case kSmem:
      return launch<uint16_t, kSmem>(link_caps, flow_caps, link_ids, batch,
                                     fp, lp, width, bw, threads, smem, ws,
                                     stride, out, s);
    case kGlobal:
      return launch<uint16_t, kGlobal>(link_caps, flow_caps, link_ids,
                                       batch, fp, lp, width, bw, threads,
                                       smem, ws, stride, out, s);
    case kGlobalFlows:
      return launch<uint16_t, kGlobalFlows>(link_caps, flow_caps, link_ids,
                                            batch, fp, lp, width, bw,
                                            threads, smem, ws, stride, out,
                                            s);
    default:
      return launch<uint16_t, kGlobalLinks>(link_caps, flow_caps, link_ids,
                                            batch, fp, lp, width, bw,
                                            threads, smem, ws, stride, out,
                                            s);
  }
}

}  // extern "C"
