// The capacity planner's two loops for Hopper (sm_90a), in float64: the
// inverse solve (`plan_solve`, a thread block cluster a plan) and the
// log-normal mixture fit (`mixture_fit`, a block a histogram), each whole
// loop inside one launch.
//
// Replaces: the jitted `_solve` of src/repro/core/planner.py:162 (one XLA
// program under enable_x64: a 64-step bisection for the uniform capacity,
// 8 augmented-Lagrangian rounds of Adam with a dual update after each, a
// 64-step repair bisection and a jax.grad of the fleet hit rate) and the
// jitted `_mixture_fit_loop` of src/repro/kernels/cache_model.py:267 (a
// lax.fori_loop of Adam on the mixture's logits, means and log-sigmas).
// Neither is a Pallas kernel.  As eager torch ops (the plain versions,
// kernels/ref.py `plan_solve_ref` and `mixture_fit_ref`) one solve is
// about 27,000 launches, each a few microseconds on the card.
//
// What bounds them: the chain.  A solve is 64 + steps + 8 + 64 + 1
// dependent evaluations of the stacked model (737 at the default 600
// steps), each a pass over N caches x Bk buckets (an exp and two divisions
// each, in float64) and a barrier; a fit is `steps` dependent passes over
// its grid.  Bytes are nothing: the model comes from device memory once,
// then from L1 and L2.  The one-block designs before these spent much of a
// stage on float64 issue on one SM (two pows a warp a step, every cache's
// terms); here the cluster spreads the terms over 8-16 SMs and tables take
// the pows off the loop, and what is left is the latency of each stage's
// chain of float64 divisions, exponentials, logs and square roots
// (kernel_probe.py: a stage's FP64 issue is a tenth of its time).
//
// plan_solve.  A thread block cluster a plan (8 CTAs, or 16 from 128
// caches where the card schedules them): CTA r evaluates the caches r, r +
// C, ..., a warp a cache, lane l over the buckets l, l + 32, ... in order
// (two buckets' terms at once), folded by an xor-shuffle tree: per cache
// the sums Σ_b w_b σ and Σ_b w_b σ(1 − σ) of the reference weights and,
// where asked, the byte weights, at σ = σ((ln max(e^v, 1) − m_b)/τ).  Lane
// j of the cache's warp sends the sums into CTA j's shared memory by
// st.async (distributed shared memory), each store counted on CTA j's
// transaction barrier (an mbarrier armed with the stage's bytes), so each
// CTA waits alone for every cache's sums, with no cluster-wide barrier.
// The sums go to one of two buffers that alternate from stage to stage: a
// CTA sends a stage's sums only after a block barrier that ends its reads
// of the stage before, and the others receive them before they send into
// that buffer again.  Then every warp of every CTA sums the per-cache
// values in the same order (lane l over caches l, l + 32, ..., the same
// tree), so every thread holds the fleet hit rate and egress, and decides
// a bisection step or the Adam step alike.  Every CTA keeps the whole
// group state (u and e^u in shared memory; a thread's groups' moments in
// its registers) and takes every group's step itself, from the same sums
// in the same order: the copies stay equal bit for bit.
// The gradient is analytic, not taped:
//   ∂L/∂u_g = gsize_g e^{u_g} / scale
//           + e^{u_g} Σ_{c∈g} (ct_hits · R'_c − ct_egress · of_c · B'_c)/τ / C_c
// with R'_c = Σ_b refw σ(1 − σ), B'_c the same over byte weights,
// ct_hits = −aug/Σrefs and ct_egress = aug₂/max(budget, 1) (each formed as
// autograd forms it, through (aug² − ν²)/(2ρ)), and no constraint term
// where C_c = e^{u_g} ≤ 1 (the max(C, 1) inside the log).  A thread a
// group (groups t, t + threads, ...: four at most, as a CTA has at most
// 512 threads, so 128 registers a thread) sums its caches in the order
// of the group's member list, built in the block once (a CSR by cache
// index), and takes the Adam step (β₁ 0.9, β₂ 0.99, ε 1e-8, t = r·inner +
// i + 1, the bias corrections by pow, 128 steps ahead in a table) and the
// clip to [lo, hi]; e^u is taken once a step, after the step, for the next
// evaluation and the next gradient.
//   The stacked model (3 x N x Bk doubles) is read from device memory
// through L1 and L2, each CTA its own caches' rows.  The kernel serves N
// <= 2048 caches, 1 <= G <= N groups and any Bk; the state in shared
// memory is 80 B a cache (two buffers of four sums, bytes and origin
// fraction), 16 B a group and 4 B a cache and a group for the lists (219
// KB at 2048), on every CTA of the cluster.  The arithmetic of every term
// and the order of every sum are those of the one-block design before it
// (a block a plan), so the outputs are its bits.
//
// mixture_fit.  A block a histogram, a thread a grid point (M <= 256, K
// <= 8 components; a template over K, so no loop over the components is
// left rolled and no shuffle sits behind a branch): π_k, μ_k and σ_k√2
// from shared memory, the CDF Σ_k (π_k·0.5)(1 + erf z_k), and the point's
// terms, with ct = 2r/M:
//   Σ ct (1 + erf z_k) → ∂L/∂π_k (·0.5), then the softmax's Jacobian;
//   Σ ct e^{−z_k²}     → ∂L/∂μ_k = −(π_k/√π)·Σ / (σ_k√2);
//   Σ ct e^{−z_k²} z_k → ∂L/∂log σ_k = −(π_k/√π)·Σ;
// and the loss's r², each folded over a warp's 32 points by the xor tree
// (the 3K + 1 trees level by level), one slot a warp.  The parameters
// and their moments live in registers: lane j < K of warp 0 holds logit j
// and lane j < 2K of warp 1 parameter K + j (a block has two warps at
// least: the second has no point when M <= 32), so the softmax's chain
// (the logits' Adam steps, then their softmax, a shuffle a component)
// and the means' and σ's (their gradients' divisions, their steps,
// e^{log σ}) run in two warps at once.  Each sums its slot over the warps in order and takes
// its Adam step (β₂ 0.999, t = i + 1, the bias corrections from a table of
// the next 128 steps); π, μ and σ√2 go to the other of two copies, so no
// warp waits for the others' reads.  The loss returned is the one the
// last step evaluated before its update, as the reference's.  Every sum
// keeps the order of the design before it (a thread a point, every
// thread recomputing the softmax), so the outputs are its bits.
//
// Probe build (-DCM_PROBE=1, kernel_probe.py only): thread 0 of the first
// block stamps clock64() between a step's parts and writes the sums of
// each part's clocks; its own entry points (`plan_solve_probe`, which also
// takes the cluster size, and `mixture_fit_probe`) take the output, and
// it adds the terms alone for their SASS.  The ordinary build compiles the
// stamps away and exports none of it.
//
// Determinism: no atomics on floats and no order that depends on
// scheduling, so two launches on the same inputs give the same bits.  The
// library is built with --fmad=false: every product and sum rounds once,
// as the plain version's torch ops do, and no FMA is contracted.


#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#ifndef CM_PROBE
#define CM_PROBE 0
#endif

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kRounds = 8;             // augmented-Lagrangian rounds
constexpr int kBisect = 64;            // steps of each bisection
// the sizes served, from the wrapper (kernels/cache_model.py) with -D
constexpr int kMaxCaches = PLAN_MAX_CACHES;
constexpr int kMixMaxK = MIX_MAX_COMPONENTS;
constexpr int kMixMaxPoints = MIX_MAX_POINTS;
constexpr size_t kBlockSmem = 232448;  // what a block may have on Hopper
constexpr int kCluster = 8;            // CTAs a plan: the portable most
constexpr int kClusterWide = 16;       // from kWideFrom caches, if scheduled
constexpr int kWideFrom = 128;
constexpr int kGroupSlots = 4;         // groups a thread steps, at most
constexpr int kPlanThreads = 512;      // a CTA's most: 128 registers a thread
constexpr int kTable = 128;            // steps' bias corrections ahead
constexpr double kSqrt2 = 1.4142135623730951;
constexpr double kSqrtPi = 1.7724538509055159;
static_assert(kMaxCaches <= kGroupSlots * kPlanThreads,
              "a thread steps at most kGroupSlots groups");

__device__ __forceinline__ double warp_sum(double v) {
  // lane i adds lane i ^ m's value: both lanes of a pair form the same
  // sum (addition commutes), so every lane ends with the same bits
#pragma unroll
  for (int m = 16; m; m >>= 1) v += __shfl_xor_sync(kFull, v, m);
  return v;
}

// warp_sum of N values at once, level by level: the compiler keeps the
// shuffles in source order, so the trees overlap only when written so.
// Each value's tree is warp_sum's, to the bit.
template <int N>
__device__ __forceinline__ void warp_sums(double (&v)[N]) {
#pragma unroll
  for (int m = 16; m; m >>= 1) {
    double o[N];
#pragma unroll
    for (int i = 0; i < N; ++i) o[i] = __shfl_xor_sync(kFull, v[i], m);
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] += o[i];
  }
}

// The probe build's stamps: thread 0 of block 0 adds the clocks since its
// last stamp to a part's sum, and writes the sums and a count at the end
// to `probe_clocks`, which a probe entry point sets for its launch alone.
#if CM_PROBE
constexpr int kProbeParts = 8;  // a probe's clock sums, then a count
__device__ long long* probe_clocks = nullptr;

struct Stamps {
  long long sum[kProbeParts];
  long long last;
  bool on;
  __device__ void start(bool who) {
    on = who && probe_clocks;
    for (int i = 0; i < kProbeParts; ++i) sum[i] = 0;
    last = clock64();
  }
  __device__ void at(int part) {
    if (on) {
      const long long now = clock64();
      sum[part] += now - last;
      last = now;
    }
  }
  __device__ void write(long long count) const {
    if (on) {
      for (int i = 0; i < kProbeParts; ++i) probe_clocks[i] = sum[i];
      probe_clocks[kProbeParts] = count;
    }
  }
};
#else
struct Stamps {
  __device__ void start(bool) {}
  __device__ void at(int) {}
  __device__ void write(long long) const {}
};
#endif

// ---------------------------------------------------------------------------
// plan_solve
// ---------------------------------------------------------------------------
enum At { kUniform, kAtU, kShifted };  // v_c = x, u[group], u[group] + x

struct Plan {
  double* sums[2];  // two buffers of 4 x n: per cache Σ refw σ, Σ bytew σ,
                    // Σ refw σ(1−σ), Σ bytew σ(1−σ)
  double *tb, *of;  // per cache: total bytes, origin fraction
  double *u, *eu;   // per group: u and e^u
  double* bc;       // 2 x kTable: 1 − 0.9^t, 1 − 0.99^t
  uint64_t* mbar;   // a transaction barrier a buffer
  const double *centers, *refw, *bytew;  // (N, Bk) each
  int *group, *members, *offsets;        // group of a cache; the CSR
  int n, bk, g, rank, csize;
  double tau, total;
};

size_t plan_state_bytes(int n, int g) {  // two mbarriers first; the CSR
  return 16 +                               // and a fault flag last
         sizeof(double) * (10 * (size_t)n + 2 * (size_t)g + 2 * kTable) +
         sizeof(int) * (2 * (size_t)n + (size_t)g + 2);
}

// Transaction barriers and asynchronous remote stores.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ uint32_t remote_addr(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}
__device__ __forceinline__ void st_async(uint32_t addr, double v,
                                         uint32_t mbar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.f64 [%0], %1, "
      "[%2];" :: "r"(addr), "d"(v), "r"(mbar) : "memory");
}
__device__ __forceinline__ void mbar_init(uint32_t mbar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(mbar)
               : "memory");
}
__device__ __forceinline__ void mbar_expect(uint32_t mbar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(mbar), "r"(bytes) : "memory");
}
// Wait for the barrier's phase of this parity; false after ~2^26 tries
// (a missing transaction: the caller traps rather than hangs).
__device__ __forceinline__ bool mbar_wait(uint32_t mbar, uint32_t parity) {
  for (int i = 0; i < (1 << 26); ++i) {
    uint32_t done;
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], "
        "%2; selp.u32 %0, 1, 0, p; }"
        : "=r"(done) : "r"(mbar), "r"(parity) : "memory");
    if (done) return true;
  }
  return false;
}

int plan_threads(int n, int csize) {  // a warp a cache of the CTA's share
  const int share = (n + csize - 1) / csize, most = kPlanThreads / 32;
  return 32 * (share < 1 ? 1 : share > most ? most : share);
}

// One (cache, bucket) term: σ and σ(1 − σ) at ln C = logc.
__device__ __forceinline__ void bucket_term(double logc, double center,
                                            double tau, double& s,
                                            double& ds) {
  const double z = (logc - center) / tau;
  s = 1.0 / (1.0 + exp(-z));
  ds = s * (1.0 - s);
}

// The per-cache sums of this CTA's caches at log-capacities v_c (`mode`),
// written into buffer `buf` of every CTA of the cluster: lane j of the
// cache's warp sends CTA j's copy by st.async, counted on CTA j's
// transaction barrier for that buffer.
__device__ void evaluate(const Plan& P, int buf, At mode, double x,
                         bool bytes, bool grad, bool bgrad) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5, n = P.n;
  for (int c = P.rank + P.csize * warp; c < n; c += P.csize * nw) {
    const double e = mode == kUniform ? exp(x)
                     : mode == kAtU   ? P.eu[P.group[c]]
                                      : exp(P.u[P.group[c]] + x);
    const double logc = log(fmax(e, 1.0));
    const size_t row = (size_t)c * P.bk;
    double sr = 0.0, sb = 0.0, gr = 0.0, gb = 0.0;
    // two buckets' terms at once (independent chains), summed in order
    for (int b0 = lane; b0 < P.bk; b0 += 64) {
      double s[2], ds[2];
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (b0 + 32 * h < P.bk)
          bucket_term(logc, P.centers[row + b0 + 32 * h], P.tau, s[h],
                      ds[h]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int b = b0 + 32 * h;
        if (b >= P.bk) break;
        const double wr = P.refw[row + b];
        sr += wr * s[h];
        if (grad) gr += wr * ds[h];
        if (bytes || bgrad) {
          const double wb = P.bytew[row + b];
          if (bytes) sb += wb * s[h];
          if (bgrad) gb += wb * ds[h];
        }
      }
    }
    double v[4] = {sr, sb, gr, gb};
    warp_sums(v);
    sr = v[0];
    sb = v[1];
    gr = v[2];
    gb = v[3];
    if (lane < P.csize) {  // every lane holds the sums
      const uint32_t d = remote_addr(smem_addr(P.sums[buf]), lane);
      const uint32_t bar = remote_addr(smem_addr(P.mbar + buf), lane);
      st_async(d + 8 * c, sr, bar);
      if (bytes) st_async(d + 8 * (n + c), sb, bar);
      if (grad) st_async(d + 8 * (2 * n + c), gr, bar);
      if (bgrad) st_async(d + 8 * (3 * n + c), gb, bar);
    }
  }
}

// Fleet hit rate and origin egress from the per-cache sums: every warp
// forms the same sums in the same order.
__device__ void totals(const Plan& P, int buf, bool bytes, double& hit,
                       double& egress) {
  const double* S = P.sums[buf];
  double h = 0.0, e = 0.0;
  for (int c = threadIdx.x & 31; c < P.n; c += 32) {
    h += S[c];
    if (bytes) e += P.of[c] * (P.tb[c] - S[P.n + c]);
  }
  double v[2] = {h, e};
  warp_sums(v);
  hit = v[0] / P.total;
  egress = v[1];
}

// Σ_{c∈k} ct_c / e^{u_k}, ct_c the cotangent of cache c's ln C.
__device__ double group_ct(const Plan& P, int buf, int k, double eu,
                           double ct_hits, double ct_egress, bool budget) {
  const double* S = P.sums[buf];
  double acc = 0.0;
  if (eu > 1.0)  // ln max(C, 1) has no gradient below 1
    for (int j = P.offsets[k]; j < P.offsets[k + 1]; ++j) {
      const int c = P.members[j];
      double ct = ct_hits * S[2 * P.n + c];
      if (budget) ct = ct - ct_egress * (P.of[c] * S[3 * P.n + c]);
      acc += (ct / P.tau) / eu;
    }
  return acc;
}

// One group's Adam step from its gradient: the moments in place, the new
// (clipped) u returned.
__device__ __forceinline__ double adam_step(double u, double grad,
                                            double& mom, double& vel,
                                            double bc1, double bc2,
                                            double lr, double lo,
                                            double hi) {
  const double m = 0.9 * mom + 0.1 * grad;
  const double v = 0.99 * vel + 0.01 * grad * grad;
  mom = m;
  vel = v;
  const double un = u - lr * (m / bc1) / (sqrt(v / bc2) + 1e-8);
  return fmin(fmax(un, lo), hi);
}

__global__ void __launch_bounds__(kPlanThreads) plan_solve_kernel(
    const double* __restrict__ stacked, const double* __restrict__ per_cache,
    const long long* __restrict__ gidx, const double* __restrict__ gsize,
    const double* __restrict__ scalars, int n, int bk, int g, int inner,
    double* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31;
  const int csize = (int)cluster.num_blocks();
  const size_t nb = (size_t)n * bk, plan = blockIdx.x / csize;
  const double* model = stacked + plan * 3 * nb;
  const double* pc = per_cache + plan * 3 * n;
  const long long* gi = gidx + plan * n;
  const double* gsz = gsize + plan * g;
  const double* sc = scalars + plan * 8;
  double* o = out + plan * (g + 4);
  const double target = sc[0], budget = sc[1], lo = sc[2], hi = sc[3];
  const double lr = sc[5], penalty = sc[6], rho_growth = sc[7];
  const bool has_budget = budget == budget;  // NaN: no egress budget
  const double bdiv = budget > 1.0 ? budget : 1.0;
  Stamps stamp;
  stamp.start(blockIdx.x == 0 && tid == 0);

  Plan P;
  P.mbar = reinterpret_cast<uint64_t*>(smem);
  double* d = reinterpret_cast<double*>(smem + 16);
  P.sums[0] = d;
  P.sums[1] = d + 4 * n;
  P.tb = d + 8 * n;
  P.of = d + 9 * n;
  P.u = d + 10 * n;
  P.eu = P.u + g;
  P.bc = P.eu + g;
  int* ints = reinterpret_cast<int*>(P.bc + 2 * kTable);
  P.group = ints;
  P.members = ints + n;
  P.offsets = ints + 2 * n;
  int& bad = P.offsets[g + 1];
  P.n = n;
  P.bk = bk;
  P.g = g;
  P.rank = (int)cluster.block_rank();
  P.csize = csize;
  P.tau = sc[4];

  if (tid == 0) {
    bad = 0;
    mbar_init(smem_addr(P.mbar));
    mbar_init(smem_addr(P.mbar + 1));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  for (int c = tid; c < n; c += nt) {
    P.tb[c] = pc[n + c];
    P.of[c] = pc[2 * n + c];
    const long long q = gi[c];
    const bool ok = q >= 0 && q < g;
    if (!ok) atomicOr(&bad, 1);
    P.group[c] = ok ? (int)q : 0;
  }
  // this thread's groups (tid, tid + nt): sizes and moments in registers
  double gs[kGroupSlots], mom[kGroupSlots], vel[kGroupSlots], u[kGroupSlots];
#pragma unroll
  for (int s = 0; s < kGroupSlots; ++s) {
    const int k = tid + s * nt;
    gs[s] = k < g ? gsz[k] : 0.0;
    mom[s] = 0.0;
    vel[s] = 0.0;
  }
  P.centers = model;
  P.refw = P.centers + nb;
  P.bytew = P.refw + nb;
  {
    double s = 0.0;
    for (int c = lane; c < n; c += 32) s += pc[c];
    s = warp_sum(s);
    P.total = s > 1.0 ? s : 1.0;
  }
  __syncthreads();
  // the groups' member lists, each in cache order
  for (int k = tid; k < g; k += nt) {
    int count = 0;
    for (int c = 0; c < n; ++c) count += P.group[c] == k;
    P.offsets[k + 1] = count;
  }
  __syncthreads();
  if (tid == 0) {
    P.offsets[0] = 0;
    for (int k = 0; k < g; ++k) P.offsets[k + 1] += P.offsets[k];
  }
  __syncthreads();
  for (int k = tid; k < g; k += nt) {
    int at = P.offsets[k];
    for (int c = 0; c < n; ++c)
      if (P.group[c] == k) P.members[at++] = c;
  }
  // every CTA of the cluster runs and is set up before any CTA writes
  // into another's shared memory
  cluster.sync();
  if (bad) {  // a cache's group out of range: no plan (in every CTA)
    if (P.rank == 0)
      for (int k = tid; k < g + 4; k += nt)
        o[k] = __longlong_as_double(0x7ff8000000000000LL);
    return;
  }
  stamp.at(7);

  int buf = 0;             // the buffer this stage's sums go to
  long long stages = 0;
  double hit, egress;
  uint32_t parity[2] = {0, 0};  // each buffer's barrier phase
  // one stage: the evaluation into `buf`, the wait on the buffer's
  // transaction barrier, totals
  // (`synced`: a block barrier since the last stage's reads already)
  auto stage = [&](At mode, double x, bool bytes, bool grad, bool bgrad,
                   bool synced) {
    // every warp of this CTA is done reading the last stage's buffer: the
    // others write it again only after they have this stage's sums, which
    // this CTA sends after this barrier
    if (!synced) __syncthreads();
    stamp.at(6);
    evaluate(P, buf, mode, x, bytes, grad, bgrad);
    stamp.at(0);
    if (tid == 0)  // every cache's sums from every CTA, 8 B each (after
                   // this thread's own sends: they may count first)
      mbar_expect(smem_addr(P.mbar + buf),
                  8u * n * (1u + bytes + grad + bgrad));
    if (!mbar_wait(smem_addr(P.mbar + buf), parity[buf])) __trap();
    parity[buf] ^= 1u;
    stamp.at(1);
    totals(P, buf, bytes, hit, egress);
    stamp.at(2);
    ++stages;
  };
  // 1. the uniform capacity: the smallest u in [lo, hi] meeting the target
  double a = lo, b = hi;
  for (int it = 0; it < kBisect; ++it) {
    const double mid = 0.5 * (a + b);
    stage(kUniform, mid, has_budget, false, false, it == 0);
    const bool good = hit >= target && (!has_budget || egress <= budget);
    a = good ? a : mid;
    b = good ? mid : b;
    buf ^= 1;
  }
  const double u_uni = b, e_uni = exp(u_uni);
  for (int k = tid; k < g; k += nt) {
    P.u[k] = u_uni;
    P.eu[k] = e_uni;
  }
#pragma unroll
  for (int s = 0; s < kGroupSlots; ++s) u[s] = u_uni;
  double scale;
  {
    double s = 0.0;
    for (int k = lane; k < g; k += 32) s += gsz[k] * e_uni;
    s = warp_sum(s);
    scale = s > 1.0 ? s : 1.0;
  }
  const double inv_scale = 1.0 / scale;
  __syncthreads();

  // 2. the augmented-Lagrangian rounds
  double nu = 0.0, nu2 = 0.0, rho = penalty;
  for (int r = 0; r < kRounds; ++r) {
    for (int i = 0; i < inner; ++i) {
      const int step = r * inner + i;
      if (step % kTable == 0) {  // the next kTable steps' corrections
        for (int j = tid; j < kTable; j += nt) {
          const double t = (double)(step + j) + 1.0;
          P.bc[j] = 1.0 - pow(0.9, t);
          P.bc[kTable + j] = 1.0 - pow(0.99, t);
        }
        // the table before any thread reads it, whatever the stage's own
        // barrier (once in kTable steps)
        __syncthreads();
        stamp.at(5);
      }
      // synced after the last step's barrier, not after a round's end
      stage(kAtU, 0.0, has_budget, true, has_budget, r == 0 || i > 0);
      const double aug = fmax(nu + rho * (target - hit), 0.0);
      const double ct_hits =
          -(((1.0 / (2.0 * rho)) * (2.0 * aug)) * rho) / P.total;
      double ct_egress = 0.0;
      if (has_budget) {
        const double aug2 =
            fmax(nu2 + rho * ((egress - budget) / bdiv), 0.0);
        ct_egress = (((1.0 / (2.0 * rho)) * (2.0 * aug2)) * rho) / bdiv;
      }
      const double bc1 = P.bc[step % kTable];
      const double bc2 = P.bc[kTable + step % kTable];
#pragma unroll
      for (int s = 0; s < kGroupSlots; ++s) {
        const int k = tid + s * nt;
        if (k < g) {
          const double eu = P.eu[k];
          const double acc = group_ct(P, buf, k, eu, ct_hits, ct_egress,
                                      has_budget);
          const double grad = (inv_scale * gs[s]) * eu + acc * eu;
          u[s] = adam_step(u[s], grad, mom[s], vel[s], bc1, bc2, lr, lo, hi);
          P.u[k] = u[s];
          P.eu[k] = exp(u[s]);  // for the next evaluation and gradient
        }
      }
      stamp.at(3);
      buf ^= 1;
      __syncthreads();       // u and e^u before this CTA's next evaluation
      stamp.at(4);
    }
    stage(kAtU, 0.0, has_budget, false, false, true);
    nu = fmax(nu + rho * (target - hit), 0.0);
    if (has_budget) nu2 = fmax(nu2 + rho * (egress - budget) / bdiv, 0.0);
    rho = rho * rho_growth;
    buf ^= 1;
  }

  // 3. the repair: the smallest shift s in [-8, 8] making u + s feasible
  a = -8.0;
  b = 8.0;
  for (int it = 0; it < kBisect; ++it) {
    const double mid = 0.5 * (a + b);
    stage(kShifted, mid, has_budget, false, false, false);
    const bool good = hit >= target && (!has_budget || egress <= budget);
    a = good ? a : mid;
    b = good ? mid : b;
    buf ^= 1;
  }
#pragma unroll
  for (int s = 0; s < kGroupSlots; ++s) {
    const int k = tid + s * nt;
    if (k < g) {
      u[s] = fmin(fmax(u[s] + b, lo), hi);
      P.u[k] = u[s];
      P.eu[k] = exp(u[s]);
    }
  }
  __syncthreads();

  // 4. the end point: hit rate, egress and |∂hit/∂u|
  stage(kAtU, 0.0, true, true, false, true);
  if (P.rank == 0) {
    if (tid < 32) {
      double s2 = 0.0;
      for (int k = lane; k < g; k += 32) {
        const double eu = P.eu[k];
        const double gk =
            group_ct(P, buf, k, eu, 1.0 / P.total, 0.0, false) * eu;
        s2 += gk * gk;
      }
      s2 = warp_sum(s2);
      if (tid == 0) {
        o[g] = exp(u_uni);
        o[g + 1] = hit;
        o[g + 2] = egress;
        o[g + 3] = sqrt(s2);
      }
    }
    for (int k = tid; k < g; k += nt) o[k] = P.eu[k];
  }
  stamp.write(stages);
}

// ---------------------------------------------------------------------------
// mixture_fit
// ---------------------------------------------------------------------------
// Warps a fit's block: a point a thread, and two at least (warp 0 holds
// the logits, warp 1 the means and log σ's).
int mixture_warps(int m) { return m > 32 ? (m + 31) / 32 : 2; }

size_t mixture_smem_bytes(int m, int k) {
  const size_t warps = mixture_warps(m);
  return sizeof(double) *
         (6 * (size_t)k + 2 * kTable   // π, μ, σ√2 twice; the corrections
          + warps * (3 * k + 1));      // each warp's 3K + 1 sums
}

// The next step's π, μ and σ√2 (into `sp`: π, then μ, then σ√2) from the
// parameters as they stand, by the warps that hold them: warp 0 forms
// the softmax of the logits (lane j < K holding logit j, a shuffle a
// component), and each lane of warp 1 holding a mean or a log σ stores
// its own.
template <int K>
__device__ void publish_mixture(double prm, int pidx, int warp, int lane,
                                double* sp) {
  if (warp == 0) {
    double g[K];  // the logits, gathered before the max
#pragma unroll
    for (int j = 0; j < K; ++j) g[j] = __shfl_sync(kFull, prm, j);
    double mx = g[0];
#pragma unroll
    for (int j = 1; j < K; ++j) mx = fmax(mx, g[j]);
    const double e = exp(prm - mx);  // on lane j < K: logit j's
#pragma unroll
    for (int j = 0; j < K; ++j) g[j] = __shfl_sync(kFull, e, j);
    double se = 0.0;
#pragma unroll
    for (int j = 0; j < K; ++j) se += g[j];
    const double pi = e / se;
    if (lane < K) sp[lane] = pi;
  } else {
    // every lane takes it (no divergent paths), the σ lanes keep it
    const double den = exp(prm) * kSqrt2;
    if (pidx >= K && pidx < 2 * K)
      sp[pidx] = prm;
    else if (pidx >= 2 * K)
      sp[pidx] = den;
  }
}

// A fit of K components (a template: every loop over the components
// unrolls, and no shuffle sits behind a branch).
template <int K>
__global__ void __launch_bounds__(kMixMaxPoints) mixture_fit_kernel(
    const double* __restrict__ params0, const double* __restrict__ grid,
    const double* __restrict__ target, int m, int steps, double lr,
    double* __restrict__ params_out, double* __restrict__ loss_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int np = 3 * K, nv = 3 * K + 1;
  constexpr int kMaxWarps = kMixMaxPoints / 32;
  static_assert(kMaxWarps >= 2, "a fit's block has two warps at least");
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nt = blockDim.x, pw = nt >> 5;
  const int i = tid;  // this thread's point
  const size_t fit = blockIdx.x;
  // π, μ and σ√2 twice (a step reads one copy while the next is formed)
  double* sp2 = reinterpret_cast<double*>(smem);
  double* bc = sp2 + 2 * np;  // 2 x kTable: 1 − 0.9^t, 1 − 0.999^t
  double* part = bc + 2 * kTable;  // pw x nv: each warp's sums
  Stamps stamp;
  stamp.start(blockIdx.x == 0 && tid == 0);
  // The parameters and their moments, in registers: lane j < K of warp
  // 0 holds logit j and lane j < 2K of warp 1 parameter K + j (the means,
  // then the log σ), so the softmax's chain and the others' run in two
  // warps.
  const int pidx = warp == 0 ? (lane < K ? lane : -1)
                   : (warp == 1 && lane < 2 * K) ? K + lane : -1;
  const bool updater = warp < 2;
  double prm = pidx >= 0 ? params0[fit * np + pidx] : 0.0;
  double mom = 0.0, vel = 0.0;
  const bool live = i < m;
  const double x = live ? grid[fit * m + i] : 0.0;
  const double y = live ? target[fit * m + i] : 0.0;
  double loss = 0.0;
  if (updater) publish_mixture<K>(prm, pidx, warp, lane, sp2);
  __syncthreads();
  stamp.at(7);
  for (int step = 0; step < steps; ++step) {
    const double* spi = sp2 + (step & 1) * np;  // this step's π
    const double* smu = spi + K;                // μ
    const double* sden = smu + K;               // σ√2
    if (step % kTable == 0) {  // the next kTable steps' bias corrections
      for (int j = tid; j < kTable; j += nt) {
        const double t = (double)(step + j) + 1.0;
        bc[j] = 1.0 - pow(0.9, t);
        bc[kTable + j] = 1.0 - pow(0.999, t);
      }
      stamp.at(5);
    }
    double zz[K], ez[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      zz[j] = (x - smu[j]) / sden[j];
      ez[j] = erf(zz[j]);
    }
    double pred = 0.0;
#pragma unroll
    for (int j = 0; j < K; ++j) pred += (spi[j] * 0.5) * (1.0 + ez[j]);
    stamp.at(0);
    const double r = pred - y;
    const double ct = live ? (2.0 * r) / m : 0.0;
    // the 3K + 1 sums: r², then per component the ∂π, ∂log σ and ∂μ
    // terms, in part's order
    double v[nv];
    v[0] = live ? r * r : 0.0;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const double e = ct * exp(-(zz[j] * zz[j]));
      v[1 + j] = ct * (1.0 + ez[j]);
      v[1 + K + j] = e;
      v[1 + 2 * K + j] = e * zz[j];
    }
    warp_sums(v);
    if (lane == 0)
#pragma unroll
      for (int j = 0; j < nv; ++j) part[warp * nv + j] = v[j];
    stamp.at(1);
    __syncthreads();
    stamp.at(2);
    if (updater) {
      // a parameter's slot summed over the warps in order (the slots
      // loaded first); the loss, from slot 0, only at the last step
      double slot[kMaxWarps];
#pragma unroll
      for (int q = 0; q < kMaxWarps; ++q)
        if (q < pw) slot[q] = pidx >= 0 ? part[q * nv + 1 + pidx] : 0.0;
      double s = 0.0;
#pragma unroll
      for (int q = 0; q < kMaxWarps; ++q)
        if (q < pw) s += slot[q];
      const int kind = pidx / K, j = pidx >= 0 ? pidx - kind * K : 0;
      const double pj = spi[j];
      // the three kinds' gradients: ∂/∂logit through the softmax (warp
      // 0), ∂/∂μ and ∂/∂log σ; every lane of a warp forms its warp's
      // kinds (no divergent paths) and keeps its own
      double grad;
      if (warp == 0) {
        const double ct_pi = 0.5 * s;   // on lane q < K: ∂L/∂π_q
        double cq[K];
#pragma unroll
        for (int q = 0; q < K; ++q) cq[q] = __shfl_sync(kFull, ct_pi, q);
        double dot = 0.0;
#pragma unroll
        for (int q = 0; q < K; ++q) dot += spi[q] * cq[q];
        grad = pj * (ct_pi - dot);
      } else {
        const double g_sigma = -((pj / kSqrtPi) * s);
        const double g_mu = g_sigma / sden[j];
        grad = kind == 1 ? g_mu : g_sigma;
      }
      if (pidx >= 0) {
        const int at = step % kTable;
        const double mm = 0.9 * mom + 0.1 * grad;
        const double vv = 0.999 * vel + 0.001 * grad * grad;
        mom = mm;
        vel = vv;
        prm = prm - lr * (mm / bc[at]) / (sqrt(vv / bc[kTable + at]) + 1e-8);
      }
      stamp.at(3);
      publish_mixture<K>(prm, pidx, warp, lane,
                         sp2 + ((step + 1) & 1) * np);
      if (tid == 0 && step == steps - 1) {
        double sl = 0.0;
        for (int q = 0; q < pw; ++q) sl += part[q * nv];
        loss = sl / m;
      }
    }
    stamp.at(6);
    __syncthreads();
    stamp.at(4);
  }
  if (pidx >= 0) params_out[fit * np + pidx] = prm;
  if (tid == 0) loss_out[fit] = loss;
  stamp.write(steps);
}

template <int K>
cudaError_t launch_mixture(const double* params0, const double* grid,
                           const double* target, int batch, int m, int k,
                           int steps, double lr, double* params_out,
                           double* loss_out, cudaStream_t stream) {
  if (k != K)
    return launch_mixture<(K < kMixMaxK ? K + 1 : K)>(
        params0, grid, target, batch, m, k, steps, lr, params_out, loss_out,
        stream);
  static bool raised[64] = {};  // the smem limit, once a device
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= 64 || !raised[device]) {
    err = cudaFuncSetAttribute(mixture_fit_kernel<K>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               int(kBlockSmem));
    if (err != cudaSuccess) {
      cudaGetLastError();
      return err;
    }
    if (device < 64) raised[device] = true;
  }
  mixture_fit_kernel<K><<<batch, 32 * mixture_warps(m),
                          mixture_smem_bytes(m, K), stream>>>(
      params0, grid, target, m, steps, lr, params_out, loss_out);
  return cudaGetLastError();
}

#if CM_PROBE
// The probe build's terms alone, for their SASS (kernel_probe.py counts
// their float64 instructions): one (cache, bucket) term of an evaluation
// with every sum on, one cache's log-capacity, one group's step with one
// member, a division, a bias correction by pow.
__global__ void probe_bucket_term(const double* in, double* out) {
  double s, ds;
  bucket_term(in[0], in[1], in[2], s, ds);
  out[0] = in[5] + in[3] * s;
  out[1] = in[6] + in[3] * ds;
  out[2] = in[7] + in[4] * s;
  out[3] = in[8] + in[4] * ds;
}

__global__ void probe_cache_head(const double* in, double* out) {
  out[0] = log(fmax(exp(in[0] + in[1]), 1.0));
}

__global__ void probe_group_step(const double* in, double* out) {
  double mom = in[4], vel = in[5];
  const double eu = in[0];
  double ct = in[12] * in[13];  // one member's cotangent, under a budget
  ct = ct - in[14] * (in[15] * in[16]);
  const double acc = in[3] + (ct / in[17]) / eu;
  const double grad = (in[1] * in[2]) * eu + acc * eu;
  const double u = adam_step(in[6], grad, mom, vel, in[7], in[8], in[9],
                             in[10], in[11]);
  out[0] = u;
  out[1] = exp(u);
  out[2] = mom + vel;
}

__global__ void probe_division(const double* in, double* out) {
  out[0] = in[0] / in[1];
}

// A bias correction as the one-block design took it every step.
__global__ void probe_pow(const double* in, double* out) {
  out[0] = 1.0 - pow(0.9, in[0]);
}

// One grid point's one component of a mixture step, and one parameter's
// update with its share of the next step's broadcast.
__global__ void probe_mixture_term(const double* in, double* out) {
  const double zz = (in[0] - in[1]) / in[2];
  const double ez = erf(zz);
  const double ct = in[5];
  const double e = ct * exp(-(zz * zz));
  out[0] = in[3] + (in[4] * 0.5) * (1.0 + ez);
  out[1] = ct * (1.0 + ez);
  out[2] = e * zz;
  out[3] = e;
}

__global__ void probe_mixture_update(const double* in, double* out) {
  const double grad = -((in[0] / kSqrtPi) * in[1]) / in[2];
  const double mm = 0.9 * in[3] + 0.1 * grad;
  const double vv = 0.999 * in[4] + 0.001 * grad * grad;
  const double p = in[5] - in[6] * (mm / in[7]) / (sqrt(vv / in[8]) + 1e-8);
  out[0] = p;
  out[1] = mm + vv;
  out[2] = exp(p - in[9]) / in[10];
  out[3] = exp(p) * kSqrt2;
}
#endif

// Raise the plan kernel's dynamic shared-memory limit to a block's most
// and allow 16-CTA clusters, once a device.
cudaError_t prepare_plan() {
  static bool done[64] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 64 && done[device]) return cudaSuccess;
  err = cudaFuncSetAttribute((const void*)plan_solve_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(kBlockSmem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        (const void*)plan_solve_kernel,
        cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) {
    cudaGetLastError();  // reported here: not to a later launch
    return err;
  }
  if (device < 64) done[device] = true;
  return cudaSuccess;
}

void plan_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr,
                 int batch, int n, int g, int csize) {
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(batch * csize);
  cfg.blockDim = dim3(plan_threads(n, csize));
  cfg.dynamicSmemBytes = plan_state_bytes(n, g);
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = csize;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
}

// CTAs a plan: 8 (fewer below 8 caches, a power of two), 16 from kWideFrom
// caches where the card can schedule such a cluster at this size.
int plan_cluster(int n, int g) {
  int c = n >= kWideFrom ? kClusterWide : kCluster;
  while (c > n) c >>= 1;
  if (c == kClusterWide) {
    static int known[64][3] = {};  // a device's last (n, g, answer)
    int device = 0;
    if (cudaGetDevice(&device) != cudaSuccess || device >= 64) {
      cudaGetLastError();
      return kCluster;
    }
    int* seen = known[device];
    if (seen[0] != n || seen[1] != g) {
      cudaLaunchConfig_t cfg;
      cudaLaunchAttribute attr;
      plan_config(cfg, attr, 1, n, g, kClusterWide);
      int clusters = 0;
      if (prepare_plan() != cudaSuccess ||
          cudaOccupancyMaxActiveClusters(
              &clusters, (const void*)plan_solve_kernel, &cfg) !=
              cudaSuccess) {
        cudaGetLastError();
        clusters = 0;
      }
      seen[0] = n;
      seen[1] = g;
      seen[2] = clusters > 0 ? kClusterWide : kCluster;
    }
    c = seen[2];
  }
  return c;
}

cudaError_t launch_plan(const double* stacked, const double* per_cache,
                        const long long* gidx, const double* gsize,
                        const double* scalars, int batch, int n, int bk,
                        int g, int inner, int csize, double* out,
                        cudaStream_t stream) {
  if (batch < 1 || n < 1 || n > kMaxCaches || g < 1 || g > n || bk < 1 ||
      inner < 1)
    return cudaErrorInvalidValue;
  cudaError_t err = prepare_plan();
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  plan_config(cfg, attr, batch, n, g, csize);
  cfg.stream = stream;
  err = cudaLaunchKernelEx(&cfg, plan_solve_kernel, stacked, per_cache,
                           gidx, gsize, scalars, n, bk, g, inner, out);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

cudaError_t launch_mixture_fit(const double* params0, const double* grid,
                               const double* target, int batch, int m, int k,
                               int steps, double lr, double* params_out,
                               double* loss_out, cudaStream_t stream) {
  if (batch < 1 || m < 1 || m > kMixMaxPoints || k < 1 || k > kMixMaxK ||
      steps < 0)
    return cudaErrorInvalidValue;
  return launch_mixture<1>(params0, grid, target, batch, m, k, steps, lr,
                           params_out, loss_out, stream);
}

#if CM_PROBE
// Points the stamps at `clocks` for the launches that follow on `stream`
// (null after a probe's launch, so a launch without clocks copies nothing).
cudaError_t set_probe_clocks(long long* clocks, cudaStream_t stream) {
  return cudaMemcpyToSymbolAsync(probe_clocks, &clocks, sizeof(clocks), 0,
                                 cudaMemcpyHostToDevice, stream);
}
#endif

}  // namespace

extern "C" {

const char* cache_model_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int plan_solve_cluster(int n, int g) { return plan_cluster(n, g); }

int plan_solve_threads(int n, int g) {
  return plan_threads(n, plan_cluster(n, g));
}

long long plan_solve_smem_bytes(int n, int g) {
  return (long long)plan_state_bytes(n, g);
}

// stacked (B x 3 x n x bk), per_cache (B x 3 x n), gidx (B x n) int64,
// gsize (B x g), scalars (B x 8) → out (B x (g + 4)); see the wrapper.
int plan_solve(const double* stacked, const double* per_cache,
               const long long* gidx, const double* gsize,
               const double* scalars, int batch, int n, int bk, int g,
               int inner, double* out, void* stream) {
  if (n < 1 || g < 1) return cudaErrorInvalidValue;
  return launch_plan(stacked, per_cache, gidx, gsize, scalars, batch, n, bk,
                     g, inner, plan_cluster(n, g), out,
                     static_cast<cudaStream_t>(stream));
}

// params0 (B x 3 x k), grid and target (B x m) → params_out (B x 3 x k),
// loss_out (B).
int mixture_fit(const double* params0, const double* grid,
                const double* target, int batch, int m, int k, int steps,
                double lr, double* params_out, double* loss_out,
                void* stream) {
  return launch_mixture_fit(params0, grid, target, batch, m, k, steps, lr,
                            params_out, loss_out,
                            static_cast<cudaStream_t>(stream));
}

#if CM_PROBE
// A cluster size's threads a CTA.
int plan_solve_threads_at(int n, int csize) { return plan_threads(n, csize); }

// plan_solve on a cluster of `cluster` CTAs (1 to 16), its clock sums
// (kProbeParts + 1) into `clocks` where it is not null.
int plan_solve_probe(const double* stacked, const double* per_cache,
                     const long long* gidx, const double* gsize,
                     const double* scalars, int batch, int n, int bk, int g,
                     int inner, int cluster, double* out, long long* clocks,
                     void* stream) {
  if (cluster < 1 || cluster > kClusterWide) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = clocks ? set_probe_clocks(clocks, s) : cudaSuccess;
  if (err == cudaSuccess)
    err = launch_plan(stacked, per_cache, gidx, gsize, scalars, batch, n, bk,
                      g, inner, cluster, out, s);
  const cudaError_t reset =
      clocks ? set_probe_clocks(nullptr, s) : cudaSuccess;
  return err != cudaSuccess ? err : reset;
}

// mixture_fit with its clock sums into `clocks`, as plan_solve_probe's.
int mixture_fit_probe(const double* params0, const double* grid,
                      const double* target, int batch, int m, int k,
                      int steps, double lr, double* params_out,
                      double* loss_out, long long* clocks, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = clocks ? set_probe_clocks(clocks, s) : cudaSuccess;
  if (err == cudaSuccess)
    err = launch_mixture_fit(params0, grid, target, batch, m, k, steps, lr,
                             params_out, loss_out, s);
  const cudaError_t reset =
      clocks ? set_probe_clocks(nullptr, s) : cudaSuccess;
  return err != cudaSuccess ? err : reset;
}
#endif

}  // extern "C"
