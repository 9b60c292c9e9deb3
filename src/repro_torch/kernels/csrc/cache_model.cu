// The capacity planner's two loops for Hopper (sm_90a), in float64: the
// inverse solve (`plan_solve`, a block a plan) and the log-normal mixture
// fit (`mixture_fit`, a block a histogram), each whole loop inside one
// launch.
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
// steps), each a block-wide pass over N caches x Bk buckets (an exp and a
// division each) and two barriers; a fit is `steps` dependent passes over
// its grid.  Bytes are nothing: the model comes from device memory once,
// then from L1 and L2.
//
// plan_solve.  One warp a cache (caches warp, warp + warps, ...), lane l
// over the buckets l, l + 32, ... in order, folded by an xor-shuffle
// tree: per cache the sums Σ_b w_b σ and Σ_b w_b σ(1 − σ) of the
// reference weights and, where asked, the byte weights, at
// σ = σ((ln max(e^v, 1) − m_b)/τ).  Then every warp sums the per-cache
// values in the same order (lane l over caches l, l + 32, ..., the same
// tree), so every thread holds the fleet hit rate and egress without
// another barrier, and decides a bisection step or the Adam step alike.
// The gradient is analytic, not taped:
//   ∂L/∂u_g = gsize_g e^{u_g} / scale
//           + e^{u_g} Σ_{c∈g} (ct_hits · R'_c − ct_egress · of_c · B'_c)/τ / C_c
// with R'_c = Σ_b refw σ(1 − σ), B'_c the same over byte weights,
// ct_hits = −aug/Σrefs and ct_egress = aug₂/max(budget, 1) (each formed as
// autograd forms it, through (aug² − ν²)/(2ρ)), and no constraint term
// where C_c = e^{u_g} ≤ 1 (the max(C, 1) inside the log).  A thread a
// group (groups t, t + threads, ...) sums its caches in the order of the
// group's member list, built in the block once (a CSR by cache index), and
// takes the Adam step (β₁ 0.9, β₂ 0.99, ε 1e-8, t = r·inner + i + 1, the
// bias corrections by pow) and the clip to [lo, hi].
//   The stacked model (3 x N x Bk doubles) is read from device memory
// through L1 and L2 on every pass (28 caches x 64 buckets: 43 KB; 252 x
// 64: 387 KB).  The kernel serves N <= 2048 caches, 1 <= G <= N groups and
// any Bk; the state in shared memory is 48 B a cache, 32 B a group and
// 4 B a cache and a group for the lists (188 KB at 2048).
//
// mixture_fit.  A thread a grid point (M <= 256, K <= 8 components): the
// softmax of the logits and each component's e^{log σ}·√2 from shared
// memory, the CDF Σ_k (π_k·0.5)(1 + erf z_k), and the point's terms of the
// loss mean(r²) and of its gradient: with ct = 2r/M,
//   Σ ct (1 + erf z_k) → ∂L/∂π_k (·0.5), then the softmax's Jacobian;
//   Σ ct e^{−z_k²}     → ∂L/∂μ_k = −(π_k/√π)·Σ / (σ_k√2);
//   Σ ct e^{−z_k²} z_k → ∂L/∂log σ_k = −(π_k/√π)·Σ;
// each folded by the xor tree, one slot a warp, summed over the warps in
// order by the thread of each parameter, which takes its Adam step (β₂
// 0.999, t = i + 1).  The loss returned is the one the last step evaluated
// before its update, as the reference's.
//
// Determinism: no atomics on floats and no order that depends on
// scheduling, so two launches on the same inputs give the same bits.  The
// library is built with --fmad=false: every product and sum rounds once,
// as the plain version's torch ops do, and no FMA is contracted.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kRounds = 8;             // augmented-Lagrangian rounds
constexpr int kBisect = 64;            // steps of each bisection
// the sizes served, from the wrapper (kernels/cache_model.py) with -D
constexpr int kMaxCaches = PLAN_MAX_CACHES;
constexpr int kMixMaxK = MIX_MAX_COMPONENTS;
constexpr int kMixMaxPoints = MIX_MAX_POINTS;
constexpr size_t kBlockSmem = 232448;  // what a block may have on Hopper
constexpr double kSqrt2 = 1.4142135623730951;
constexpr double kSqrtPi = 1.7724538509055159;

__device__ __forceinline__ double warp_sum(double v) {
  // lane i adds lane i ^ m's value: both lanes of a pair form the same
  // sum (addition commutes), so every lane ends with the same bits
#pragma unroll
  for (int m = 16; m; m >>= 1) v += __shfl_xor_sync(kFull, v, m);
  return v;
}

// ---------------------------------------------------------------------------
// plan_solve
// ---------------------------------------------------------------------------
struct Plan {
  double *hr, *hb, *dr, *db;  // per cache: Σ refw σ, Σ bytew σ, and σ(1−σ)'s
  double *tb, *of;            // per cache: total bytes, origin fraction
  double *u, *mom, *vel, *gs; // per group
  const double *centers, *refw, *bytew;  // (N, Bk) each
  int *cg, *members, *offsets;           // group of a cache; the CSR
  int n, bk, g;
  double tau, total;
};

size_t plan_state_bytes(int n, int g) {  // the CSR and a fault flag last
  return sizeof(double) * (6 * (size_t)n + 4 * (size_t)g) +
         sizeof(int) * (2 * (size_t)n + (size_t)g + 2);
}

int plan_threads(int n) { return 32 * (n < 32 ? (n > 0 ? n : 1) : 32); }

// The per-cache sums at log-capacities v_c = x (uniform) or u[group] + x.
__device__ void evaluate(const Plan& P, double x, bool uniform, bool bytes,
                         bool grad, bool bgrad) {
  const int lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  for (int c = threadIdx.x >> 5; c < P.n; c += nw) {
    const double v = uniform ? x : P.u[P.cg[c]] + x;
    const double logc = log(fmax(exp(v), 1.0));
    const size_t row = (size_t)c * P.bk;
    double sr = 0.0, sb = 0.0, gr = 0.0, gb = 0.0;
    for (int b = lane; b < P.bk; b += 32) {
      const double z = (logc - P.centers[row + b]) / P.tau;
      const double s = 1.0 / (1.0 + exp(-z));
      const double ds = s * (1.0 - s);
      const double wr = P.refw[row + b];
      sr += wr * s;
      if (grad) gr += wr * ds;
      if (bytes || bgrad) {
        const double wb = P.bytew[row + b];
        if (bytes) sb += wb * s;
        if (bgrad) gb += wb * ds;
      }
    }
    sr = warp_sum(sr);
    if (bytes) sb = warp_sum(sb);
    if (grad) gr = warp_sum(gr);
    if (bgrad) gb = warp_sum(gb);
    if (lane == 0) {
      P.hr[c] = sr;
      P.hb[c] = sb;
      P.dr[c] = gr;
      P.db[c] = gb;
    }
  }
}

// Fleet hit rate and origin egress from the per-cache sums: every warp
// forms the same sums in the same order.
__device__ void totals(const Plan& P, bool bytes, double& hit,
                       double& egress) {
  double h = 0.0, e = 0.0;
  for (int c = threadIdx.x & 31; c < P.n; c += 32) {
    h += P.hr[c];
    if (bytes) e += P.of[c] * (P.tb[c] - P.hb[c]);
  }
  hit = warp_sum(h) / P.total;
  egress = warp_sum(e);
}

// Σ_{c∈k} ct_c / e^{u_k}, ct_c the cotangent of cache c's ln C.
__device__ double group_ct(const Plan& P, int k, double eu, double ct_hits,
                           double ct_egress, bool budget) {
  double acc = 0.0;
  if (eu > 1.0)  // ln max(C, 1) has no gradient below 1
    for (int j = P.offsets[k]; j < P.offsets[k + 1]; ++j) {
      const int c = P.members[j];
      double ct = ct_hits * P.dr[c];
      if (budget) ct = ct - ct_egress * (P.of[c] * P.db[c]);
      acc += (ct / P.tau) / eu;
    }
  return acc;
}

__global__ void __launch_bounds__(1024) plan_solve_kernel(
    const double* __restrict__ stacked, const double* __restrict__ per_cache,
    const long long* __restrict__ gidx, const double* __restrict__ gsize,
    const double* __restrict__ scalars, int n, int bk, int g, int inner,
    double* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31;
  const size_t nb = (size_t)n * bk, plan = blockIdx.x;
  const double* model = stacked + plan * 3 * nb;
  const double* pc = per_cache + plan * 3 * n;
  const long long* gi = gidx + plan * n;
  const double* sc = scalars + plan * 8;
  double* o = out + plan * (g + 4);
  const double target = sc[0], budget = sc[1], lo = sc[2], hi = sc[3];
  const double lr = sc[5], penalty = sc[6], rho_growth = sc[7];
  const bool has_budget = budget == budget;  // NaN: no egress budget
  const double bdiv = budget > 1.0 ? budget : 1.0;

  Plan P;
  double* d = reinterpret_cast<double*>(smem);
  P.hr = d;
  P.hb = d + n;
  P.dr = d + 2 * n;
  P.db = d + 3 * n;
  P.tb = d + 4 * n;
  P.of = d + 5 * n;
  P.u = d + 6 * n;
  P.mom = P.u + g;
  P.vel = P.mom + g;
  P.gs = P.vel + g;
  int* ints = reinterpret_cast<int*>(P.gs + g);
  P.cg = ints;
  P.members = ints + n;
  P.offsets = ints + 2 * n;
  int& bad = P.offsets[g + 1];
  P.n = n;
  P.bk = bk;
  P.g = g;
  P.tau = sc[4];

  if (tid == 0) bad = 0;
  __syncthreads();
  for (int c = tid; c < n; c += nt) {
    P.tb[c] = pc[n + c];
    P.of[c] = pc[2 * n + c];
    const long long q = gi[c];
    const bool ok = q >= 0 && q < g;
    if (!ok) atomicOr(&bad, 1);
    P.cg[c] = ok ? (int)q : 0;
  }
  for (int k = tid; k < g; k += nt) {
    P.gs[k] = gsize[plan * g + k];
    P.mom[k] = 0.0;
    P.vel[k] = 0.0;
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
    for (int c = 0; c < n; ++c) count += P.cg[c] == k;
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
      if (P.cg[c] == k) P.members[at++] = c;
  }
  __syncthreads();
  if (bad) {  // a cache's group out of range: no plan
    for (int k = tid; k < g + 4; k += nt)
      o[k] = __longlong_as_double(0x7ff8000000000000LL);
    return;
  }

  double hit, egress;
  // 1. the uniform capacity: the smallest u in [lo, hi] meeting the target
  double a = lo, b = hi;
  for (int it = 0; it < kBisect; ++it) {
    const double mid = 0.5 * (a + b);
    evaluate(P, mid, true, has_budget, false, false);
    __syncthreads();
    totals(P, has_budget, hit, egress);
    const bool good = hit >= target && (!has_budget || egress <= budget);
    a = good ? a : mid;
    b = good ? mid : b;
    __syncthreads();
  }
  const double u_uni = b;
  for (int k = tid; k < g; k += nt) P.u[k] = u_uni;
  double scale;
  {
    double s = 0.0;
    for (int k = lane; k < g; k += 32) s += P.gs[k] * exp(u_uni);
    s = warp_sum(s);
    scale = s > 1.0 ? s : 1.0;
  }
  const double inv_scale = 1.0 / scale;
  __syncthreads();

  // 2. the augmented-Lagrangian rounds
  double nu = 0.0, nu2 = 0.0, rho = penalty;
  for (int r = 0; r < kRounds; ++r) {
    for (int i = 0; i < inner; ++i) {
      evaluate(P, 0.0, false, has_budget, true, has_budget);
      __syncthreads();
      totals(P, has_budget, hit, egress);
      const double aug = fmax(nu + rho * (target - hit), 0.0);
      const double ct_hits =
          -(((1.0 / (2.0 * rho)) * (2.0 * aug)) * rho) / P.total;
      double ct_egress = 0.0;
      if (has_budget) {
        const double aug2 =
            fmax(nu2 + rho * ((egress - budget) / bdiv), 0.0);
        ct_egress = (((1.0 / (2.0 * rho)) * (2.0 * aug2)) * rho) / bdiv;
      }
      const double t = (double)(r * inner + i) + 1.0;
      const double bc1 = 1.0 - pow(0.9, t), bc2 = 1.0 - pow(0.99, t);
      for (int k = tid; k < g; k += nt) {
        const double eu = exp(P.u[k]);
        const double acc = group_ct(P, k, eu, ct_hits, ct_egress,
                                    has_budget);
        const double grad = (inv_scale * P.gs[k]) * eu + acc * eu;
        const double m = 0.9 * P.mom[k] + 0.1 * grad;
        const double v = 0.99 * P.vel[k] + 0.01 * grad * grad;
        P.mom[k] = m;
        P.vel[k] = v;
        const double un = P.u[k] - lr * (m / bc1) / (sqrt(v / bc2) + 1e-8);
        P.u[k] = fmin(fmax(un, lo), hi);
      }
      __syncthreads();
    }
    evaluate(P, 0.0, false, has_budget, false, false);
    __syncthreads();
    totals(P, has_budget, hit, egress);
    nu = fmax(nu + rho * (target - hit), 0.0);
    if (has_budget) nu2 = fmax(nu2 + rho * (egress - budget) / bdiv, 0.0);
    rho = rho * rho_growth;
    __syncthreads();
  }

  // 3. the repair: the smallest shift s in [-8, 8] making u + s feasible
  a = -8.0;
  b = 8.0;
  for (int it = 0; it < kBisect; ++it) {
    const double mid = 0.5 * (a + b);
    evaluate(P, mid, false, has_budget, false, false);
    __syncthreads();
    totals(P, has_budget, hit, egress);
    const bool good = hit >= target && (!has_budget || egress <= budget);
    a = good ? a : mid;
    b = good ? mid : b;
    __syncthreads();
  }
  for (int k = tid; k < g; k += nt) P.u[k] = fmin(fmax(P.u[k] + b, lo), hi);
  __syncthreads();

  // 4. the end point: hit rate, egress and |∂hit/∂u|
  evaluate(P, 0.0, false, true, true, false);
  __syncthreads();
  totals(P, true, hit, egress);
  if (tid < 32) {
    double s2 = 0.0;
    for (int k = lane; k < g; k += 32) {
      const double eu = exp(P.u[k]);
      const double gk = group_ct(P, k, eu, 1.0 / P.total, 0.0, false) * eu;
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
  for (int k = tid; k < g; k += nt) o[k] = exp(P.u[k]);
}

// ---------------------------------------------------------------------------
// mixture_fit
// ---------------------------------------------------------------------------
size_t mixture_smem_bytes(int m, int k) {
  const int warps = (m + 31) / 32;
  return sizeof(double) * (11 * (size_t)k + (size_t)warps * (3 * k + 1));
}

__global__ void __launch_bounds__(kMixMaxPoints) mixture_fit_kernel(
    const double* __restrict__ params0, const double* __restrict__ grid,
    const double* __restrict__ target, int m, int k, int steps, double lr,
    double* __restrict__ params_out, double* __restrict__ loss_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw = blockDim.x >> 5, np = 3 * k, nv = 3 * k + 1;
  const size_t fit = blockIdx.x;
  double* prm = reinterpret_cast<double*>(smem);  // logits, means, log σ
  double* mom = prm + np;
  double* vel = mom + np;
  double* spi = vel + np;    // this step's π
  double* sden = spi + k;    // this step's σ√2
  double* part = sden + k;   // nw x nv: each warp's sums
  if (tid < np) {
    prm[tid] = params0[fit * np + tid];
    mom[tid] = 0.0;
    vel[tid] = 0.0;
  }
  const bool live = tid < m;
  const double x = live ? grid[fit * m + tid] : 0.0;
  const double y = live ? target[fit * m + tid] : 0.0;
  double loss = 0.0;
  __syncthreads();
  for (int i = 0; i < steps; ++i) {
    double pi[kMixMaxK], den[kMixMaxK], zz[kMixMaxK], ez[kMixMaxK];
    double mx = prm[0];
    for (int j = 1; j < k; ++j) mx = fmax(mx, prm[j]);
    double se = 0.0;
#pragma unroll
    for (int j = 0; j < kMixMaxK; ++j)
      if (j < k) {
        pi[j] = exp(prm[j] - mx);
        se += pi[j];
      }
    double pred = 0.0;
#pragma unroll
    for (int j = 0; j < kMixMaxK; ++j)
      if (j < k) {
        pi[j] = pi[j] / se;
        den[j] = exp(prm[2 * k + j]) * kSqrt2;
        zz[j] = (x - prm[k + j]) / den[j];
        ez[j] = erf(zz[j]);
        pred += (pi[j] * 0.5) * (1.0 + ez[j]);
        if (tid == j) {
          spi[j] = pi[j];
          sden[j] = den[j];
        }
      }
    const double r = pred - y;
    const double ct = live ? (2.0 * r) / m : 0.0;
    double* mine = part + warp * nv;
    const double sq = warp_sum(live ? r * r : 0.0);
    if (lane == 0) mine[0] = sq;
#pragma unroll
    for (int j = 0; j < kMixMaxK; ++j)
      if (j < k) {
        const double e = ct * exp(-(zz[j] * zz[j]));
        const double sa = warp_sum(ct * (1.0 + ez[j]));
        const double sz = warp_sum(e * zz[j]);
        const double sg = warp_sum(e);
        if (lane == 0) {
          mine[1 + j] = sa;
          mine[1 + k + j] = sg;
          mine[1 + 2 * k + j] = sz;
        }
      }
    __syncthreads();
    if (tid == 0) {
      double s = 0.0;
      for (int w = 0; w < nw; ++w) s += part[w * nv];
      loss = s / m;
    }
    if (tid < np) {
      const int kind = tid / k, j = tid - kind * k;
      double grad;
      if (kind == 0) {  // ∂/∂logit through the softmax
        double dot = 0.0, own = 0.0;
        for (int q = 0; q < k; ++q) {
          double s = 0.0;
          for (int w = 0; w < nw; ++w) s += part[w * nv + 1 + q];
          const double ct_pi = 0.5 * s;
          dot += spi[q] * ct_pi;
          if (q == j) own = ct_pi;
        }
        grad = spi[j] * (own - dot);
      } else {
        double s = 0.0;
        for (int w = 0; w < nw; ++w) s += part[w * nv + 1 + kind * k + j];
        grad = -((spi[j] / kSqrtPi) * s);
        if (kind == 1) grad = grad / sden[j];
      }
      const double t = (double)i + 1.0;
      const double mm = 0.9 * mom[tid] + 0.1 * grad;
      const double vv = 0.999 * vel[tid] + 0.001 * grad * grad;
      mom[tid] = mm;
      vel[tid] = vv;
      prm[tid] = prm[tid] - lr * (mm / (1.0 - pow(0.9, t))) /
                                (sqrt(vv / (1.0 - pow(0.999, t))) + 1e-8);
    }
    __syncthreads();
  }
  if (tid < np) params_out[fit * np + tid] = prm[tid];
  if (tid == 0) loss_out[fit] = loss;
}

// Raise a kernel's dynamic shared-memory limit to a block's most, once a
// device (neither kernel has static shared memory).
cudaError_t allow_smem(const void* kernel, int slot) {
  static bool raised[2][64] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 64 && raised[slot][device]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(kBlockSmem));
  if (err != cudaSuccess) {
    cudaGetLastError();  // reported here: not to a later launch
    return err;
  }
  if (device < 64) raised[slot][device] = true;
  return cudaSuccess;
}

}  // namespace

extern "C" {

const char* cache_model_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int plan_solve_threads(int n) { return plan_threads(n); }

long long plan_solve_smem_bytes(int n, int g) {
  return (long long)plan_state_bytes(n, g);
}

// stacked (B x 3 x n x bk), per_cache (B x 3 x n), gidx (B x n) int64,
// gsize (B x g), scalars (B x 8) → out (B x (g + 4)); see the wrapper.
int plan_solve(const double* stacked, const double* per_cache,
               const long long* gidx, const double* gsize,
               const double* scalars, int batch, int n, int bk, int g,
               int inner, double* out, void* stream) {
  if (batch < 1 || n < 1 || n > kMaxCaches || g < 1 || g > n || bk < 1 ||
      inner < 1)
    return cudaErrorInvalidValue;
  cudaError_t err = allow_smem((const void*)plan_solve_kernel, 0);
  if (err != cudaSuccess) return err;
  plan_solve_kernel<<<batch, plan_threads(n), plan_state_bytes(n, g),
                      static_cast<cudaStream_t>(stream)>>>(
      stacked, per_cache, gidx, gsize, scalars, n, bk, g, inner, out);
  return cudaGetLastError();
}

// params0 (B x 3 x k), grid and target (B x m) → params_out (B x 3 x k),
// loss_out (B).
int mixture_fit(const double* params0, const double* grid,
                const double* target, int batch, int m, int k, int steps,
                double lr, double* params_out, double* loss_out,
                void* stream) {
  if (batch < 1 || m < 1 || m > kMixMaxPoints || k < 1 || k > kMixMaxK ||
      steps < 0)
    return cudaErrorInvalidValue;
  cudaError_t err = allow_smem((const void*)mixture_fit_kernel, 1);
  if (err != cudaSuccess) return err;
  mixture_fit_kernel<<<batch, 32 * ((m + 31) / 32), mixture_smem_bytes(m, k),
                       static_cast<cudaStream_t>(stream)>>>(
      params0, grid, target, m, k, steps, lr, params_out, loss_out);
  return cudaGetLastError();
}

}  // extern "C"
