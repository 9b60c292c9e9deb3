// The sweeps' three scans for Hopper (sm_90a), exact in float64 and int32,
// each over a batch of B independent problems padded to Np references
// (and Kp keys), each problem run to its own true length.
//
// Replaces: the jitted, vmapped `lax.scan` kernels of
// src/repro/kernels/stack_distance.py:
//   sd_distances    <- `_distances`   (:75, jit(vmap) at :217)
//   sd_cache_sim    <- `_simulate`    (:101, jit(vmap) at :218)
//   sd_fifo_replay  <- `_fifo_replay` (:165, jit(vmap) at :219)
// They are not Pallas kernels, but a scan has no counterpart in torch ops:
// as torch ops it is a host loop of N steps of ~15 launches each.
//
// Exactness: every byte count is an integer below 2^53, so float64 sums
// are exact in any order; hits, eviction counts and bytes evicted equal
// the reference's, not approximately.
//
// 1. sd_distances.  d_i = sum of sizes[j] over p_i < j < i for the j whose
//    key is not referenced again before i: next_j >= i, where next_j is
//    the first reference whose prev is j (INT_MAX if none); inf when
//    p_i < 0 (a compulsory miss, the first reference after a reset
//    included).  This is the reference's marker array read off in
//    closed form: marker j is live at step i iff j < i and no step before
//    i superseded it.  Design: no sequential chain at all.  Kernel 1 sets
//    next (atomicMin, so a duplicate prev keeps its first), kernel 2 gives
//    each reference a warp whose lanes stride over (p_i, i) with coalesced
//    reads of next and sizes and add in float64 registers, then a shuffle
//    reduction.  The work is the sum of the reuse gaps; the reads stay in
//    L2 (a bucket of 32 x 32768 references is 12 MB of next and sizes).
//    Bound: bytes (prev and sizes read once, the distances written once).
//
// 2. sd_cache_sim.  The reference keeps victim order in priority slots
//    (slot t is written only at step t) and pays a cumsum over all Np slots
//    each step, because a vmapped scan cannot branch.  Its state is smaller
//    than it looks: slot t only ever holds key keys[t] with key_sizes[k]
//    bytes, so the one state a key needs is key_slot[k], the step of its
//    last touch, with -1 once evicted; and
//      key k is resident      iff key_slot[k] >= ep (ep: the last reset's
//                                 step, 0 before any), and
//      slot j is occupied     iff j >= ep, key_slot[keys[j]] == j and
//                                 key_sizes[keys[j]] > 0
//    (an LRU touch moves key_slot on, so the old slot empties by itself; a
//    zero-byte key is resident but never occupies a slot, so it is never a
//    victim).  A reset is ep = t: nothing to clear.  Evictions take the
//    lowest occupied slots while the bytes freed before each are short of
//    need = usage + size - capacity (the reference's excl < need).
//
//    Design: one block a problem.  One thread carries the chain, the
//    reference's own walk written as scalar code: a head pointer (every
//    slot below it is empty; a reset sets it to t) only moves forward, and
//    an insert that needs room inspects the slots from it in order,
//    evicting the occupied ones while the bytes freed are short of need,
//    and leaves it past the last victim; so a problem's walks inspect each
//    slot about once.  An LRU touch costs nothing beyond its key_slot
//    store.  Two rings in shared memory, each kept full by one lane with
//    1-D bulk copies (TMA) on mbarriers, feed it: the stream (keys, admit
//    and reset bits: 3 stages of 1,024 references), read a step ahead, and
//    the head ring (2 stages of 1,024 keys, the stream's keys from the
//    head's tile on), which gives the walk the keys of old slots at shared
//    memory latency; the chain releases a head-ring tile when the head
//    leaves it, and releases the rest at its end.  Hits go to a tile's
//    buffer, copied out in whole words at the tile's end; ev and evb are
//    written once.
//
//    Why one thread and not a warp: the step is a chain of dependent
//    instructions, and on this card a warp-wide collective or a branch
//    around one costs about as much as a shared read.  A design with the
//    warp's 32 lanes in step and the walk a ballot over a window of 32
//    slots in registers was correct but slower on sweep I (9.0610 ms, its
//    step 0.2033 us; this design 7.31 ms, 0.164 us, H100, kernel_probe.py
//    and chip_smoke.py).  The scalar walk pays one inspection a slot an
//    LRU touch emptied, which a stream of many hits feels.
//
//    Layout: design "smem" keeps key_sizes (8 B a key) and key_slot (4 B)
//    in shared memory beside the rings and a tile's hits (27,776 B): 12 B
//    a key, so Kp <= 17,056, that is every power-of-two bucket up to Kp
//    16,384 (224,384 B of the 232,448 a block may have); design "global"
//    keeps both in device memory (key_slot as the caller's scratch) for a
//    larger Kp.  Np does not enter the state: any Np that is a multiple of
//    16 (the rings' copies) serves.  The caller picks the design by Kp.
//
// 3. sd_fifo_replay.  The reference's own form is sequential already: a
//    frontier E over the cumulative admitted bytes cumB; a key is resident
//    iff its latest admit's cumulative total exceeds E; an insert that
//    needs room moves E to cumB[j], j the first index with cumB[j] >=
//    target (searchsorted, left side: among ties the first), and counts
//    cumN[j] - EN evictions.  cumB is nondecreasing over the steps already
//    taken and +inf (cumN 0) from step t on, so j <= t.  A reset sets
//    E = total (nothing counted).
//
//    Design: one block a problem, two warps.  Warp 1's lane 0 keeps a
//    ring of 3 stages of 1,024 references (keys, sizes, admit and reset
//    bits: 14 KB a stage) full with 1-D bulk copies (TMA) on mbarriers,
//    so no step waits on a stream load.  Warp 0 carries the chain, its 32
//    lanes in step on broadcast reads: the key state kcum (Kp float64)
//    lives in shared memory beside the ring (design "smem", Kp <= 16,384:
//    128 KB + 91 KB), so a step's only dependent load is one shared read;
//    a larger Kp keeps kcum in device memory (design "global", chosen by
//    the caller, counted apart).  A step's outputs (cumB, cumN, the hit)
//    go to shared memory, the same values from every lane so that no lane
//    waits on another: cumB and cumN to a history of the last 4,096 steps
//    (48 KB), the hits to a tile's buffer; at the end of each tile the
//    warp copies them to device memory, coalesced (cumB and cumN are 384
//    KB a problem at Np 32,768), and a step reads its successor's inputs
//    from the ring before it stores, so its one dependent load is kcum.  The
//    search runs on the warp: a window of 32 entries of cumB/cumN in the
//    lanes' registers, read from the last answer lo onwards (from the
//    history where it reaches, else coalesced from device memory); a
//    ballot over the window takes the first entry >= target, and the
//    window is kept while later searches fall inside it, so a stream of
//    evictions reads an old cumB about once.  lo is a valid lower bound while
//    cumB[lo - 1] < target (kept in a register, checked; if it fails the
//    search restarts at 0, so the answer is exact on any input); E only
//    grows in a valid stream, so the searches cost O(Np) in all.
//
//    A reference's step adds newE - E to the bytes evicted, even where it
//    moves nothing: once an admitted insert larger than the capacity has
//    moved E to +inf (cumB[t] is +inf), every later step without a reset
//    adds inf - inf and the reference's bytes evicted are NaN.  So does
//    this kernel, on its own steps and, where the reference's row is wider
//    than the problem (padding, `width`), for the reference's padding
//    steps at the end.
//
// What bounds both replays is the chain's latency, not bytes: the shared
// reads and the arithmetic that depend on each other within a step, more
// on a step that evicts.
//
// Plain C interface, loaded with ctypes: each function returns the
// cudaError_t of its launches and never synchronises.  Scratch is
// allocated by the caller: sd_distances needs next (B x Np int32);
// sd_cache_sim's "global" design key_slot (B x Kp int32; the kernel fills
// it); sd_fifo_replay cumB (B x Np f64), cumN (B x Np int32) and kcum
// (B x Kp f64, the key state's start: zeros; the "smem" design copies it
// in and leaves it).  Outputs: hits (B x Np uint8, zeroed by the caller:
// padding stays 0), ev (B int32), evb (B f64).

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int DIST_WARPS = 8;  // warps (references) per block of kernel 2
constexpr unsigned FULL_MASK = 0xffffffffu;

__global__ void next_init(int* __restrict__ next, long long total) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i < total) next[i] = INT_MAX;
}

__global__ void next_set(const long long* __restrict__ prev,
                         const int* __restrict__ lengths, int np,
                         int* __restrict__ next) {
  const int b = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= min(lengths[b], np)) return;
  const long long p = prev[(long long)b * np + i];
  if (p >= 0 && p < i) atomicMin(&next[(long long)b * np + p], i);
}

__global__ void distances(const long long* __restrict__ prev,
                          const double* __restrict__ sizes,
                          const int* __restrict__ lengths, int np,
                          const int* __restrict__ next,
                          double* __restrict__ out) {
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * DIST_WARPS + (threadIdx.x >> 5);
  if (i >= min(lengths[b], np)) return;  // whole warp: i is uniform
  const long long row = (long long)b * np;
  const long long p = prev[row + i];
  if (p < 0) {
    if (lane == 0) out[row + i] = __longlong_as_double(0x7ff0000000000000LL);
    return;
  }
  double acc = 0.0;
  for (long long j = p + 1 + lane; j < i; j += 32) {
    if (next[row + j] >= i) acc += sizes[row + j];
  }
  for (int off = 16; off; off >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  if (lane == 0) out[row + i] = acc;
}

// ---- sd_fifo_replay: the stream through a ring, the key state in shared
// memory, the frontier searched by the warp

constexpr int FIFO_TILE = 1024;    // references a ring stage holds
constexpr int FIFO_STAGES = 3;
constexpr int FIFO_HIST = 4096;    // the last steps' cumB/cumN, in shared
constexpr size_t FIFO_STAGE_BYTES = FIFO_TILE * (8 + 4 + 1 + 1);
constexpr size_t FIFO_RING_BYTES = 16 * FIFO_STAGES + FIFO_HIST * 12 +
                                   FIFO_TILE +
                                   FIFO_STAGES * FIFO_STAGE_BYTES;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

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

// A 1-D bulk copy (TMA) of `bytes` (a multiple of 16) into shared memory,
// completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Warp 0 carries the chain, all 32 lanes in step on the same values
// (shared reads are broadcasts, shared stores the same value from each).
// Warp 1's lane 0 keeps the ring full.  SMEM_KEYS: the key state kcum in
// shared memory (design "smem"), else in device memory ("global").
template <bool SMEM_KEYS>
__global__ void __launch_bounds__(64)
fifo_replay(const int* __restrict__ keys, const double* __restrict__ sizes,
            const unsigned char* __restrict__ admit,
            const unsigned char* __restrict__ reset,
            const double* __restrict__ capacity,
            const int* __restrict__ lengths, int np, int width, int kp,
            double* __restrict__ cum_b, int* __restrict__ cum_n,
            double* __restrict__ kcum_all, unsigned char* __restrict__ hits,
            int* __restrict__ ev_out, double* __restrict__ evb_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + FIFO_STAGES;
  double* hist_b = reinterpret_cast<double*>(smem + 16 * FIFO_STAGES);
  int* hist_n = reinterpret_cast<int*>(hist_b + FIFO_HIST);
  unsigned char* hit_tile = reinterpret_cast<unsigned char*>(hist_n +
                                                             FIFO_HIST);
  unsigned char* ring = hit_tile + FIFO_TILE;
  double* kcum_s = reinterpret_cast<double*>(ring + FIFO_STAGES *
                                             FIFO_STAGE_BYTES);
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long row = (long long)b * np;
  const int n = min(lengths[b], np);
  const int ntiles = (n + FIFO_TILE - 1) / FIFO_TILE;
  double* kcum = SMEM_KEYS ? kcum_s : kcum_all + (long long)b * kp;
  if (SMEM_KEYS)
    for (int k = threadIdx.x; k < kp; k += blockDim.x)
      kcum_s[k] = kcum_all[(long long)b * kp + k];
  if (threadIdx.x == 0) {
    for (int s = 0; s < FIFO_STAGES; ++s) {
      mbar_init(smem_u32(full + s), 1);
      mbar_init(smem_u32(empty + s), 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  auto stage_sizes = [&](int s) {
    return reinterpret_cast<double*>(ring + s * FIFO_STAGE_BYTES);
  };
  auto stage_keys = [&](int s) {
    return reinterpret_cast<int*>(ring + s * FIFO_STAGE_BYTES +
                                  8 * FIFO_TILE);
  };
  auto stage_admit = [&](int s) {
    return ring + s * FIFO_STAGE_BYTES + 12 * FIFO_TILE;
  };
  auto stage_reset = [&](int s) {
    return ring + s * FIFO_STAGE_BYTES + 13 * FIFO_TILE;
  };

  if (warp == 1) {                         // the producer
    if (lane == 0) {
      for (int i = 0; i < ntiles; ++i) {
        const int s = i % FIFO_STAGES;
        if (i >= FIFO_STAGES)
          mbar_wait(smem_u32(empty + s), ((i / FIFO_STAGES) - 1) & 1);
        const int t0 = i * FIFO_TILE;
        // a multiple of 16 references: inside the row, whose length is
        // a multiple of 256
        const int cnt = min(FIFO_TILE, (n - t0 + 15) & ~15);
        const uint32_t bar = smem_u32(full + s);
        mbar_expect_tx(bar, cnt * 14);
        bulk_load(stage_sizes(s), sizes + row + t0, cnt * 8, bar);
        bulk_load(stage_keys(s), keys + row + t0, cnt * 4, bar);
        bulk_load(stage_admit(s), admit + row + t0, cnt, bar);
        bulk_load(stage_reset(s), reset + row + t0, cnt, bar);
      }
    }
    return;
  }

  const double cap = capacity[b];
  const double inf = __longlong_as_double(0x7ff0000000000000LL);
  double* cb = cum_b + row;
  int* cn = cum_n + row;
  double total = 0.0, e = 0.0, evb = 0.0;
  int tot_n = 0, e_n = 0, ev = 0;
  int lo = 0;                 // search hint: the last answer ...
  double lo_prev = -inf;      // ... and cumB[lo - 1] (-inf at 0)
  int wb = 0, wcount = 0;     // the window: cumB/cumN[wb + lane], the first
  double wv = 0.0;            // wcount of them written when it was read
  int wn = 0;
  for (int i = 0; i < ntiles; ++i) {
    const int s = i % FIFO_STAGES;
    mbar_wait(smem_u32(full + s), (i / FIFO_STAGES) & 1);
    const double* rs = stage_sizes(s);
    const int* rk = stage_keys(s);
    const unsigned char* ra = stage_admit(s);
    const unsigned char* rr = stage_reset(s);
    const int t0 = i * FIFO_TILE, cnt = min(n - t0, FIFO_TILE);
    // step o's inputs are read during step o - 1, before its stores
    int k = rk[0];
    double sz = rs[0];
    bool a = ra[0] != 0, r = rr[0] != 0;
    for (int o = 0; o < cnt; ++o) {
      const int t = t0 + o;
      const int p = o + 1 < cnt ? o + 1 : o;
      const int k_next = rk[p];
      const double sz_next = rs[p];
      const bool a_next = ra[p] != 0, r_next = rr[p] != 0;
      if (r) {                 // everything admitted so far is gone, uncounted
        e = total;
        e_n = tot_n;
      }
      const bool hit = kcum[k] > e;
      const bool ins = !hit && a;
      const double target = total + sz - cap;
      if (ins && target > e) {
        // first j in [0, t] with cumB[j] >= target; cumB[t] is +inf
        __syncwarp();          // every lane's stores, for every lane
        if (lo > t || (lo > 0 && lo_prev >= target)) {
          lo = 0;
          lo_prev = -inf;
        }
        int pos = lo, j = t, at = 0;
        double before = lo_prev;          // cumB[pos - 1]
        while (pos < t) {
          if (pos < wb || pos >= wb + wcount) {
            wb = pos;
            wcount = min(32, t - wb);
            // the last FIFO_HIST steps from shared memory, older ones
            // from device memory (written at the end of their tile)
            const int idx = wb + lane;
            const bool recent = idx >= t - FIFO_HIST;
            const int slot = idx & (FIFO_HIST - 1);
            wv = lane >= wcount ? inf : recent ? hist_b[slot] : cb[idx];
            wn = lane >= wcount ? 0 : recent ? hist_n[slot] : cn[idx];
          }
          const unsigned ball = __ballot_sync(
              FULL_MASK, wb + lane >= pos && lane < wcount && wv >= target);
          if (ball) {
            at = __ffs(ball) - 1;
            j = wb + at;
            break;
          }
          before = __shfl_sync(FULL_MASK, wv, wcount - 1);
          pos = wb + wcount;
        }
        const double new_e = j < t ? __shfl_sync(FULL_MASK, wv, at) : inf;
        const int new_n = j < t ? __shfl_sync(FULL_MASK, wn, at) : 0;
        if (j != lo) {
          lo_prev = j == pos ? before : __shfl_sync(FULL_MASK, wv, at - 1);
          lo = j;
        }
        ev += new_n - e_n;
        evb += new_e - e;
        e = new_e;
        e_n = new_n;
      } else {
        evb += e - e;          // the reference's newE - E: NaN once E is inf
      }
      if (ins) {
        total += sz;
        tot_n += 1;
        kcum[k] = total;
      }
      // every lane stores the same values: no lane waits on another
      hist_b[t & (FIFO_HIST - 1)] = total;
      hist_n[t & (FIFO_HIST - 1)] = tot_n;
      hit_tile[o] = hit;
      k = k_next;
      sz = sz_next;
      a = a_next;
      r = r_next;
    }
    __syncwarp();
    // the tile's cumB, cumN and hits to device memory, coalesced
    for (int o = lane; o < cnt; o += 32) {
      const int t = t0 + o;
      cb[t] = hist_b[t & (FIFO_HIST - 1)];
      cn[t] = hist_n[t & (FIFO_HIST - 1)];
      hits[row + t] = hit_tile[o];
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(smem_u32(empty + s));
  }
  if (lane == 0) {
    ev_out[b] = ev;
    // the reference's padding steps up to its row's width add E - E too
    evb_out[b] = n < width ? evb + (e - e) : evb;
  }
}

// ---- sd_cache_sim: one thread's chain over shared memory, two rings

constexpr int SIM_TILE = 1024;     // references a ring stage holds
constexpr int SIM_STAGES = 3;      // the stream's ring
constexpr int HEAD_STAGES = 2;     // the head ring: the keys from the head on
constexpr size_t SIM_STAGE_BYTES = SIM_TILE * (4 + 1 + 1);
constexpr size_t SIM_FIXED_BYTES = 128 + SIM_TILE +
                                   SIM_STAGES * SIM_STAGE_BYTES +
                                   HEAD_STAGES * SIM_TILE * 4;

// Thread 0 carries the chain; warp 1's lane 0 keeps the stream's ring full
// (and copies the key sizes in once), warp 2's lane 0 the head ring.
// SMEM_KEYS: key_sizes and key_slot in shared memory (design "smem"), else
// in device memory ("global").
template <bool SMEM_KEYS>
__global__ void __launch_bounds__(96)
cache_sim(const int* __restrict__ keys, const unsigned char* __restrict__ admit,
          const unsigned char* __restrict__ reset,
          const double* __restrict__ key_sizes,
          const double* __restrict__ capacity,
          const unsigned char* __restrict__ fifo,
          const int* __restrict__ lengths, int np, int kp,
          int* __restrict__ key_slot_all, unsigned char* __restrict__ hits,
          int* __restrict__ ev_out, double* __restrict__ evb_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + SIM_STAGES;
  uint64_t* hfull = empty + SIM_STAGES;
  uint64_t* hempty = hfull + HEAD_STAGES;
  uint64_t* sizes_bar = hempty + HEAD_STAGES;
  unsigned char* hit_tile = smem + 128;
  unsigned char* ring = hit_tile + SIM_TILE;
  int* head_ring = reinterpret_cast<int*>(ring + SIM_STAGES *
                                          SIM_STAGE_BYTES);
  double* ksz_s = reinterpret_cast<double*>(head_ring + HEAD_STAGES *
                                            SIM_TILE);
  int* kslot_s = reinterpret_cast<int*>(ksz_s + kp);
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long row = (long long)b * np, krow = (long long)b * kp;
  const int n = min(lengths[b], np);
  const int ntiles = (n + SIM_TILE - 1) / SIM_TILE;
  const double* ksz = SMEM_KEYS ? ksz_s : key_sizes + krow;
  int* kslot = SMEM_KEYS ? kslot_s : key_slot_all + krow;
  for (int k = threadIdx.x; k < kp; k += blockDim.x) kslot[k] = -1;
  if (threadIdx.x == 0) {
    for (int s = 0; s < SIM_STAGES; ++s) {
      mbar_init(smem_u32(full + s), 1);
      mbar_init(smem_u32(empty + s), 1);
    }
    for (int s = 0; s < HEAD_STAGES; ++s) {
      mbar_init(smem_u32(hfull + s), 1);
      mbar_init(smem_u32(hempty + s), 1);
    }
    mbar_init(smem_u32(sizes_bar), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  auto stage_keys = [&](int s) {
    return reinterpret_cast<int*>(ring + s * SIM_STAGE_BYTES);
  };
  auto stage_admit = [&](int s) {
    return ring + s * SIM_STAGE_BYTES + 4 * SIM_TILE;
  };
  auto stage_reset = [&](int s) {
    return ring + s * SIM_STAGE_BYTES + 5 * SIM_TILE;
  };
  auto tile_refs = [&](int i) {  // a multiple of 16, inside the row
    return min(SIM_TILE, (n - i * SIM_TILE + 15) & ~15);
  };

  if (lane != 0) return;
  if (warp == 1) {                         // the stream's producer
    if (SMEM_KEYS && n > 0) {              // the key sizes, once
      const uint32_t bar = smem_u32(sizes_bar);
      mbar_expect_tx(bar, 8 * kp);
      bulk_load(ksz_s, key_sizes + krow, 8 * kp, bar);
    }
    for (int i = 0; i < ntiles; ++i) {
      const int s = i % SIM_STAGES;
      if (i >= SIM_STAGES)
        mbar_wait(smem_u32(empty + s), ((i / SIM_STAGES) - 1) & 1);
      const int cnt = tile_refs(i), t0 = i * SIM_TILE;
      const uint32_t bar = smem_u32(full + s);
      mbar_expect_tx(bar, cnt * 6);
      bulk_load(stage_keys(s), keys + row + t0, cnt * 4, bar);
      bulk_load(stage_admit(s), admit + row + t0, cnt, bar);
      bulk_load(stage_reset(s), reset + row + t0, cnt, bar);
    }
    return;
  }
  if (warp == 2) {                         // the head ring's producer
    for (int i = 0; i < ntiles; ++i) {
      const int s = i % HEAD_STAGES;
      if (i >= HEAD_STAGES)
        mbar_wait(smem_u32(hempty + s), ((i / HEAD_STAGES) - 1) & 1);
      const int cnt = tile_refs(i);
      const uint32_t bar = smem_u32(hfull + s);
      mbar_expect_tx(bar, cnt * 4);
      bulk_load(head_ring + s * SIM_TILE, keys + row + i * SIM_TILE,
                cnt * 4, bar);
    }
    return;
  }

  const double cap = capacity[b];
  const bool is_fifo = fifo[b] != 0;
  int ep = 0;               // the last reset's step
  int head = 0;             // every slot below head is empty
  int htile = -1;           // the head ring's tile held (its keys read)
  double usage = 0.0, evb = 0.0;
  int ev = 0;
  // hold a tile of the head ring (>= htile), releasing the ones before it
  // to its producer
  auto hold = [&](int tile) {
    while (htile < tile) {
      if (htile >= 0) mbar_arrive(smem_u32(hempty + htile % HEAD_STAGES));
      ++htile;
      mbar_wait(smem_u32(hfull + htile % HEAD_STAGES),
                (htile / HEAD_STAGES) & 1);
    }
  };
  if (SMEM_KEYS && n > 0) mbar_wait(smem_u32(sizes_bar), 0);
  for (int i = 0; i < ntiles; ++i) {
    const int st = i % SIM_STAGES;
    mbar_wait(smem_u32(full + st), (i / SIM_STAGES) & 1);
    const int* rk = stage_keys(st);
    const unsigned char* ra = stage_admit(st);
    const unsigned char* rr = stage_reset(st);
    const int t0 = i * SIM_TILE, cnt = min(n - t0, SIM_TILE);
    // step o's inputs are read during step o - 1, before its stores
    int k = rk[0];
    double s = ksz[k];
    bool a = ra[0] != 0, r = rr[0] != 0;
#pragma unroll 2
    for (int o = 0; o < cnt; ++o) {
      const int t = t0 + o;
      const int p = o + 1 < cnt ? o + 1 : o;
      const int k_next = rk[p];
      const bool a_next = ra[p] != 0, r_next = rr[p] != 0;
      const double s_next = ksz[k_next];
      if (r) {                 // the disk came back empty: nothing counted
        ep = t;
        head = t;
        usage = 0.0;
      }
      const int old = kslot[k];
      const bool hit = old >= ep;
      const bool ins = !hit && a;
      const double need = usage + s - cap;
      if (ins && need > 0.0) {
        // the lowest occupied slots while the bytes freed are short:
        // slot j is occupied iff key_slot[keys[j]] == j and its bytes > 0
        double freed = 0.0;
        int j = head;
        while (freed < need && j < t) {
          hold(j / SIM_TILE);
          const int key = head_ring[(j / SIM_TILE) % HEAD_STAGES *
                                    SIM_TILE + j % SIM_TILE];
          const double bytes = ksz[key];
          if (kslot[key] == j && bytes > 0.0) {
            kslot[key] = -1;
            freed += bytes;
            ++ev;
          }
          ++j;
        }
        head = j;
        usage -= freed;
        evb += freed;
      }
      if (ins || (hit && !is_fifo)) kslot[k] = t;
      usage += ins ? s : 0.0;
      hit_tile[o] = hit;
      k = k_next;
      s = s_next;
      a = a_next;
      r = r_next;
    }
    // the tile's hits in whole words (the row is a multiple of 16): the
    // bytes past the problem's end stay 0
    for (int o = cnt; o < ((cnt + 3) & ~3); ++o) hit_tile[o] = 0;
    for (int o = 0; o < cnt; o += 4)
      *reinterpret_cast<unsigned*>(hits + row + t0 + o) =
          *reinterpret_cast<const unsigned*>(hit_tile + o);
    mbar_arrive(smem_u32(empty + st));
  }
  if (ntiles > 0) {            // release the head ring to its producer
    hold(ntiles - 1);
    mbar_arrive(smem_u32(hempty + htile % HEAD_STAGES));
  }
  ev_out[b] = ev;
  evb_out[b] = evb;
}

}  // namespace

extern "C" {

const char* stack_distance_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int sd_distances(const long long* prev, const double* sizes,
                 const int* lengths, int batch, int np, int* next,
                 double* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long total = (long long)batch * np;
  next_init<<<(unsigned)((total + 255) / 256), 256, 0, s>>>(next, total);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  next_set<<<dim3((np + 255) / 256, batch), 256, 0, s>>>(prev, lengths, np,
                                                         next);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  distances<<<dim3((np + DIST_WARPS - 1) / DIST_WARPS, batch),
              32 * DIST_WARPS, 0, s>>>(prev, sizes, lengths, np, next, out);
  return cudaGetLastError();
}

// Dynamic shared memory of a sd_cache_sim block: the two rings and a
// tile's hits, and for the "smem" design (1) key_sizes and key_slot too.
long long sd_cache_smem_bytes(int kp, int design) {
  return (long long)(SIM_FIXED_BYTES + (design == 1 ? 12 * (size_t)kp : 0));
}

// design 1: the key state in shared memory ("smem"); 0: in device memory
// ("global", key_slot the caller's B x Kp int32 scratch).  np must be a
// multiple of 16 (the rings' bulk copies), kp even (the sizes' copy).
int sd_cache_sim(const int* keys, const unsigned char* admit,
                 const unsigned char* reset, const double* key_sizes,
                 const double* capacity, const unsigned char* fifo,
                 const int* lengths, int batch, int np, int kp, int design,
                 int* key_slot, unsigned char* hits, int* ev, double* evb,
                 void* stream) {
  if (np % 16 != 0 || kp % 2 != 0 || (design != 0 && design != 1))
    return cudaErrorInvalidValue;
  const size_t smem = (size_t)sd_cache_smem_bytes(kp, design);
  auto kernel = design == 1 ? cache_sim<true> : cache_sim<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) {
    cudaGetLastError();    // reported here: not to a later launch
    return err;
  }
  kernel<<<batch, 96, smem, static_cast<cudaStream_t>(stream)>>>(
      keys, admit, reset, key_sizes, capacity, fifo, lengths, np, kp,
      key_slot, hits, ev, evb);
  return cudaGetLastError();
}

// Dynamic shared memory of a sd_fifo_replay block: the ring, and for the
// "smem" design (1) the key state too.
long long sd_fifo_smem_bytes(int kp, int design) {
  return (long long)(FIFO_RING_BYTES + (design == 1 ? 8 * (size_t)kp : 0));
}

// design 1: kcum in shared memory ("smem"); 0: in device memory
// ("global").  np must be a multiple of 16 (the ring's bulk copies);
// width (<= np) is the row width the reference runs, np less the ring's
// padding.
int sd_fifo_replay(const int* keys, const double* sizes,
                   const unsigned char* admit, const unsigned char* reset,
                   const double* capacity, const int* lengths, int batch,
                   int np, int width, int kp, int design, double* cum_b,
                   int* cum_n, double* kcum, unsigned char* hits, int* ev,
                   double* evb, void* stream) {
  if (np % 16 != 0 || width > np || (design != 0 && design != 1))
    return cudaErrorInvalidValue;
  const size_t smem = (size_t)sd_fifo_smem_bytes(kp, design);
  auto kernel = design == 1 ? fifo_replay<true> : fifo_replay<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) {
    cudaGetLastError();    // reported here: not to a later launch
    return err;
  }
  kernel<<<batch, 64, smem, static_cast<cudaStream_t>(stream)>>>(
      keys, sizes, admit, reset, capacity, lengths, np, width, kp, cum_b,
      cum_n, kcum, hits, ev, evb);
  return cudaGetLastError();
}

}  // extern "C"
