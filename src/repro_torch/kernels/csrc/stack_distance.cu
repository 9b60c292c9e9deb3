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
//    each step, because a vmapped scan cannot branch.  Here one thread
//    carries one problem: evictions always take the lowest occupied slots,
//    so a head pointer (every slot below it is empty) walks forward over
//    the slots, skipping vacated ones, and frees while the bytes freed so
//    far are short of usage + size - capacity.  The head only moves
//    forward, so all evictions of a problem cost O(Np) in all.  A reset
//    empties every slot (head = t) and every key (an epoch per key: a key
//    is resident iff res_epoch[k] equals the current epoch) in O(1); it
//    counts no eviction.  A slot is occupied iff its bytes are > 0, as in
//    the reference, so a zero-byte key is never a victim.
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
// The slot machine is a chain of N dependent steps too, one thread per
// problem, one problem per block so each gets an SM, its state in global
// memory (L2-resident: slot state is 12 B a reference, 768 KB a problem at
// Np 65,536, over one SM's 228 KB of shared memory).  What bounds both
// replays is the chain's latency, not bytes: for the slot machine an L2
// round trip per dependent load, for the FIFO replay a shared read.
//
// Plain C interface, loaded with ctypes: each function returns the
// cudaError_t of its launches and never synchronises.  Scratch is
// allocated by the caller: sd_distances needs next (B x Np int32);
// sd_cache_sim slot_bytes (B x Np f64), slot_key (B x Np int32), key_slot
// (B x Kp int32) and res_epoch (B x Kp int32, zeroed); sd_fifo_replay
// cumB (B x Np f64), cumN (B x Np int32) and kcum (B x Kp f64, the key
// state's start: zeros; the "smem" design copies it in and leaves it).
// Outputs: hits (B x Np uint8, zeroed by the caller: padding stays 0),
// ev (B int32), evb (B f64).

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

__global__ void cache_sim(const int* __restrict__ keys,
                          const unsigned char* __restrict__ admit,
                          const unsigned char* __restrict__ reset,
                          const double* __restrict__ key_sizes,
                          const double* __restrict__ capacity,
                          const unsigned char* __restrict__ fifo,
                          const int* __restrict__ lengths, int np, int kp,
                          double* __restrict__ slot_bytes,
                          int* __restrict__ slot_key,
                          int* __restrict__ key_slot,
                          int* __restrict__ res_epoch,
                          unsigned char* __restrict__ hits,
                          int* __restrict__ ev_out,
                          double* __restrict__ evb_out) {
  const int b = blockIdx.x;
  if (threadIdx.x != 0) return;
  const long long row = (long long)b * np, krow = (long long)b * kp;
  const int n = min(lengths[b], np);
  const double cap = capacity[b];
  const bool is_fifo = fifo[b] != 0;
  double* sb = slot_bytes + row;
  int* sk = slot_key + row;
  int* kslot = key_slot + krow;
  int* epoch_of = res_epoch + krow;
  const double* ksz = key_sizes + krow;
  int epoch = 1;       // res_epoch starts zeroed: nothing resident
  int head = 0;        // every slot below head is empty
  double usage = 0.0, evb = 0.0;
  int ev = 0;
  for (int t = 0; t < n; ++t) {
    const int k = keys[row + t];
    const bool a = admit[row + t] != 0;
    if (reset[row + t]) {  // the disk came back empty: nothing counted
      ++epoch;
      head = t;
      usage = 0.0;
    }
    const double s = ksz[k];
    const bool hit = epoch_of[k] == epoch;
    const bool do_insert = !hit && a;
    if (do_insert) {
      const double need = usage + s - cap;
      double freed = 0.0;
      int j = head;
      for (; j < t; ++j) {
        const double bytes = sb[j];
        if (bytes > 0.0) {
          if (!(freed < need)) break;
          freed += bytes;
          sb[j] = 0.0;
          epoch_of[sk[j]] = 0;
          ++ev;
        }
      }
      head = j;
      usage -= freed;
      evb += freed;
    }
    const bool touch = do_insert || (hit && !is_fifo);
    if (hit && touch) sb[kslot[k]] = 0.0;  // an LRU touch vacates
    sb[t] = touch ? s : 0.0;
    sk[t] = k;
    if (touch) kslot[k] = t;
    epoch_of[k] = (hit || do_insert) ? epoch : 0;
    if (do_insert) usage += s;
    hits[row + t] = hit;
  }
  ev_out[b] = ev;
  evb_out[b] = evb;
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
            const int* __restrict__ lengths, int np, int kp,
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
    evb_out[b] = evb;
  }
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

int sd_cache_sim(const int* keys, const unsigned char* admit,
                 const unsigned char* reset, const double* key_sizes,
                 const double* capacity, const unsigned char* fifo,
                 const int* lengths, int batch, int np, int kp,
                 double* slot_bytes, int* slot_key, int* key_slot,
                 int* res_epoch, unsigned char* hits, int* ev, double* evb,
                 void* stream) {
  cache_sim<<<batch, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      keys, admit, reset, key_sizes, capacity, fifo, lengths, np, kp,
      slot_bytes, slot_key, key_slot, res_epoch, hits, ev, evb);
  return cudaGetLastError();
}

// Dynamic shared memory of a sd_fifo_replay block: the ring, and for the
// "smem" design (1) the key state too.
long long sd_fifo_smem_bytes(int kp, int design) {
  return (long long)(FIFO_RING_BYTES + (design == 1 ? 8 * (size_t)kp : 0));
}

// design 1: kcum in shared memory ("smem"); 0: in device memory
// ("global").  np must be a multiple of 16 (the ring's bulk copies).
int sd_fifo_replay(const int* keys, const double* sizes,
                   const unsigned char* admit, const unsigned char* reset,
                   const double* capacity, const int* lengths, int batch,
                   int np, int kp, int design, double* cum_b, int* cum_n,
                   double* kcum, unsigned char* hits, int* ev, double* evb,
                   void* stream) {
  if (np % 16 != 0 || (design != 0 && design != 1))
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
      keys, sizes, admit, reset, capacity, lengths, np, kp, cum_b, cum_n,
      kcum, hits, ev, evb);
  return cudaGetLastError();
}

}  // extern "C"
