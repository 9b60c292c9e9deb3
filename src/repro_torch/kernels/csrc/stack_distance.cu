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
//    taken and +inf (cumN 0) from step t on, so j <= t.  Here one thread
//    carries one problem, and the search scans forward from the last
//    answer, a valid lower bound while cumB[lo - 1] < target (checked; if
//    it fails the scan restarts at 0, so the answer is exact on any
//    input).  E only grows in a valid stream, so the scans cost O(Np) in
//    all.  A reset sets E = total (nothing counted).
//
// Both replays are a chain of N dependent steps (a step's hit test reads
// the state the step before wrote), one thread per problem, one problem per
// block so each gets an SM; their state lives in global memory, L2-resident:
// at Np 32768 and Kp 8192 the FIFO state is 32768 x 12 B + 8192 x 8 B =
// 458 KB a problem, over one SM's 228 KB of shared memory.  What bounds
// them is the chain's latency (an L2 round trip per dependent load), not
// bytes; making each step cheaper is later work.
//
// Plain C interface, loaded with ctypes: each function returns the
// cudaError_t of its launches and never synchronises.  Scratch is
// allocated by the caller: sd_distances needs next (B x Np int32);
// sd_cache_sim slot_bytes (B x Np f64), slot_key (B x Np int32), key_slot
// (B x Kp int32) and res_epoch (B x Kp int32, zeroed); sd_fifo_replay
// cumB (B x Np f64), cumN (B x Np int32) and kcum (B x Kp f64, zeroed).
// Outputs: hits (B x Np uint8, zeroed by the caller: padding stays 0),
// ev (B int32), evb (B f64).

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int DIST_WARPS = 8;  // warps (references) per block of kernel 2

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

__global__ void fifo_replay(const int* __restrict__ keys,
                            const double* __restrict__ sizes,
                            const unsigned char* __restrict__ admit,
                            const unsigned char* __restrict__ reset,
                            const double* __restrict__ capacity,
                            const int* __restrict__ lengths, int np, int kp,
                            double* __restrict__ cum_b,
                            int* __restrict__ cum_n,
                            double* __restrict__ kcum_all,
                            unsigned char* __restrict__ hits,
                            int* __restrict__ ev_out,
                            double* __restrict__ evb_out) {
  const int b = blockIdx.x;
  if (threadIdx.x != 0) return;
  const long long row = (long long)b * np;
  const int n = min(lengths[b], np);
  const double cap = capacity[b];
  const double inf = __longlong_as_double(0x7ff0000000000000LL);
  double* cb = cum_b + row;
  int* cn = cum_n + row;
  double* kcum = kcum_all + (long long)b * kp;
  double total = 0.0, e = 0.0, evb = 0.0;
  int tot_n = 0, e_n = 0, ev = 0;
  int lo = 0;          // search hint: the last answer
  for (int t = 0; t < n; ++t) {
    const int k = keys[row + t];
    const double s = sizes[row + t];
    if (reset[row + t]) {  // everything admitted so far is gone, uncounted
      e = total;
      e_n = tot_n;
    }
    const bool hit = kcum[k] > e;
    const bool ins = !hit && admit[row + t] != 0;
    const double target = total + s - cap;
    if (ins && target > e) {
      // first j in [0, t] with cumB[j] >= target; cumB[t] is +inf
      if (lo > t || (lo > 0 && cb[lo - 1] >= target)) lo = 0;
      int j = lo;
      while (j < t && !(cb[j] >= target)) ++j;
      lo = j;
      const double new_e = j < t ? cb[j] : inf;
      const int new_n = j < t ? cn[j] : 0;
      ev += new_n - e_n;
      evb += new_e - e;
      e = new_e;
      e_n = new_n;
    }
    if (ins) {
      total += s;
      tot_n += 1;
      kcum[k] = total;
    }
    cb[t] = total;
    cn[t] = tot_n;
    hits[row + t] = hit;
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

int sd_fifo_replay(const int* keys, const double* sizes,
                   const unsigned char* admit, const unsigned char* reset,
                   const double* capacity, const int* lengths, int batch,
                   int np, int kp, double* cum_b, int* cum_n, double* kcum,
                   unsigned char* hits, int* ev, double* evb, void* stream) {
  fifo_replay<<<batch, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      keys, sizes, admit, reset, capacity, lengths, np, kp, cum_b, cum_n,
      kcum, hits, ev, evb);
  return cudaGetLastError();
}

}  // extern "C"
