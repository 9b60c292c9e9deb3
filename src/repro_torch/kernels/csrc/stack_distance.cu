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
//    key is not referenced again before i (next_j >= i, next_j the first
//    reference whose prev is j); inf when p_i < 0 (a compulsory miss, the
//    first reference after a reset included) and on padding.  This is the
//    reference's marker array read off in closed form.
//
//    The identity.  With S the exclusive prefix sum of sizes, for p >= 0:
//      d_i = (S[i] - S[p+1]) - Q(p, i),  Q(p, i) = sum of w_m over the
//                                                  points m < i, q_m > p,
//    where m is a point iff it is the first reference whose prev is q_m =
//    prev_m (next[q_m] == m: the atomicMin keeps the first of duplicated
//    prevs), of weight w_m = sizes[q_m].  A j in (p, i) is dead at step i
//    exactly when next_j = m < i, and then j = q_m > p.  So the three-sided
//    condition (j > p, j < i, next_j >= i) becomes a two-sided dominance
//    count, "the weight of the points before i whose key is above p", and
//    every term is an integer below 2^53: the subtraction is exact.  A
//    prev >= i (no stream makes one) gives 0, as the plain version's.
//
//    Design: an offline dominance sum, a bottom-up merge sort of the
//    references by key (prev) over their positions.  Each reference is one
//    element: (key, position) and (cw, the running weight of its sorted
//    run; acc, its tile's S[i] less its Q so far), an int2 and a double2.
//    When two runs merge, a query of the right run takes off the weight of
//    the left run's points above its key, W_left less the left weight
//    merged before it, read off the running weights where the merge places
//    it: no search per query.  Kernel 1 sets next.  Kernel 2, one block a
//    tile of 4,096 positions (110.6 KB of shared memory, a spare slot
//    every 8 so that no access conflicts on a bank), makes the elements,
//    the tile's prefix sum of sizes and its total, and sorts the tile: 8
//    consecutive elements a thread in registers (pairwise sums, an
//    odd-even transposition sort), then 9 merge levels in shared memory,
//    each thread merging 8 outputs from its merge-path split by selects
//    (no divergence); a level whose pairs lie inside a warp's 256
//    elements syncs only the warp.  Kernel 3 runs each level above the
//    tile over the whole row: a block of 256 threads takes 2,048 outputs
//    between two merge-path splits, each found in device memory by a warp
//    (32 probes a round, a ballot, three or four rounds), stages both
//    segments in shared memory, merges them there and writes them out
//    coalesced; two blocks share an SM.  The last level writes the distances instead.  A
//    row of Np costs log2(Np) merge levels, O(Np log Np) work whatever the
//    reuse gaps, in 3 + log2(Np / 4,096) launches, a memset included.
//    The sizes (tile, elements a thread, outputs a level's block) are the
//    wrapper's, compiled in.
//
//    Bound: bytes (prev and sizes read once, the distances written once:
//    24 B a reference).  The design moves 24 B a reference in and out for
//    each level above the tile, gathers next and sizes at each prev and
//    scatters the distances, mostly in L2 (a bucket of 16 x 32,768 is
//    12.6 MB of elements); inside the tile its levels are bound by shared
//    memory's accesses and barriers, about 2 us a level at 16 x 32,768.
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
// allocated by the caller: sd_distances a workspace of
// sd_distances_work_bytes; sd_cache_sim's "global" design key_slot (B x Kp
// int32; the kernel fills it); sd_fifo_replay cumB (B x Np f64), cumN
// (B x Np int32) and kcum (B x Kp f64, the key state's start: zeros; the
// "smem" design copies it in and leaves it).  Outputs: sd_distances every
// distance (B x Np f64); the replays' hits (B x Np uint8, zeroed by the
// caller: padding stays 0), ev (B int32), evb (B f64).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned FULL_MASK = 0xffffffffu;

// ---- sd_distances: a bottom-up merge sort of the references by prev that
// carries each query's dominance sum

// The design's sizes come from the wrapper (stack_distance.py DIST_TILE,
// DIST_ITEMS, DIST_CHUNK, DIST_MIN_WIDTH), which its tests model: SD_TILE
// positions a block sorts in shared memory, SD_ITEMS consecutive elements
// a thread, MERGE_CHUNK outputs a block of a level over the row merges,
// rows of at least SD_MIN_WIDTH (a power of two).
#if !defined(SD_TILE) || !defined(SD_ITEMS) || !defined(MERGE_CHUNK) || \
    !defined(SD_MIN_WIDTH)
#error "build with -DSD_TILE, -DSD_ITEMS, -DMERGE_CHUNK and -DSD_MIN_WIDTH"
#endif
constexpr int SD_THREADS = SD_TILE / SD_ITEMS;
constexpr int SD_WARPS = SD_THREADS / 32;
constexpr int MERGE_THREADS = MERGE_CHUNK / SD_ITEMS;
static_assert(SD_THREADS % 32 == 0 && SD_THREADS <= 1024 &&
                  MERGE_THREADS >= 64 && MERGE_THREADS % 32 == 0 &&
                  SD_MIN_WIDTH == 32 * SD_ITEMS,
              "sd_distances: unsupported sizes");
constexpr int KEY_NONE = -1;       // no query and no point: inf
constexpr int KEY_ZERO = -2;       // prev >= i: 0, as the plain version's
constexpr size_t SD_ELEM_BYTES = 24;   // (key, idx) int2, (cw, acc) double2
constexpr int KEY_END = 0x7fffffff;    // past a run's end: above every key
constexpr int SD_MAX_WIDTH = 1 << 25;

// Shared-memory slots of element e: one spare slot every 8, so that a
// warp whose lanes each hold SD_ITEMS consecutive elements reaches every
// bank with its 8- and 16-byte accesses.
__device__ __forceinline__ int pad(int e) { return e + (e >> 3); }

__host__ __device__ constexpr size_t sd_smem_bytes(int count) {
  return SD_ELEM_BYTES * (size_t)(count + count / 8);
}

// One sorted buffer of a batch's elements, B x np pairs each: ki (the key,
// prev, and the position) and ca (cw, the running weight within its run,
// inclusive, and acc, the tile's S[i] less the query's Q so far).
struct Elems {
  int2* ki;
  double2* ca;
};

struct Smem {                      // the same, a block's, in shared memory,
  double2* ca;                     // indexed through pad()
  int2* ki;
  __device__ Smem(unsigned char* base, int count)
      : ca(reinterpret_cast<double2*>(base)),
        ki(reinterpret_cast<int2*>(ca + pad(count))) {}
  __device__ int key(int e) const { return ki[pad(e)].x; }
  __device__ void put(int e, int k, int i, double c, double a) const {
    ki[pad(e)] = make_int2(k, i);
    ca[pad(e)] = make_double2(c, a);
  }
};

__global__ void next_set(const long long* __restrict__ prev,
                         const int* __restrict__ lengths, int np,
                         unsigned* __restrict__ next) {
  const int b = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= min(lengths[b], np)) return;
  const long long p = prev[(long long)b * np + i];
  if (p >= 0 && p < i) atomicMin(&next[(long long)b * np + p], (unsigned)i);
}

// How many of the first d outputs of the stable merge of two sorted runs
// (the left one first on ties), la keys from l and lb from r in shared
// memory, come from the left run.
__device__ __forceinline__ int merge_path(const Smem& s, int l, int la,
                                          int r, int lb, int d) {
  int lo = max(0, d - lb), hi = min(d, la);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s.key(l + mid) <= s.key(r + d - 1 - mid)) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// A thread's SD_ITEMS outputs of the merge of two segments in shared
// memory (la elements from l, lb from r), from (a, b).  A right element
// takes off the weight of the left run above its key, wl - PWL(a); each
// element's running weight becomes its own plus the other run's before it.
// pl0 and pr0: each run's weight before its segment.
__device__ __forceinline__ void merge_items(const Smem& s, int l, int la,
                                            int r, int lb, int a, int b,
                                            double pl0, double pr0,
                                            double wl,
                                            int (&k)[SD_ITEMS],
                                            int (&ix)[SD_ITEMS],
                                            double (&cw)[SD_ITEMS],
                                            double (&acc)[SD_ITEMS]) {
  const int2 end = make_int2(KEY_END, 0);
  double pwl = a > 0 ? s.ca[pad(l + a - 1)].x : pl0;
  double pwr = b > 0 ? s.ca[pad(r + b - 1)].x : pr0;
  int2 ha = a < la ? s.ki[pad(l + a)] : end;   // the two heads
  int2 hb = b < lb ? s.ki[pad(r + b)] : end;
#pragma unroll
  for (int j = 0; j < SD_ITEMS; ++j) {   // selects: the lanes never diverge
    const bool left = ha.x <= hb.x;
    const double2 v = s.ca[pad(left ? l + a : r + b)];
    k[j] = left ? ha.x : hb.x;
    ix[j] = left ? ha.y : hb.y;
    cw[j] = v.x + (left ? pwr : pwl);
    acc[j] = left ? v.y : v.y - (wl - pwl);
    pwl = left ? v.x : pwl;
    pwr = left ? pwr : v.x;
    a += left;
    b += !left;
    const int next = left ? a : b;     // the taken run's new head
    const int2 hn = next < (left ? la : lb)
                        ? s.ki[pad((left ? l : r) + next)] : end;
    ha = left ? hn : ha;
    hb = left ? hb : hn;
  }
}

// An exclusive prefix sum of v over the block (exact: integer-valued).
__device__ double block_excl_sum(double v, double* warp_sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  double incl = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double y = __shfl_up_sync(FULL_MASK, incl, off);
    if (lane >= off) incl += y;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const double ws = lane < SD_WARPS ? warp_sums[lane] : 0.0;
    double wi = ws;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const double y = __shfl_up_sync(FULL_MASK, wi, off);
      if (lane >= off) wi += y;
    }
    if (lane < SD_WARPS) warp_sums[lane] = wi - ws;
  }
  __syncthreads();
  return warp_sums[warp] + incl - v;
}

// The distance of each element a thread holds, acc its tile's S[i] - Q:
// S(x) = tp[x / tn] + sloc[x], S the row's exclusive prefix sum of sizes.
__device__ __forceinline__ void scatter(const int (&k)[SD_ITEMS],
                                        const int (&ix)[SD_ITEMS],
                                        const double (&acc)[SD_ITEMS],
                                        const double* tp, int tn,
                                        const double* sloc, double* dist) {
#pragma unroll
  for (int j = 0; j < SD_ITEMS; ++j) {
    double d;
    if (k[j] == KEY_NONE) {
      d = __longlong_as_double(0x7ff0000000000000LL);
    } else if (k[j] == KEY_ZERO) {
      d = 0.0;
    } else {
      const int p1 = k[j] + 1;
      d = (tp[ix[j] / tn] + acc[j]) - (tp[p1 / tn] + sloc[p1]);
    }
    dist[ix[j]] = d;
  }
}

// Kernel 2: one block a tile of tn positions of one row.  Makes the
// elements (the point weights through next), the tile's exclusive prefix
// sum of sizes (sloc) and its total (tsum), and sorts the tile by key
// carrying Q: in registers SD_ITEMS at a time, then merge levels in shared
// memory.  A tile that is the whole row writes its distances; else the
// sorted tile goes to out.
__global__ void __launch_bounds__(SD_THREADS)
dist_tile(const long long* __restrict__ prev,
          const double* __restrict__ sizes, const int* __restrict__ lengths,
          int np, int tn, const unsigned* __restrict__ next,
          double* __restrict__ sloc, double* __restrict__ tsum, Elems out,
          double* __restrict__ dist) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ double warp_sums[SD_WARPS];
  const Smem s(smem, tn);
  const int b = blockIdx.y;
  const long long row = (long long)b * np;
  const int t0 = blockIdx.x * tn;
  const int n = min(lengths[b], np);
  {                                // coalesced, every load issued first
    long long p[SD_ITEMS];
    double sz[SD_ITEMS], w[SD_ITEMS];
    unsigned nx[SD_ITEMS];
#pragma unroll
    for (int j = 0; j < SD_ITEMS; ++j) {
      const int e = threadIdx.x + j * SD_THREADS;
      p[j] = e < tn ? prev[row + t0 + e] : -1;
      sz[j] = e < tn ? sizes[row + t0 + e] : 0.0;
    }
#pragma unroll
    for (int j = 0; j < SD_ITEMS; ++j) {
      const int i = t0 + threadIdx.x + j * SD_THREADS;
      const bool reuse = i < n && p[j] >= 0 && p[j] < i;
      nx[j] = reuse ? next[row + p[j]] : 0u;
      w[j] = reuse ? sizes[row + p[j]] : 0.0;
    }
#pragma unroll
    for (int j = 0; j < SD_ITEMS; ++j) {
      const int e = threadIdx.x + j * SD_THREADS, i = t0 + e;
      const int key = i >= n || p[j] < 0 ? KEY_NONE
                      : p[j] < i         ? (int)p[j]
                                         : KEY_ZERO;
      const bool point = key >= 0 && nx[j] == (unsigned)i;
      if (e < tn) s.put(e, key, i, point ? w[j] : 0.0, sz[j]);
    }
  }
  __syncthreads();
  const int e0 = threadIdx.x * SD_ITEMS;
  const bool active = e0 < tn;
  int k[SD_ITEMS], ix[SD_ITEMS];
  double w[SD_ITEMS], acc[SD_ITEMS], sz[SD_ITEMS];
  double total = 0.0;
#pragma unroll
  for (int j = 0; j < SD_ITEMS; ++j) {
    const int2 q = active ? s.ki[pad(e0 + j)] : make_int2(KEY_NONE, 0);
    const double2 v = active ? s.ca[pad(e0 + j)] : make_double2(0.0, 0.0);
    k[j] = q.x;
    ix[j] = q.y;
    w[j] = v.x;
    sz[j] = v.y;
    total += sz[j];
  }
  double run = block_excl_sum(total, warp_sums);
#pragma unroll
  for (int j = 0; j < SD_ITEMS; ++j) {   // acc starts at the tile's S[i]
    acc[j] = run;
    if (active) s.ca[pad(e0 + j)].y = run;
    run += sz[j];
  }
  if (threadIdx.x == SD_THREADS - 1)
    tsum[(long long)b * (np / tn) + blockIdx.x] = run;
  __syncthreads();
  for (int e = threadIdx.x; e < tn; e += SD_THREADS)   // coalesced
    sloc[row + t0 + e] = s.ca[pad(e)].y;
  // less Q among the thread's own elements, then a stable sort by key
#pragma unroll
  for (int j = 0; j < SD_ITEMS; ++j) {
#pragma unroll
    for (int j2 = 0; j2 < j; ++j2)
      if (k[j2] > k[j]) acc[j] -= w[j2];
  }
#pragma unroll
  for (int ps = 0; ps < SD_ITEMS; ++ps) {
#pragma unroll
    for (int j = ps & 1; j + 1 < SD_ITEMS; j += 2) {
      if (k[j] > k[j + 1]) {
        const int tk = k[j], ti = ix[j];
        const double tw = w[j], ta = acc[j];
        k[j] = k[j + 1]; ix[j] = ix[j + 1]; w[j] = w[j + 1];
        acc[j] = acc[j + 1];
        k[j + 1] = tk; ix[j + 1] = ti; w[j + 1] = tw; acc[j + 1] = ta;
      }
    }
  }
  double cw[SD_ITEMS];
  double c = 0.0;
#pragma unroll
  for (int j = 0; j < SD_ITEMS; ++j) {
    c += w[j];
    cw[j] = c;
  }
  auto put = [&]() {
    if (active)
#pragma unroll
      for (int j = 0; j < SD_ITEMS; ++j)
        s.put(e0 + j, k[j], ix[j], cw[j], acc[j]);
  };
  __syncthreads();                 // every read above is done
  put();
  __syncthreads();
  // a level whose pairs lie inside a warp's elements needs only the warp
  const auto sync = [](int len) {
    if (2 * len <= 32 * SD_ITEMS) __syncwarp();
    else __syncthreads();
  };
  for (int len = SD_ITEMS; len < tn; len <<= 1) {
    if (active) {                  // runs [pb, pb + len), [pb + len, +len)
      const int pb = e0 & ~(2 * len - 1), d = e0 - pb;
      const int a = merge_path(s, pb, len, pb + len, len, d);
      merge_items(s, pb, len, pb + len, len, a, d - a, 0.0, 0.0,
                  s.ca[pad(pb + len - 1)].x, k, ix, cw, acc);
    }
    sync(len);
    put();
    sync(2 * len);                 // before the next level's reads
  }
  if (tn == np) {                  // the whole row: the distances
    const double zero = 0.0;
    if (active) scatter(k, ix, acc, &zero, tn, sloc + row, dist + row);
    return;
  }
  for (int e = threadIdx.x; e < tn; e += SD_THREADS) {   // coalesced
    out.ki[row + t0 + e] = s.ki[pad(e)];
    out.ca[row + t0 + e] = s.ca[pad(e)];
  }
}

// Kernel 3: one level over the row: merge runs of len into runs of
// 2 len, one block a chunk of MERGE_CHUNK outputs (two blocks an SM, so
// that one's loads overlap the other's merge) between the splits its
// first two warps find in device memory.  The last level (2 len == np)
// writes the distances instead.
template <bool FINAL>
__global__ void __launch_bounds__(MERGE_THREADS)
dist_merge(Elems in, Elems out, int np, int len,
           const double* __restrict__ sloc, const double* __restrict__ tsum,
           double* __restrict__ dist) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int split[2];
  const Smem s(smem, MERGE_CHUNK);
  const int b = blockIdx.y;
  const long long row = (long long)b * np;
  const int r0 = blockIdx.x * MERGE_CHUNK;
  const int pb = r0 & ~(2 * len - 1), d0 = r0 - pb;
  const int2* kl = in.ki + row + pb;
  const int2* kr = kl + len;
  // the merge-path splits at d0 (warp 0) and d0 + MERGE_CHUNK (warp 1),
  // each found by its warp: 32 samples a round over the range left, the
  // count of true predicates (true, then false) narrowing it to the gap
  // after the last true one
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp < 2) {
    const int d = d0 + warp * MERGE_CHUNK;
    int lo = max(0, d - len), hi = min(d, len);
    while (lo < hi) {              // the same values in every lane
      const int step = (hi - lo + 31) / 32, x = lo + lane * step;
      const int c = __popc(__ballot_sync(
          FULL_MASK, x < hi && kl[x].x <= kr[d - 1 - x].x));
      if (c == 0) {
        hi = lo;
      } else {
        hi = min(hi, lo + c * step);
        lo = lo + (c - 1) * step + 1;
      }
    }
    if (lane == 0) split[warp] = lo;
  }
  __syncthreads();
  const int a0 = split[0], a1 = split[1];
  const int b0 = d0 - a0, la = a1 - a0, lb = MERGE_CHUNK - la;
  const long long lbase = row + pb + a0, rbase = row + pb + len + b0;
  {                                // coalesced, every load issued first
    int2 q[SD_ITEMS];
    double2 v[SD_ITEMS];
#pragma unroll
    for (int j = 0; j < SD_ITEMS; ++j) {
      const int e = threadIdx.x + j * MERGE_THREADS;
      const long long g = e < la ? lbase + e : rbase + (e - la);
      q[j] = in.ki[g];
      v[j] = in.ca[g];
    }
#pragma unroll
    for (int j = 0; j < SD_ITEMS; ++j) {
      const int at = pad(threadIdx.x + j * MERGE_THREADS);
      s.ki[at] = q[j];
      s.ca[at] = v[j];
    }
  }
  const double pl0 = a0 > 0 ? in.ca[lbase - 1].x : 0.0;
  const double pr0 = b0 > 0 ? in.ca[rbase - 1].x : 0.0;
  const double wl = in.ca[row + pb + len - 1].x;
  double* tp = reinterpret_cast<double*>(smem + sd_smem_bytes(MERGE_CHUNK));
  if (FINAL && threadIdx.x < 32) {  // the tiles' exclusive prefix sums
    const int nt = np / SD_TILE;
    double carry = 0.0;
    for (int base = 0; base < nt; base += 32) {
      const double v = base + lane < nt ? tsum[(long long)b * nt + base +
                                                lane] : 0.0;
      double incl = v;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const double y = __shfl_up_sync(FULL_MASK, incl, off);
        if (lane >= off) incl += y;
      }
      if (base + lane < nt) tp[base + lane] = carry + (incl - v);
      carry += __shfl_sync(FULL_MASK, incl, 31);
    }
  }
  __syncthreads();
  const int dt = threadIdx.x * SD_ITEMS;
  const int a = merge_path(s, 0, la, la, lb, dt);
  int k[SD_ITEMS], ix[SD_ITEMS];
  double cw[SD_ITEMS], acc[SD_ITEMS];
  merge_items(s, 0, la, la, lb, a, dt - a, pl0, pr0, wl, k, ix, cw, acc);
  if (FINAL) {
    scatter(k, ix, acc, tp, SD_TILE, sloc + row, dist + row);
    return;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < SD_ITEMS; ++j) s.put(dt + j, k[j], ix[j], cw[j], acc[j]);
  __syncthreads();
  for (int e = threadIdx.x; e < MERGE_CHUNK; e += MERGE_THREADS) {
    out.ki[row + r0 + e] = s.ki[pad(e)];   // coalesced
    out.ca[row + r0 + e] = s.ca[pad(e)];
  }
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

// The kernels' shared-memory limits, once a device, at the most any row
// takes (a race between threads sets the same values).
static cudaError_t sd_distances_configure() {
  static bool done[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && done[dev])) return err;
  const int merge_most =
      (int)sd_smem_bytes(MERGE_CHUNK) + 8 * (SD_MAX_WIDTH / SD_TILE);
  err = cudaFuncSetAttribute(dist_tile,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)sd_smem_bytes(SD_TILE));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(dist_merge<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               merge_most);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(dist_merge<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               merge_most);
  if (err != cudaSuccess) cudaGetLastError();   // reported here, not later
  else if (dev < 64) done[dev] = true;
  return err;
}

// sd_distances' scratch for a batch of rows of np (a power of two, at
// least SD_MIN_WIDTH): sloc (B x np f64), tsum (B x np / tile f64), next
// (B x np uint32) and, when a row is more than one tile, two element
// buffers of 24 B a position.
long long sd_distances_work_bytes(int batch, int np) {
  const long long cells = (long long)batch * np;
  const int tn = np < SD_TILE ? np : SD_TILE;
  return cells * 12 + (long long)batch * (np / tn) * 8 +
         (np > tn ? 2 * cells * (long long)SD_ELEM_BYTES : 0);
}

int sd_distances(const long long* prev, const double* sizes,
                 const int* lengths, int batch, int np, void* work,
                 double* out, void* stream) {
  if (np < SD_MIN_WIDTH || np > SD_MAX_WIDTH || (np & (np - 1)) != 0)
    return cudaErrorInvalidValue;
  cudaError_t err = sd_distances_configure();
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long cells = (long long)batch * np;
  const int tn = np < SD_TILE ? np : SD_TILE, nt = np / tn;
  // the widest first: every array stays aligned
  const long long runs = np > tn ? 2 * cells : 0;
  double2* ca = static_cast<double2*>(work);
  double* sloc = reinterpret_cast<double*>(ca + runs);
  double* tsum = sloc + cells;
  int2* ki = reinterpret_cast<int2*>(tsum + (long long)batch * nt);
  unsigned* next = reinterpret_cast<unsigned*>(ki + runs);
  Elems run[2] = {{ki, ca}, {ki + cells, ca + cells}};
  const int tile_smem = (int)sd_smem_bytes(tn);
  const int merge_smem = (int)sd_smem_bytes(MERGE_CHUNK) + 8 * nt;
  err = cudaMemsetAsync(next, 0xff, cells * sizeof(unsigned), s);
  if (err != cudaSuccess) return err;
  next_set<<<dim3((np + 255) / 256, batch), 256, 0, s>>>(prev, lengths, np,
                                                         next);
  dist_tile<<<dim3(nt, batch), SD_THREADS, tile_smem, s>>>(
      prev, sizes, lengths, np, tn, next, sloc, tsum, run[0], out);
  err = cudaGetLastError();
  int cur = 0;
  for (int len = tn; len < np && err == cudaSuccess; len <<= 1) {
    const dim3 grid(np / MERGE_CHUNK, batch);
    if (2 * len == np)
      dist_merge<true><<<grid, MERGE_THREADS, merge_smem, s>>>(
          run[cur], run[cur ^ 1], np, len, sloc, tsum, out);
    else
      dist_merge<false><<<grid, MERGE_THREADS, merge_smem - 8 * nt, s>>>(
          run[cur], run[cur ^ 1], np, len, sloc, tsum, out);
    cur ^= 1;
    err = cudaGetLastError();
  }
  return err;
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
