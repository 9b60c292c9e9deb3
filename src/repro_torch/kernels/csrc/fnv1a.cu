// FNV-1a-64 digests of one object's chunks for Hopper (sm_90a): every
// chunk of the object in one call, each chunk split exactly across the
// card.  For chunk c of an object of n bytes cut into chunks of C bytes
// (the last one shorter):
//
//   h = 0xCBF29CE484222325;  for each byte b:  h = (h ^ b) * P  mod 2^64,
//   P = 2^40 + 0x1B3
//
// over bytes c C .. min((c + 1) C, n) - 1.  An object of 0 bytes is one
// chunk whose digest is the offset basis.
//
// Replaces: no TPU kernel.  The reference digests every real-bytes chunk
// with host Python (`fnv1a64`, src/repro/core/chunk.py:27): on store
// (`chunk_object`, through writeback.py:57), on drain (`put_object`,
// origin.py:74) and on every verified read (`Payload.verify`,
// client.py:210, :218).
//
// The split.  The xor touches only the low byte, so h ^ b = h + d with
// d = (l ^ b) - l, l = h mod 256, and given the d's the recurrence is
// affine: a segment of L bytes maps h to h P^L + sum d_n P^(L-n).  The
// low byte is an automaton of its own, l' = ((l ^ b) 0xB3) mod 256 (P mod
// 256 = 0xB3).  So a chunk, cut into segments of FNV_SEG bytes, digests
// in four exact stages:
//   1. tables  (fnv_tables): each segment's map from its start low byte
//      to its end low byte, for all 256 start values; a block composes
//      its group of FNV_GROUP segments in shared memory into prefix
//      tables (group start byte -> each segment's start byte) and the
//      group's table;
//   2. walk    (fnv_walk): a block a chunk walks its group tables in
//      shared memory from the offset basis's low byte 0x25, giving each
//      group's start byte;
//   3. partials (fnv_partials): a thread a segment reads its start byte
//      l_s from its prefix table and runs the real 64-bit FNV-1a over the
//      segment from l_s alone (upper bits zero), giving G_s; the segment
//      is then the affine map h -> P^L_s h + (G_s - l_s P^L_s), valid
//      for every h whose low byte is l_s, and a block composes its
//      group's maps in order;
//   4. combine (fnv_combine): a block a chunk composes its groups' maps
//      in order and applies them to the offset basis.
// All arithmetic is integer mod 2^64 (or mod 256), so the digests equal
// the host loop's bit for bit whatever the order of the compositions.
// A chunk of at most one segment skips the split: design "short"
// (fnv_short), a thread a chunk from the offset basis, as one segment's
// partial.  The call picks the design by the object's longest chunk
// (the wrapper counts it by the same rule).
//
// What bounds it: bytes.  A 24 MiB chunk read once at 3.35 TB/s is
// 7.51 us.  The work the split adds is the table stage's: 256 start
// values times every byte, 6.4e9 value-steps a 24 MiB chunk.
//
// What the design does about it: the table stage packs two start values
// in a 32-bit register (bytes at bits 0 and 16): a byte's step is one
// LOP3, x = (r ^ (b | b << 16)) & 0x00FF00FF, and one IMAD, r = x 0xB3
// (each product stays below 2^16, so the halves never mix).  Sixteen
// lanes take a segment's 128 pairs, eight a lane, so a byte's PRMT that
// spreads it to both halves is shared by eight pairs and a warp runs two
// segments; a lane's eight chains are independent, and a block's eight
// warps, several blocks an SM, hide the pair's latency.  A warp's lane 0
// stages its segments' bytes in shared memory by 1-D bulk copies (TMA) on
// an mbarrier a stage, a ring of STAGES stages a warp; every lane of
// a half-warp reads the same 16-byte word (a broadcast).  The grid covers
// (chunk, group of segments) pairs, so one 24 MiB chunk is 384 blocks
// over the 132 SMs.  Stages 2-4 are short: the walk is a chunk's group
// count of shared-memory lookups (384 at 24 MiB), the partials one
// segment's chain a thread, the compositions warp-shuffle trees.  The
// table stage keeps the low byte alone: the alternative, all 256 starts'
// full 64-bit partials in stage 1 (stages 2-4 then one walk), costs five
// instructions a value-step against one, and took 1.570 ms a 24 MiB
// chunk against this table stage's 0.244 on an H100 80GB HBM3 at 700 W
// (kernel_probe.py fnv, which builds it with -DFNV_PROBE=1).
//
// Plain C interface, loaded with ctypes; every launch's cudaError_t is
// returned and nothing synchronises.  The wrapper allocates the
// workspace (fnv1a_work_bytes).

#include <cuda_runtime.h>

#include <cstdint>

#ifndef FNV_SEG
#define FNV_SEG 2048      // bytes a segment: a multiple of 16
#endif
#ifndef FNV_GROUP
#define FNV_GROUP 32      // segments a group: a multiple of 32, <= 256
#endif
#ifndef FNV_PROBE
#define FNV_PROBE 0
#endif

namespace {

constexpr unsigned long long FNV_OFFSET = 0xCBF29CE484222325ull;
constexpr unsigned long long FNV_PRIME = 0x100000001B3ull;
constexpr unsigned P_LO = 0x1B3u;  // P = 2^40 + P_LO
constexpr int AHEAD = 8;           // 16-byte loads a chain keeps in flight
constexpr int SHORT_THREADS = 64;  // chunks a block of the short design

constexpr int SEG = FNV_SEG;
constexpr int GROUP = FNV_GROUP;
constexpr int TABLE_WARPS = 8;        // a table block: 256 threads
constexpr int SEG_LANES = 16;         // lanes a segment
constexpr int PAIRS = 128 / SEG_LANES;  // start-value pairs a lane
constexpr int STAGES = 2;             // ring stages a warp
constexpr int ROUND_SEGS = TABLE_WARPS * (32 / SEG_LANES);  // a block round
constexpr int ROUNDS = (GROUP + ROUND_SEGS - 1) / ROUND_SEGS;
constexpr int SLOT = SEG + 16;        // a segment's bytes, 16-byte aligned
constexpr int WALK_TABLES = 128;      // group tables a walk stage holds
constexpr int COMBINE_THREADS = 256;
constexpr int BARS_BYTES = 8 * TABLE_WARPS * STAGES;
constexpr int TABLE_SMEM = BARS_BYTES + GROUP * 256 +
                           TABLE_WARPS * STAGES * (32 / SEG_LANES) * SLOT;

static_assert(SEG % 16 == 0 && SEG >= 16, "FNV_SEG: a multiple of 16");
static_assert(GROUP % 32 == 0 && GROUP <= 256, "FNV_GROUP: 32..256 by 32");
static_assert(BARS_BYTES % 16 == 0, "the tables follow 16-byte aligned");

struct Map {  // h -> a h + b mod 2^64
  unsigned long long a, b;
};

// later o earlier
__device__ __forceinline__ Map compose(Map later, Map earlier) {
  return {later.a * earlier.a, later.a * earlier.b + later.b};
}

__device__ __forceinline__ unsigned long long pow_p(long long e) {
  unsigned long long r = 1, base = FNV_PRIME;
  for (; e; e >>= 1, base *= base)
    if (e & 1) r *= base;
  return r;
}

// Compose the block's maps, one a thread in thread order (thread i's map
// first), into thread 0's: a shuffle tree a warp, then the warps' maps in
// order.  blockDim.x is a multiple of 32, at most 256.
__device__ Map block_compose(Map m) {
  __shared__ Map warps[8];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const Map later = {__shfl_down_sync(0xffffffffu, m.a, d),
                       __shfl_down_sync(0xffffffffu, m.b, d)};
    if ((lane & (2 * d - 1)) == 0) m = compose(later, m);
  }
  if (lane == 0) warps[warp] = m;
  __syncthreads();
  if (threadIdx.x == 0)
    for (int w = 1; w < (int)(blockDim.x >> 5); ++w) m = compose(warps[w], m);
  return m;
}

// ---------------------------------------------------------------------------
// A serial chain: h from h0 over bytes [begin, end) of data
// ---------------------------------------------------------------------------

// h = lo + 2^32 hi.  (h ^ b) P mod 2^64 with x = lo ^ b:
//   lo' = x P_LO mod 2^32,  hi' = hi P_LO + (x P_LO >> 32) + (x << 8).
__device__ __forceinline__ void fnv_byte(unsigned& lo, unsigned& hi,
                                         unsigned b) {
  const unsigned x = lo ^ b;
  hi = hi * P_LO + (__umulhi(x, P_LO) + (x << 8));
  lo = x * P_LO;
}

// The sixteen bytes of a vector, in address order (little-endian words).
__device__ __forceinline__ void fnv_vec(unsigned& lo, unsigned& hi,
                                        const uint4& v) {
  const unsigned words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      fnv_byte(lo, hi, (words[q] >> (8 * i)) & 0xffu);
}

// A thread reads its range in 16-byte loads, a batch of AHEAD of them in
// registers while the batch before is hashed (the last batch loads itself
// again rather than read past the range); the bytes before the first
// 16-byte boundary and after the last whole vector go one load each.
__device__ unsigned long long fnv_range(const uint8_t* __restrict__ data,
                                        long long begin, long long end,
                                        unsigned long long h0) {
  unsigned lo = unsigned(h0), hi = unsigned(h0 >> 32);
  const uintptr_t base = reinterpret_cast<uintptr_t>(data);
  const long long aligned = (long long)(((base + begin + 15) & ~uintptr_t(15))
                                        - base);
  long long i = begin;
  for (const long long head = aligned < end ? aligned : end; i < head; ++i)
    fnv_byte(lo, hi, data[i]);
  const uint4* vec = reinterpret_cast<const uint4*>(data + i);
  const long long n_vec = (end - i) / 16;
  const long long n_batch = n_vec / AHEAD;
  uint4 cur[AHEAD];
  if (n_batch > 0) {
#pragma unroll
    for (int j = 0; j < AHEAD; ++j) cur[j] = __ldg(vec + j);
  }
  for (long long k = 0; k < n_batch; ++k) {
    const uint4* src = vec + (k + 1 < n_batch ? k + 1 : k) * AHEAD;
    uint4 next[AHEAD];
#pragma unroll
    for (int j = 0; j < AHEAD; ++j) next[j] = __ldg(src + j);
#pragma unroll
    for (int j = 0; j < AHEAD; ++j) fnv_vec(lo, hi, cur[j]);
#pragma unroll
    for (int j = 0; j < AHEAD; ++j) cur[j] = next[j];
  }
  for (long long k = n_batch * AHEAD; k < n_vec; ++k)
    fnv_vec(lo, hi, __ldg(vec + k));
  for (i += n_vec * 16; i < end; ++i) fnv_byte(lo, hi, data[i]);
  return (unsigned long long)hi << 32 | lo;
}

// Design "short": a thread a chunk, from the offset basis.
__global__ void __launch_bounds__(SHORT_THREADS)
    fnv_short(const uint8_t* __restrict__ data, long long n, long long chunk,
              long long n_chunks, unsigned long long* __restrict__ out) {
  const long long c = (long long)blockIdx.x * SHORT_THREADS + threadIdx.x;
  if (c >= n_chunks) return;
  const long long begin = c * chunk;
  const long long end = begin + chunk < n ? begin + chunk : n;
  out[c] = fnv_range(data, begin, end, FNV_OFFSET);
}

// ---------------------------------------------------------------------------
// The split: the layout of one call
// ---------------------------------------------------------------------------

struct Split {
  long long n, chunk, n_chunks;
  int segs;    // segments of a whole chunk
  int groups;  // groups of a whole chunk

  __device__ __host__ long long chunk_len(long long c) const {
    return c + 1 < n_chunks ? chunk : n - c * chunk;
  }
  __device__ __host__ int segs_of(long long c) const {
    return (int)((chunk_len(c) + SEG - 1) / SEG);
  }
  __device__ __host__ int groups_of(long long c) const {
    return (segs_of(c) + GROUP - 1) / GROUP;
  }
};

__host__ Split make_split(long long n, long long chunk, long long n_chunks) {
  Split s{n, chunk, n_chunks, 0, 0};
  s.segs = (int)((chunk + SEG - 1) / SEG);
  s.groups = (s.segs + GROUP - 1) / GROUP;
  return s;
}

// The workspace: each group's map (16 B), each segment's prefix table
// (256 B), each group's table (256 B) and start byte, at the strides of a
// whole chunk.
struct Work {
  Map* maps;
  uint8_t* prefix;
  uint8_t* group_tab;
  uint8_t* gstart;
};

__host__ long long work_bytes(const Split& s) {
  const long long groups = s.n_chunks * s.groups;
  return groups * 16 + s.n_chunks * s.segs * 256LL + groups * 256 +
         ((groups + 15) & ~15LL);
}

__host__ Work carve(const Split& s, void* base) {
  uint8_t* p = static_cast<uint8_t*>(base);
  const long long groups = s.n_chunks * s.groups;
  Work w;
  w.maps = reinterpret_cast<Map*>(p);
  w.prefix = p + groups * 16;
  w.group_tab = w.prefix + s.n_chunks * s.segs * 256LL;
  w.gstart = w.group_tab + groups * 256;
  return w;
}

// ---------------------------------------------------------------------------
// Stage 1: the segments' low-byte tables, a block a group
// ---------------------------------------------------------------------------

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

// A wait that never completes (a copy that never lands) traps rather
// than hangs the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t tries = 0; !done; ++tries) {
    if (tries == (1u << 26)) __trap();
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

// One byte of the low-byte automaton for a lane's PAIRS pairs of start
// values: bb holds the byte at bits 0 and 16.
__device__ __forceinline__ void table_step(unsigned (&r)[PAIRS],
                                           unsigned bb) {
#pragma unroll
  for (int p = 0; p < PAIRS; ++p) r[p] = ((r[p] ^ bb) & 0x00FF00FFu) * 0xB3u;
}

// Byte K of w at bits 0 and 16 (one PRMT).
template <int K>
__device__ __forceinline__ unsigned spread(unsigned w) {
  return __byte_perm(w, 0u, 0x4040u | (K * 0x0101u));
}

__device__ __forceinline__ void table_word(unsigned (&r)[PAIRS], unsigned w) {
  table_step(r, spread<0>(w));
  table_step(r, spread<1>(w));
  table_step(r, spread<2>(w));
  table_step(r, spread<3>(w));
}

// The 16-byte-aligned span of global memory holding [begin, end) of data:
// every 16-byte granule of it holds a byte of the range, so no copy
// reaches a page the object does not touch.
struct Span {
  const uint8_t* src;
  uint32_t bytes;
  int skip;  // the range's first byte within the span
};

__device__ __forceinline__ Span span_of(const uint8_t* data, long long begin,
                                        long long end) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(data + begin);
  const uintptr_t lo = a & ~uintptr_t(15);
  const uintptr_t hi = (reinterpret_cast<uintptr_t>(data + end) + 15) &
                       ~uintptr_t(15);
  return {reinterpret_cast<const uint8_t*>(lo), uint32_t(hi - lo),
          int(a - lo)};
}

__global__ void __launch_bounds__(TABLE_WARPS * 32)
    fnv_tables(const uint8_t* __restrict__ data, Split sp, Work wk) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  uint8_t* tabs = smem + BARS_BYTES;
  uint8_t* slots = tabs + GROUP * 256;
  const long long c = blockIdx.x / sp.groups;
  const int g = blockIdx.x % sp.groups;
  const int segs = sp.segs_of(c);
  const int s0 = g * GROUP;
  if (s0 >= segs) return;                  // the last chunk's spare groups
  const int nseg = min(GROUP, segs - s0);
  const long long cbeg = c * sp.chunk, cend = cbeg + sp.chunk_len(c);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int half = lane / SEG_LANES, u = lane % SEG_LANES;
  if (threadIdx.x == 0) {
    for (int b = 0; b < TABLE_WARPS * STAGES; ++b)
      mbar_init(smem_u32(bars + b), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // round i of warp w: the group's segments 2 (i TABLE_WARPS + w) + half
  auto seg_of = [&](int i, int h) {
    return (i * TABLE_WARPS + warp) * (32 / SEG_LANES) + h;
  };
  auto slot_of = [&](int i, int h) {
    return slots + ((warp * STAGES + i % STAGES) * (32 / SEG_LANES) + h) *
                       SLOT;
  };
  auto seg_range = [&](int ls, long long& begin, long long& end) {
    begin = cbeg + (long long)(s0 + ls) * SEG;
    end = begin + SEG < cend ? begin + SEG : cend;
  };
  auto issue = [&](int i) {                // lane 0 of the warp
    const uint32_t bar = smem_u32(bars + warp * STAGES + i % STAGES);
    Span spans[32 / SEG_LANES];
    uint32_t total = 0;
#pragma unroll
    for (int h = 0; h < 32 / SEG_LANES; ++h) {
      spans[h].bytes = 0;
      if (seg_of(i, h) < nseg) {
        long long begin, end;
        seg_range(seg_of(i, h), begin, end);
        spans[h] = span_of(data, begin, end);
        total += spans[h].bytes;
      }
    }
    mbar_expect_tx(bar, total);
#pragma unroll
    for (int h = 0; h < 32 / SEG_LANES; ++h)
      if (spans[h].bytes) bulk_load(slot_of(i, h), spans[h].src,
                                    spans[h].bytes, bar);
  };

  if (lane == 0)
    for (int i = 0; i < STAGES && i < ROUNDS && seg_of(i, 0) < nseg; ++i)
      issue(i);
  for (int i = 0; i < ROUNDS && seg_of(i, 0) < nseg; ++i) {
    mbar_wait(smem_u32(bars + warp * STAGES + i % STAGES),
              (i / STAGES) & 1);
    const int ls = seg_of(i, half);
    if (ls < nseg) {
      long long begin, end;
      seg_range(ls, begin, end);
      const uint8_t* p = slot_of(i, half);
      int k = span_of(data, begin, end).skip;
      const int stop = k + int(end - begin);
      unsigned r[PAIRS];
#pragma unroll
      for (int q = 0; q < PAIRS; ++q) {
        const unsigned v = q * SEG_LANES + u;
        r[q] = v | (v + 128) << 16;
      }
      for (; (k & 15) && k < stop; ++k) table_step(r, spread<0>(p[k]));
      for (; k + 16 <= stop; k += 16) {
        const uint4 v = *reinterpret_cast<const uint4*>(p + k);
        table_word(r, v.x);
        table_word(r, v.y);
        table_word(r, v.z);
        table_word(r, v.w);
      }
      for (; k < stop; ++k) table_step(r, spread<0>(p[k]));
      uint8_t* t = tabs + ls * 256;
#pragma unroll
      for (int q = 0; q < PAIRS; ++q) {
        const int v = q * SEG_LANES + u;
        t[v] = uint8_t(r[q]);
        t[v + 128] = uint8_t(r[q] >> 16);
      }
    }
    __syncwarp();
    if (lane == 0 && i + STAGES < ROUNDS && seg_of(i + STAGES, 0) < nseg) {
      // the stage's reads are done: hand it back to the copy engine
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      issue(i + STAGES);
    }
  }
  __syncthreads();
  // compose: thread v walks its start value through the group's tables
  const int v = threadIdx.x;
  uint8_t* prefix = wk.prefix + (c * sp.segs + s0) * 256LL;
  unsigned l = v;
  for (int s = 0; s < nseg; ++s) {
    prefix[s * 256 + v] = uint8_t(l);
    l = tabs[s * 256 + l];
  }
  wk.group_tab[(c * sp.groups + g) * 256LL + v] = uint8_t(l);
}

// ---------------------------------------------------------------------------
// Stage 2: each group's start byte, a block a chunk
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(256)
    fnv_walk(Split sp, Work wk) {
  __shared__ __align__(16) uint8_t tab[WALK_TABLES * 256];
  const long long c = blockIdx.x;
  const int ng = sp.groups_of(c);
  const uint8_t* src = wk.group_tab + c * sp.groups * 256LL;
  uint8_t* gstart = wk.gstart + c * sp.groups;
  unsigned l = unsigned(FNV_OFFSET & 0xff);
  for (int g0 = 0; g0 < ng; g0 += WALK_TABLES) {
    const int cnt = min(WALK_TABLES, ng - g0);
    const uint4* from = reinterpret_cast<const uint4*>(src + g0 * 256LL);
    for (int k = threadIdx.x; k < cnt * 16; k += blockDim.x)
      reinterpret_cast<uint4*>(tab)[k] = from[k];
    __syncthreads();
    if (threadIdx.x == 0)
      for (int k = 0; k < cnt; ++k) {
        gstart[g0 + k] = uint8_t(l);
        l = tab[k * 256 + l];
      }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// Stage 3: each segment's partial, composed into its group's map
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(GROUP)
    fnv_partials(const uint8_t* __restrict__ data, Split sp, Work wk) {
  const long long c = blockIdx.x / sp.groups;
  const int g = blockIdx.x % sp.groups;
  const int segs = sp.segs_of(c);
  if (g * GROUP >= segs) return;
  const int s = g * GROUP + threadIdx.x;
  Map m = {1, 0};
  if (s < segs) {
    const unsigned ls = wk.prefix[(c * sp.segs + s) * 256LL +
                                  wk.gstart[c * sp.groups + g]];
    const long long cbeg = c * sp.chunk, cend = cbeg + sp.chunk_len(c);
    const long long begin = cbeg + (long long)s * SEG;
    const long long end = begin + SEG < cend ? begin + SEG : cend;
    const unsigned long long gs = fnv_range(data, begin, end, ls);
    m.a = pow_p(end - begin);
    m.b = gs - ls * m.a;
  }
  m = block_compose(m);
  if (threadIdx.x == 0) wk.maps[c * sp.groups + g] = m;
}

// ---------------------------------------------------------------------------
// Stage 4: a chunk's digest
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(COMBINE_THREADS)
    fnv_combine(Split sp, Work wk, unsigned long long* __restrict__ out) {
  const long long c = blockIdx.x;
  const int ng = sp.groups_of(c);
  const Map* maps = wk.maps + c * sp.groups;
  const int per = (ng + COMBINE_THREADS - 1) / COMBINE_THREADS;
  const int g0 = threadIdx.x * per, g1 = min(g0 + per, ng);
  Map m = {1, 0};
  for (int g = g0; g < g1; ++g) m = compose(maps[g], m);
  m = block_compose(m);
  if (threadIdx.x == 0) out[c] = m.a * FNV_OFFSET + m.b;
}

bool is_short(long long n, long long chunk) {
  return (chunk < n ? chunk : n) <= SEG;
}

#if FNV_PROBE
// The alternative table stage (kernel_probe.py only): every segment's full
// 64-bit FNV-1a from all 256 start values, one thread a start value, the
// bytes read from device memory (each read broadcasts over the block).
__global__ void __launch_bounds__(256)
    fnv_tables64(const uint8_t* __restrict__ data, long long n,
                 unsigned long long* __restrict__ out) {
  const long long begin = (long long)blockIdx.x * SEG;
  const long long end = begin + SEG < n ? begin + SEG : n;
  out[blockIdx.x * 256LL + threadIdx.x] =
      fnv_range(data, begin, end, threadIdx.x);
}
#endif

}  // namespace

extern "C" {

// The workspace bytes of a call (0 for the short design).
long long fnv1a_work_bytes(long long n, long long chunk, long long n_chunks) {
  if (chunk <= 0 || n_chunks <= 0 || is_short(n, chunk)) return 0;
  return work_bytes(make_split(n, chunk, n_chunks));
}

// data: n bytes on the device (any alignment); out: n_chunks uint64 on
// the device, n_chunks = max(1, ceil(n / chunk)); work: fnv1a_work_bytes
// on the device.  Returns a cudaError_t (0 = success).
int fnv1a_chunks_launch(const void* data, long long n, long long chunk,
                        long long n_chunks, void* work, void* out,
                        void* stream) {
  if (chunk <= 0 || n_chunks <= 0) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* bytes = static_cast<const uint8_t*>(data);
  unsigned long long* digests = static_cast<unsigned long long*>(out);
  if (is_short(n, chunk)) {
    const long long grid = (n_chunks + SHORT_THREADS - 1) / SHORT_THREADS;
    fnv_short<<<(unsigned)grid, SHORT_THREADS, 0, st>>>(bytes, n, chunk,
                                                        n_chunks, digests);
    return cudaGetLastError();
  }
  if (work == nullptr) return cudaErrorInvalidValue;
  const Split sp = make_split(n, chunk, n_chunks);
  const long long blocks = n_chunks * sp.groups;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const Work wk = carve(sp, work);
  cudaError_t err = cudaFuncSetAttribute(
      fnv_tables, cudaFuncAttributeMaxDynamicSharedMemorySize, TABLE_SMEM);
  if (err != cudaSuccess) return err;
  fnv_tables<<<(unsigned)blocks, TABLE_WARPS * 32, TABLE_SMEM, st>>>(bytes,
                                                                    sp, wk);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  fnv_walk<<<(unsigned)n_chunks, 256, 0, st>>>(sp, wk);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  fnv_partials<<<(unsigned)blocks, GROUP, 0, st>>>(bytes, sp, wk);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  fnv_combine<<<(unsigned)n_chunks, COMBINE_THREADS, 0, st>>>(sp, wk,
                                                              digests);
  return cudaGetLastError();
}

#if FNV_PROBE
// One stage of the split alone (1-4), on a workspace a whole call filled;
// stage 5: the alternative table stage over data's segments into out64
// (n / SEG rounded up, 256 uint64 each).
int fnv1a_stage_probe(int stage, const void* data, long long n,
                      long long chunk, long long n_chunks, void* work,
                      void* out, void* out64, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* bytes = static_cast<const uint8_t*>(data);
  if (stage == 5) {
    const long long segs = (n + SEG - 1) / SEG;
    fnv_tables64<<<(unsigned)segs, 256, 0, st>>>(
        bytes, n, static_cast<unsigned long long*>(out64));
    return cudaGetLastError();
  }
  if (is_short(n, chunk)) return cudaErrorInvalidValue;
  const Split sp = make_split(n, chunk, n_chunks);
  const long long blocks = n_chunks * sp.groups;
  const Work wk = carve(sp, work);
  switch (stage) {
    case 1:
      fnv_tables<<<(unsigned)blocks, TABLE_WARPS * 32, TABLE_SMEM, st>>>(
          bytes, sp, wk);
      break;
    case 2:
      fnv_walk<<<(unsigned)n_chunks, 256, 0, st>>>(sp, wk);
      break;
    case 3:
      fnv_partials<<<(unsigned)blocks, GROUP, 0, st>>>(bytes, sp, wk);
      break;
    case 4:
      fnv_combine<<<(unsigned)n_chunks, COMBINE_THREADS, 0, st>>>(
          sp, wk, static_cast<unsigned long long*>(out));
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
#endif

const char* fnv1a_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
