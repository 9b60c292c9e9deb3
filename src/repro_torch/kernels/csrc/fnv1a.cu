// FNV-1a-64 digests of one object's chunks for Hopper (sm_90a): every
// chunk of the object in one launch, one thread a chunk.  For chunk c of
// an object of n bytes cut into chunks of C bytes (the last one shorter):
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
// client.py:210, :218).  A checkpoint of gigabytes takes that loop tens
// of minutes; the port digests on the card.
//
// What bounds it: the chain.  Every byte's step depends on the last, so a
// chunk cannot be split between threads, and the launch takes as long as
// its longest chunk's chain: its bytes times the dependent instructions
// a byte, at one clock at best each.  Bytes are not the bound: a 24 MiB
// chunk is 7.5 us of HBM at 3.35 TB/s and tens of milliseconds of chain.
//
// What the design does about it: h is kept as two 32-bit words, so the
// multiply by P = 2^40 + 0x1B3 splits into a chain of two instructions a
// byte on the low word (the xor, a 32-bit multiply) and one on the high
// word (hi * 0x1B3 plus the low word's carry and its shift by 8, both
// formed off the chain); the lanes of a warp are chunks, so one
// instruction advances up to 32 chains; a thread reads its chunk in
// 16-byte loads, a batch of AHEAD of them in registers while the batch
// before is hashed, so the chain never waits on memory; a chunk's bytes
// before its first 16-byte boundary and after its last whole vector go
// one load each.  Nothing is shared between threads and nothing is
// summed, so the digests are the host loop's bit for bit.
//
// Plain C interface, loaded with ctypes; it returns the cudaError_t of
// the launch and never synchronises.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned long long FNV_OFFSET = 0xCBF29CE484222325ull;
constexpr unsigned P_LO = 0x1B3u;  // P = 2^40 + P_LO
constexpr int AHEAD = 8;     // 16-byte loads a thread keeps in flight
constexpr int THREADS = 64;  // chunks a block

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

__global__ void __launch_bounds__(THREADS)
    fnv1a_chunks(const uint8_t* __restrict__ data, long long n,
                 long long chunk, long long n_chunks,
                 unsigned long long* __restrict__ out) {
  const long long c = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (c >= n_chunks) return;
  const long long begin = c * chunk;
  const long long end = begin + chunk < n ? begin + chunk : n;
  unsigned lo = unsigned(FNV_OFFSET), hi = unsigned(FNV_OFFSET >> 32);
  // the bytes before the first 16-byte boundary
  const uintptr_t base = reinterpret_cast<uintptr_t>(data);
  const long long aligned = (long long)(((base + begin + 15) & ~uintptr_t(15))
                                        - base);
  long long i = begin;
  for (const long long head = aligned < end ? aligned : end; i < head; ++i)
    fnv_byte(lo, hi, data[i]);
  // whole vectors, a batch of AHEAD loaded while the one before is hashed
  // (the last batch loads itself again rather than read past the chunk)
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
  // the bytes after the last whole vector
  for (i += n_vec * 16; i < end; ++i) fnv_byte(lo, hi, data[i]);
  out[c] = (unsigned long long)hi << 32 | lo;
}

}  // namespace

extern "C" {

// data: n bytes on the device (any alignment); out: n_chunks uint64 on
// the device, n_chunks = max(1, ceil(n / chunk)).  Returns a cudaError_t
// (0 = success).
int fnv1a_chunks_launch(const void* data, long long n, long long chunk,
                        long long n_chunks, void* out, void* stream) {
  if (chunk <= 0 || n_chunks <= 0) return cudaErrorInvalidValue;
  const long long grid = (n_chunks + THREADS - 1) / THREADS;
  fnv1a_chunks<<<(unsigned)grid, THREADS, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), n, chunk, n_chunks,
      static_cast<unsigned long long*>(out));
  return cudaGetLastError();
}

const char* fnv1a_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
