// fphash, the 256-bit sponge content hash of the dedup path, for Hopper
// (sm_90a).  Replaces the Pallas TPU kernels
// repro/kernels/fphash.py::_fphash_many_kernel (wrapper _run_many, entry
// point fphash_many) and ::_fphash_kernel (wrapper _run, entry point
// fphash); both entry points here share one device routine.
//
// State: 8 x 128 u32 words, initialised to mix32(iota + GOLD).  Each chunk
// is zero-padded to 4 KB blocks (at least one); a block is XORed in and
// followed by 4 rounds
//   s *= GOLD; s ^= rotr(s, 13); s += roll(s, 1, lanes);
//   s ^= rotr(s, 7); s += roll(s, 1, sublanes)
// then the length (mod 2^32) is XORed in, 2 more rounds run, the 128 lanes
// of each row are XOR-folded and word r becomes mix32(w_r ^ r*GOLD).
//
// What bounds it on the H100: about 7 integer operations per input byte
// against one byte read, so the integer pipes and the block barriers, not
// memory, set its pace at real chunk sizes.  Design: one block of 1024
// threads per chunk, one state word per thread, so the state never leaves
// registers; the two rolls of a round go through two shared buffers used in
// turn, one barrier each.  The lane fold uses warp shuffles.  The TPU
// version bucketed chunks by power-of-two block count and padded each
// batch to a power of two; here one launch takes a ragged batch: chunk i
// is lengths[i] bytes at offsets[i] of one concatenated buffer, and bytes
// past its end read as zero.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;              // one per state word
constexpr int kBlockBytes = 4096;           // absorb block
constexpr int kRounds = 4;
constexpr uint32_t kGold = 0x9E3779B9u;

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t rotr(uint32_t x, int r) {
  return __funnelshift_r(x, x, r);
}

// Word (r, c) of the (8, 128) state is held by thread r * 128 + c.  A
// buffer is rewritten only after the barrier that follows the other
// buffer's write, which every thread reaches after its read of this one.
__device__ __forceinline__ uint32_t fp_round(uint32_t s, uint32_t* lanes,
                                             uint32_t* rows, int r, int c) {
  s *= kGold;
  s ^= rotr(s, 13);
  lanes[r * 128 + c] = s;
  __syncthreads();
  s += lanes[r * 128 + ((c + 127) & 127)];  // roll by 1 along the lanes
  s ^= rotr(s, 7);
  rows[r * 128 + c] = s;
  __syncthreads();
  s += rows[((r + 7) & 7) * 128 + c];       // roll by 1 along the rows
  return s;
}

__device__ void hash_chunk(const uint8_t* __restrict__ src, int64_t len,
                           uint32_t* __restrict__ out8) {
  __shared__ uint32_t lanes[kThreads];
  __shared__ uint32_t rows[kThreads];
  __shared__ uint32_t part[kThreads / 32];
  const int t = threadIdx.x;
  const int r = t >> 7, c = t & 127;
  const int64_t nb = len > 0 ? (len + kBlockBytes - 1) / kBlockBytes : 1;

  uint32_t s = mix32(static_cast<uint32_t>(t) + kGold);
  for (int64_t b = 0; b < nb; ++b) {
    const int64_t o = b * kBlockBytes + 4 * t;   // little-endian word t
    uint32_t w = 0;
    if (o + 4 <= len) {
      w = src[o] | (src[o + 1] << 8) | (src[o + 2] << 16) |
          (static_cast<uint32_t>(src[o + 3]) << 24);
    } else {
      for (int k = 0; k < 4 && o + k < len; ++k) {
        w |= static_cast<uint32_t>(src[o + k]) << (8 * k);
      }
    }
    s ^= w;
#pragma unroll
    for (int i = 0; i < kRounds; ++i) s = fp_round(s, lanes, rows, r, c);
  }
  s ^= static_cast<uint32_t>(len);
  s = fp_round(s, lanes, rows, r, c);
  s = fp_round(s, lanes, rows, r, c);

  // XOR-fold the 128 lanes of each row: 32 in a warp, then 4 warps a row
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s ^= __shfl_xor_sync(0xFFFFFFFFu, s, off);
  if ((t & 31) == 0) part[t >> 5] = s;
  __syncthreads();
  if (t < 8) {
    const uint32_t w = part[4 * t] ^ part[4 * t + 1] ^ part[4 * t + 2] ^
                       part[4 * t + 3];
    out8[t] = mix32(w ^ (static_cast<uint32_t>(t) * kGold));
  }
}

__global__ void __launch_bounds__(kThreads)
fphash_many_kernel(const uint8_t* __restrict__ data,
                   const int64_t* __restrict__ offsets,
                   const int64_t* __restrict__ lengths,
                   uint32_t* __restrict__ out) {
  const int64_t i = blockIdx.x;
  hash_chunk(data + offsets[i], lengths[i], out + 8 * i);
}

__global__ void __launch_bounds__(kThreads)
fphash_one_kernel(const uint8_t* __restrict__ data, int64_t len,
                  uint32_t* __restrict__ out) {
  hash_chunk(data, len, out);
}

}  // namespace

// Ragged batch: chunk i is lengths[i] bytes at data + offsets[i]; out holds
// n x 8 u32.  offsets and lengths are int64 on the device.
extern "C" int fphash_many_cuda(const void* data, const void* offsets,
                                const void* lengths, int64_t n, void* out,
                                void* stream) {
  if (n <= 0) return 0;
  fphash_many_kernel<<<static_cast<unsigned>(n), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data),
      static_cast<const int64_t*>(offsets),
      static_cast<const int64_t*>(lengths), static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// One byte string of len bytes; out holds 8 u32.
extern "C" int fphash_one_cuda(const void* data, int64_t len, void* out,
                               void* stream) {
  fphash_one_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), len, static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
