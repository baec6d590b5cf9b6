// fphash, the 256-bit sponge content hash of the dedup path, for Hopper
// (sm_90a).  Replaces the Pallas TPU kernels
// repro/kernels/fphash.py::_fphash_many_kernel (wrapper _run_many, entry
// point fphash_many) and ::_fphash_kernel (wrapper _run, entry point
// fphash); both entry points run one device routine, one warp per chunk.
//
// State: 8 x 128 u32 words, initialised to mix32(iota + GOLD).  Each chunk
// is zero-padded to 4 KB blocks (at least one); a block is XORed in and
// followed by 4 rounds
//   s *= GOLD; s ^= rotr(s, 13); s += roll(s, 1, lanes);
//   s ^= rotr(s, 7); s += roll(s, 1, sublanes)
// then the length (mod 2^32) is XORed in, 2 more rounds run, the 128 lanes
// of each row are XOR-folded and word r becomes mix32(w_r ^ r*GOLD).
//
// What bounds it on the H100: operations, not bytes.  A block costs about
// 29 integer operations per state word against 4 bytes read.  The first
// design (one block of 1024 threads per chunk, a state word per thread,
// the rolls exchanged through shared memory) was bound by latency and ran
// 11x its byte bound: only two 1024-thread chunks fit on an SM, every
// round waited at two block barriers, and each block's byte loads were
// issued only after the previous block's rounds, with nothing in flight
// to hide them.  This design keeps enough chunks in flight that the
// integer pipes set the pace.
//
// Design: one warp per chunk, no block barriers, many chunks per SM.
//  - Lane l holds state word (r, c = l + 32 j) in register s[r][j]
//    (r < 8, j < 4): its byte offset in a block is 512 r + 128 j + 4 l, so
//    each (r, j) is one 128-byte row of the warp, read from shared memory
//    without bank conflicts.
//  - Row roll: a renaming of registers (s[r] += old s[r-1]).
//  - Lane roll: per (r, j), u_j = shuffle of s[r][j] from lane l-1; lane 0
//    takes u_{j-1}, which is lane 31's word (r, 32 j - 1).  32 shuffles a
//    round, no barrier.
//  - Absorb: the warp stages 4 KB blocks through two buffers of its own in
//    shared memory with 16-byte cp.async, block b+1's copy in flight while
//    block b's rounds run; only __syncwarp orders the lanes.
//  - Finalize: XOR the 4 registers of each row, then XOR-reduce across the
//    warp by shuffles; lanes 0..7 write the 8 digest words.
//  - A block of 4 warps (4 chunks) uses 32.9 KB of shared memory, so some
//    24 chunks are in flight per SM, against 2 in the first design.
// One launch takes a ragged batch: chunk i is lengths[i] bytes at
// offsets[i] of one concatenated buffer.
//
// Where it can go wrong, and what is done about it:
//  - Unaligned chunks: offsets are arbitrary.  The stage starts at the
//    chunk's first byte rounded down to 16 (the granule that holds that
//    byte, never past the buffer and never across an allocation, which is
//    at least 256-byte aligned); word k is __funnelshift_r of the two
//    aligned stage words that hold it, at the chunk's misalignment mod 16.
//  - Tail and empty chunks: each granule's copy reads only the bytes
//    before the chunk's end (cp.async's src-size) and zero-fills the rest,
//    so bytes at or past the length read as zero and nothing past the
//    chunk is read.  An empty chunk absorbs one zero block.
//  - Local memory: s is indexed only with compile-time indices (fully
//    unrolled loops), so it stays in registers; -Xptxas -v shows the
//    spills.
//  - Roll order: both rolls read the values from before the update
//    (np.roll semantics): the lane roll adds shuffled copies, the row roll
//    adds from a copy of the whole state.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;                   // chunks per block of the batch
constexpr int kBlockBytes = 4096;           // absorb block
constexpr int kGranules = kBlockBytes / 16 + 1;  // + the misaligned tail's
constexpr int kRounds = 4;
constexpr uint32_t kGold = 0x9E3779B9u;
constexpr unsigned kFull = 0xFFFFFFFFu;

using Stage = uint4[2][kGranules];          // one warp's double buffer

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

// 16-byte asynchronous copy that reads the first n bytes (0..16) of src
// and zero-fills the rest of dst.
__device__ __forceinline__ void cp_async16(void* dst, uintptr_t src, int n) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(n) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Stage block b: granule g holds the bytes base + 4096 b + 16 g ..., where
// base is the chunk's start rounded down to 16 and end is the chunk's end
// in bytes from base.
__device__ __forceinline__ void stage_block(uint4* buf, uintptr_t base,
                                            int64_t end, int64_t b,
                                            int lane) {
#pragma unroll
  for (int i = 0; i <= kGranules / 32; ++i) {
    const int g = 32 * i + lane;
    if (g < kGranules) {
      const int64_t at = b * kBlockBytes + 16 * g;
      const int64_t left = end - at;
      const int n = left <= 0 ? 0 : left >= 16 ? 16 : static_cast<int>(left);
      cp_async16(buf + g, base + (n ? at : 0), n);
    }
  }
}

// XOR the staged block into the state: word k = 128 r + 32 j + lane of the
// block starts at byte a16 + 4 k of the stage.
__device__ __forceinline__ void absorb(uint32_t (&s)[8][4], const uint4* buf,
                                       int a16, int lane) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(buf) + (a16 >> 2);
  const int sh = 8 * (a16 & 3);
#pragma unroll
  for (int r = 0; r < 8; ++r) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = 128 * r + 32 * j + lane;
      s[r][j] ^= __funnelshift_r(w[k], w[k + 1], sh);
    }
  }
}

__device__ __forceinline__ void fp_round(uint32_t (&s)[8][4], int lane) {
  const int from = (lane + 31) & 31;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t x = s[r][j] * kGold;
      s[r][j] = x ^ rotr(x, 13);
    }
    uint32_t u[4];                          // word (r, c - 1) of each c
#pragma unroll
    for (int j = 0; j < 4; ++j) u[j] = __shfl_sync(kFull, s[r][j], from);
#pragma unroll
    for (int j = 0; j < 4; ++j) s[r][j] += lane == 0 ? u[(j + 3) & 3] : u[j];
  }
  uint32_t t[8][4];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
#pragma unroll
    for (int j = 0; j < 4; ++j) t[r][j] = s[r][j] ^ rotr(s[r][j], 7);
  }
#pragma unroll
  for (int r = 0; r < 8; ++r) {
#pragma unroll
    for (int j = 0; j < 4; ++j) s[r][j] = t[r][j] + t[(r + 7) & 7][j];
  }
}

// One chunk of len bytes at src, hashed by the calling warp into out8.
__device__ void hash_chunk(const uint8_t* src, int64_t len,
                           uint32_t* __restrict__ out8, Stage& stage,
                           int lane) {
  const uintptr_t start = reinterpret_cast<uintptr_t>(src);
  const uintptr_t base = start & ~static_cast<uintptr_t>(15);
  const int a16 = static_cast<int>(start - base);
  const int64_t end = a16 + len;
  const int64_t nb = len > 0 ? (len + kBlockBytes - 1) / kBlockBytes : 1;

  uint32_t s[8][4];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s[r][j] = mix32(static_cast<uint32_t>(128 * r + 32 * j + lane) + kGold);
    }
  }

  stage_block(stage[0], base, end, 0, lane);
  cp_async_commit();
  for (int64_t b = 0; b < nb; ++b) {
    if (b + 1 < nb) stage_block(stage[(b + 1) & 1], base, end, b + 1, lane);
    cp_async_commit();                      // (empty after the last block)
    cp_async_wait_prior();                  // this lane's copies of block b
    __syncwarp();                           // ... and every other lane's
    absorb(s, stage[b & 1], a16, lane);
    __syncwarp();                           // read before it is restaged
#pragma unroll 1
    for (int i = 0; i < kRounds; ++i) fp_round(s, lane);
  }

  const uint32_t n32 = static_cast<uint32_t>(len);
#pragma unroll
  for (int r = 0; r < 8; ++r) {
#pragma unroll
    for (int j = 0; j < 4; ++j) s[r][j] ^= n32;
  }
#pragma unroll 1
  for (int i = 0; i < 2; ++i) fp_round(s, lane);

  uint32_t f[8];                            // row r's XOR over all 128 lanes
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    f[r] = s[r][0] ^ s[r][1] ^ s[r][2] ^ s[r][3];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      f[r] ^= __shfl_xor_sync(kFull, f[r], off);
    }
  }
  uint32_t w = f[0];
#pragma unroll
  for (int r = 1; r < 8; ++r) w = lane == r ? f[r] : w;
  if (lane < 8) out8[lane] = mix32(w ^ (static_cast<uint32_t>(lane) * kGold));
}

__global__ void __launch_bounds__(kWarps * 32)
fphash_many_kernel(const uint8_t* __restrict__ data,
                   const int64_t* __restrict__ offsets,
                   const int64_t* __restrict__ lengths, int64_t n,
                   uint32_t* __restrict__ out) {
  __shared__ Stage stage[kWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  if (i >= n) return;
  hash_chunk(data + offsets[i], lengths[i], out + 8 * i, stage[warp], lane);
}

__global__ void __launch_bounds__(32)
fphash_one_kernel(const uint8_t* __restrict__ data, int64_t len,
                  uint32_t* __restrict__ out) {
  __shared__ Stage stage;
  hash_chunk(data, len, out, stage, threadIdx.x);
}

}  // namespace

// Ragged batch: chunk i is lengths[i] bytes at data + offsets[i]; out holds
// n x 8 u32.  offsets and lengths are int64 on the device.
extern "C" int fphash_many_cuda(const void* data, const void* offsets,
                                const void* lengths, int64_t n, void* out,
                                void* stream) {
  if (n <= 0) return 0;
  const int64_t grid = (n + kWarps - 1) / kWarps;
  fphash_many_kernel<<<static_cast<unsigned>(grid), kWarps * 32, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data),
      static_cast<const int64_t*>(offsets),
      static_cast<const int64_t*>(lengths), n, static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// One byte string of len bytes; out holds 8 u32.  One warp.
extern "C" int fphash_one_cuda(const void* data, int64_t len, void* out,
                               void* stream) {
  fphash_one_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), len, static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
