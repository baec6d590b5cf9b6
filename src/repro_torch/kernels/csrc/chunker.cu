// Rolling-hash boundary bitmap for content-defined chunking, for Hopper
// (sm_90a).  Replaces the Pallas TPU kernel
// repro/kernels/chunker.py::_chunker_kernel (wrapper _run, entry point
// boundary_bitmap_pallas).
//
//   P_i = XOR_{j<k} rotl(h(b_{i-j}), j)      h(b) = mix32(b + seed*GOLD)
//   out[i] = (P_i & mask) == 0  and  i >= k-1
//
// What bounds it on the H100: the bytes.  The function reads n bytes and
// writes n flags, 2n bytes at 3.35 TB/s, against ~15 integer operations a
// byte.  The TPU kernel used a log-depth prefix-XOR over (8, 5120) rows;
// here a block stages h() of an 8192-byte tile and the 128 bytes before it
// in shared memory, computing h() once per byte, and each of its 128
// threads walks 64 consecutive positions: one direct window sum for the
// first, then the O(1) update P_i = rotl(P_{i-1}, 1) ^ h_i ^
// rotl(h_{i-k}, k) for the other 63, so the direct sum is paid once per 64
// bytes.  The window never resets at tile edges: the 128 staged bytes
// before the tile cover any window, so the result is a pure function of
// the whole stream.
//
// Where it can go wrong, and what is done about it:
//  - Unaligned input: the wrapper takes any contiguous uint8 tensor, a
//    view x[5:] included.  The staged region starts 128 bytes before the
//    tile, a multiple of 16 from the stream start, so each 16 stage
//    positions are the bytes a16 .. a16+15 of the two aligned 16-byte
//    granules that hold them (a16 = the stream start's address mod 16),
//    funnel-shifted into place.
//  - Both ends of the stream: a granule pair that is not wholly inside
//    [0, n) is read byte by byte, so nothing outside the stream is read,
//    and positions outside it are staged as the byte 0.  The update is an
//    identity over any values, so the made-up words before the stream
//    start only have to be the same in the direct sum and in the update,
//    which they are; positions < k-1 are cleared after the loop, in the
//    two threads of block 0 whose runs meet them.
//  - Bank conflicts: thread runs are 64 words apart, so one padding word
//    every 64 (pad(p) = p + p/64) puts the 32 reads of a warp at one step
//    on 32 banks.  Within a run the padded index advances by one a step;
//    the read of h_{i-k} crosses one padding word at step c, where the
//    window's start meets a multiple of 64.
//  - Local memory: the 64 flags of a thread are packed into 16 registers
//    with compile-time indices (the update loop is fully unrolled) and
//    leave as four 16-byte stores; -Xptxas -v shows any spill.
// tests/test_torch_chunker_layout.py models this schedule in numpy, so
// change the two together.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRun = 64;                    // positions per thread
constexpr int kTile = kThreads * kRun;      // positions per block
constexpr int kMaxWindow = 128;
constexpr int kPre = kMaxWindow;            // staged bytes before the tile
constexpr int kStage = kPre + kTile;        // a whole number of granules
constexpr int kGranules = kStage / 16;

// one padding word every 64 keeps the stride-64 reads of a warp off shared
// bank conflicts
__host__ __device__ constexpr int pad(int p) { return p + (p >> 6); }

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);          // rotate by r mod 32
}

// Bytes a16 .. a16+15 of the 32 bytes lo|hi (a16 = 1..15, uniform over the
// launch), without indexing registers at run time.
__device__ __forceinline__ uint4 shift_in(uint4 lo, uint4 hi, int a16) {
  const uint32_t v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  const int q = a16 >> 2;
  const int sh = 8 * (a16 & 3);
  uint32_t w[5];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    w[i] = q == 0 ? v[i] : q == 1 ? v[i + 1] : q == 2 ? v[i + 2] : v[i + 3];
  }
  return make_uint4(__funnelshift_r(w[0], w[1], sh),
                    __funnelshift_r(w[1], w[2], sh),
                    __funnelshift_r(w[2], w[3], sh),
                    __funnelshift_r(w[3], w[4], sh));
}

__global__ void __launch_bounds__(kThreads)
chunker_kernel(const uint8_t* __restrict__ in, int64_t n,
               uint8_t* __restrict__ out, int window, uint32_t mask,
               uint32_t seed_term) {
  __shared__ uint32_t h[pad(kStage - 1) + 1];
  const int64_t tile0 = static_cast<int64_t>(blockIdx.x) * kTile;
  const int a16 = static_cast<int>(reinterpret_cast<uintptr_t>(in) & 15);
  const uintptr_t aligned = reinterpret_cast<uintptr_t>(in) - a16;

  // stage position p holds h of stream byte tile0 - kPre + p (byte 0
  // outside [0, n)); granule g is positions 16 g .. 16 g + 15
  for (int g = threadIdx.x; g < kGranules; g += kThreads) {
    const int64_t s0 = tile0 - kPre + 16 * g;          // a multiple of 16
    const int64_t end = a16 ? s0 + 32 - a16 : s0 + 16;  // past what's read
    uint4 raw;
    if (s0 - a16 >= 0 && end <= n) {
      const uint4* src = reinterpret_cast<const uint4*>(aligned + s0);
      raw = __ldg(src);
      if (a16) raw = shift_in(raw, __ldg(src + 1), a16);
    } else {
      uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const int64_t s = s0 + k;
        if (s >= 0 && s < n) w[k >> 2] |= uint32_t{in[s]} << (8 * (k & 3));
      }
      raw = make_uint4(w[0], w[1], w[2], w[3]);
    }
    const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
    uint32_t* dst = h + pad(16 * g);        // 16 | 64: no padding inside
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      dst[k] = mix32(((words[k >> 2] >> (8 * (k & 3))) & 0xFFu) + seed_term);
    }
  }
  __syncthreads();

  const int s = threadIdx.x * kRun;          // first position, tile coords
  const int at = kPre + s;                   // its stage position, 64 | at
  const uint32_t* cur = h + pad(at);         // h_{s+i} is cur[i], i < 64

  // direct sum over stage positions at - j: j = 0 in at's 64-word row,
  // 1..64 one row down, 65..127 two rows down
  uint32_t acc = cur[0];
  const int near = window < 65 ? window : 65;
  for (int j = 1; j < near; ++j) acc ^= rotl(cur[-1 - j], j);
  for (int j = 65; j < window; ++j) acc ^= rotl(cur[-2 - j], j);

  // h_{s+i-k} is old[i] for i < c and old[i + 1] from step c on
  const uint32_t* old = h + pad(at - window);
  const uint32_t* old1 = old + 1;
  const int c = ((window - 1) & 63) + 1;
  uint32_t words[kRun / 4];
  words[0] = (acc & mask) == 0u;
#pragma unroll
  for (int i = 1; i < kRun; ++i) {
    const uint32_t o = (i < c ? old : old1)[i];
    acc = rotl(acc, 1) ^ cur[i] ^ rotl(o, window);
    const uint32_t hit = (acc & mask) == 0u;
    if ((i & 3) == 0) {
      words[i >> 2] = hit;
    } else {
      words[i >> 2] |= hit << (8 * (i & 3));
    }
  }

  // positions < k-1 have no full window: all lie in block 0's first two
  // runs (k <= 128)
  const int64_t g0 = tile0 + s;
  const int halo = window - 1;
  if (g0 < halo) {
#pragma unroll
    for (int i = 0; i < kRun; ++i) {
      if (g0 + i < halo) words[i >> 2] &= ~(0xFFu << (8 * (i & 3)));
    }
  }

  if (g0 + kRun <= n) {
    uint4* dst = reinterpret_cast<uint4*>(out + g0);
#pragma unroll
    for (int m = 0; m < kRun / 16; ++m) {
      dst[m] = make_uint4(words[4 * m], words[4 * m + 1], words[4 * m + 2],
                          words[4 * m + 3]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < kRun; ++i) {
      if (g0 + i < n) {
        out[g0 + i] = static_cast<uint8_t>(words[i >> 2] >> (8 * (i & 3)));
      }
    }
  }
}

}  // namespace

// in: n bytes on the device, any alignment; out: n bytes (0/1), 16-byte
// aligned.  1 <= window <= 128 and 0 <= q <= 32 are checked by the Python
// wrapper.
extern "C" int boundary_bitmap_cuda(const void* in, int64_t n, void* out,
                                    int window, uint32_t mask,
                                    uint32_t seed_term, void* stream) {
  if (n <= 0) return 0;
  const int64_t blocks = (n + kTile - 1) / kTile;
  chunker_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(in), n, static_cast<uint8_t*>(out), window,
      mask, seed_term);
  return static_cast<int>(cudaGetLastError());
}
