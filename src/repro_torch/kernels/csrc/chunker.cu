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
// here a block stages h() of a 4096-byte tile plus a (k-1)-byte halo in
// shared memory, computing h() once per byte, and each thread walks 16
// consecutive positions: one direct window sum for the first, then the
// O(1) update P_i = rotl(P_{i-1}, 1) ^ h_i ^ rotl(h_{i-k}, k) for the
// rest.  The 16 flags of a thread leave as one 16-byte store, so
// neighbouring threads write neighbouring 16-byte words.  The window never
// resets at tile edges: the halo makes the result a pure function of the
// whole stream.  The update is an identity over any values, so the halo
// words before the stream start only have to be the same in the direct sum
// and in the update, which they are.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRun = 16;                   // positions per thread
constexpr int kTile = kThreads * kRun;     // positions per block
constexpr int kMaxWindow = 128;
constexpr int kStage = kMaxWindow - 1 + kTile;

// one padding word every 32 keeps the stride-16 reads of a warp off
// shared bank conflicts
__host__ __device__ constexpr int pad(int p) { return p + (p >> 5); }

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

__global__ void __launch_bounds__(kThreads)
chunker_kernel(const uint8_t* __restrict__ in, int64_t n,
               uint8_t* __restrict__ out, int window, uint32_t mask,
               uint32_t seed_term) {
  __shared__ uint32_t h[pad(kStage) + 1];
  const int halo = window - 1;
  const int64_t tile0 = static_cast<int64_t>(blockIdx.x) * kTile;

  for (int p = threadIdx.x; p < halo + kTile; p += kThreads) {
    const int64_t g = tile0 - halo + p;
    const uint32_t b = (g >= 0 && g < n) ? in[g] : 0u;
    h[pad(p)] = mix32(b + seed_term);
  }
  __syncthreads();

  const int s = threadIdx.x * kRun;          // first position, tile coords
  const int at = halo + s;                   // its index in h
  uint32_t acc = 0;
  for (int j = 0; j < window; ++j) acc ^= rotl(h[pad(at - j)], j);

  const int64_t g0 = tile0 + s;
  uint32_t words[kRun / 4] = {0u, 0u, 0u, 0u};
  for (int i = 0; i < kRun; ++i) {
    if (i > 0) {
      acc = rotl(acc, 1) ^ h[pad(at + i)] ^ rotl(h[pad(at + i - window)], window);
    }
    const uint32_t hit = ((acc & mask) == 0u) && (g0 + i >= halo);
    words[i >> 2] |= hit << (8 * (i & 3));
  }
  if (g0 + kRun <= n) {
    *reinterpret_cast<uint4*>(out + g0) =
        make_uint4(words[0], words[1], words[2], words[3]);
  } else {
    for (int i = 0; i < kRun && g0 + i < n; ++i) {
      out[g0 + i] = static_cast<uint8_t>(words[i >> 2] >> (8 * (i & 3)));
    }
  }
}

}  // namespace

// in: n bytes on the device; out: n bytes (0/1), 16-byte aligned.
// 1 <= window <= 128 and 0 <= q <= 32 are checked by the Python wrapper.
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
