// The estimator's random draws: Threefry-2x32 (20 rounds) of each
// element's count, bit for bit the int64 emulation in
// materialist_tpu_torch/rng.py (threefry2x32, bits), which is jax.random's
// partitionable threefry.
//
// threefry_launch replaces no Pallas kernel: the JAX package draws through
// XLA's threefry, which XLA fuses into the loop that consumes it. The
// port's emulation in PyTorch issued some 178 launches a stream of uint32
// arithmetic held in int64, and each lattice stream first copied its
// generators from a host list to the card, a synchronisation a stream. It
// took the largest stage of the 1024² inverse step and most launches of
// the 512² relight pass. Here the hash, the float conversion and the
// lattice rotation are one launch a stream; the key's two words and the
// lattice generators are scalar arguments, so nothing is copied and
// nothing waits.
//
// Element p of a draw has the 64-bit count c = p: hi word c >> 32, lo word
// c & 0xFFFFFFFF; its bits are x ^ y of the hash. Three outputs:
//  mode 0: the bits as int64 (rng.bits, on which randint builds);
//  mode 1: the float32 uniform in [0, 1): the 23 high bits as the mantissa
//          of a float in [1, 2), minus 1, then max(., 0) (rng.uniform);
//  mode 2: the rotated rank-1 lattice (s, n_loc, dims), dims 1 or 2
//          (rng.lattice): element p = pixel * dims + d is hashed once to
//          its uniform u, and sample t is fmod(t * g[d] + u, 1), one
//          rounding for the product and one for the sum (as PyTorch's
//          t * g + u, then torch.fmod; -fmad=false, and the _rn
//          intrinsics say so here too).
//
// Bound on the H100: device-memory writes, 8 B (mode 0) or 4 B a value
// and, in mode 2, s values a hash. The hash is some 73 integer operations
// in registers (rotations are one funnel shift each). One thread hashes one
// element and writes its s samples; a warp's 32 neighbouring elements make
// each of its stores one coalesced stream per sample. A grid of a few
// blocks per SM walks the elements.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kMaxBlocks = 132 * 16;

__device__ __forceinline__ uint32_t threefry_bits(uint32_t k1, uint32_t k2,
                                                  uint64_t c) {
  constexpr int kRot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  const uint32_t ks[3] = {k1, k2, k1 ^ k2 ^ 0x1BD11BDAu};
  uint32_t x = (uint32_t)(c >> 32) + ks[0];
  uint32_t y = (uint32_t)c + ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x += y;
      y = __funnelshift_l(y, y, kRot[i & 1][j]) ^ x;
    }
    x += ks[(i + 1) % 3];
    y += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
  return x ^ y;
}

__device__ __forceinline__ float to_uniform(uint32_t b) {
  return fmaxf(__fsub_rn(__uint_as_float((b >> 9) | 0x3F800000u), 1.0f),
               0.0f);
}

__device__ __forceinline__ uint64_t first_index() {
  return (uint64_t)blockIdx.x * blockDim.x + threadIdx.x;
}

__device__ __forceinline__ uint64_t stride() {
  return (uint64_t)gridDim.x * blockDim.x;
}

__global__ void threefry_bits_kernel(int64_t* __restrict__ out, uint64_t n,
                                     uint32_t k1, uint32_t k2) {
  for (uint64_t p = first_index(); p < n; p += stride())
    out[p] = (int64_t)threefry_bits(k1, k2, p);
}

__global__ void threefry_uniform_kernel(float* __restrict__ out, uint64_t n,
                                        uint32_t k1, uint32_t k2) {
  for (uint64_t p = first_index(); p < n; p += stride())
    out[p] = to_uniform(threefry_bits(k1, k2, p));
}

// n = n_loc * dims hashed elements; out is (s, n)
__global__ void threefry_lattice_kernel(float* __restrict__ out, uint64_t n,
                                        int s, int dims, uint32_t k1,
                                        uint32_t k2, float g0, float g1) {
  for (uint64_t p = first_index(); p < n; p += stride()) {
    const float u = to_uniform(threefry_bits(k1, k2, p));
    const float g = (dims == 2 && (p & 1)) ? g1 : g0;
    float* o = out + p;
    for (int t = 0; t < s; ++t, o += n)
      *o = fmodf(__fadd_rn(__fmul_rn((float)t, g), u), 1.0f);
  }
}

}  // namespace

// out: int64 (mode 0) or float32 (modes 1, 2) of n values (mode 2: s * n);
// k1, k2: the key's words; g0, g1: mode 2's generators (dims 1 or 2)
extern "C" int threefry_launch(void* out, int mode, long long n, int s,
                               int dims, unsigned k1, unsigned k2, float g0,
                               float g1, cudaStream_t stream) {
  if (n <= 0) return 0;
  if (mode < 0 || mode > 2 || (mode == 2 && (s < 1 || dims < 1 || dims > 2)))
    return (int)cudaErrorInvalidValue;
  const unsigned long long need = (n + kThreads - 1) / kThreads;
  const unsigned blocks = need < kMaxBlocks ? (unsigned)need : kMaxBlocks;
  const uint64_t m = (uint64_t)n;
  if (mode == 0)
    threefry_bits_kernel<<<blocks, kThreads, 0, stream>>>(
        static_cast<int64_t*>(out), m, k1, k2);
  else if (mode == 1)
    threefry_uniform_kernel<<<blocks, kThreads, 0, stream>>>(
        static_cast<float*>(out), m, k1, k2);
  else
    threefry_lattice_kernel<<<blocks, kThreads, 0, stream>>>(
        static_cast<float*>(out), m, s, dims, k1, k2, g0, g1);
  return (int)cudaGetLastError();
}
