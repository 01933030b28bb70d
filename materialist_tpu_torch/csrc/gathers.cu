// Lookups from small 2-D tables at flat indices v*W + u: the min-depth mip
// and the mean-depth fine table of the screen-space march.
//
// onehot_gather_launch replaces the Pallas kernel of
// materialist_tpu/ops/pallas/gather.py (onehot_gather ->
// _onehot_gather_tpu, _kernel): out[q, c] = table[idx[q], c] for an
// (H, W) or (H, W, C) f32 table. The TPU kernel had no fast gather and
// built the lookup from two bf16 one-hot matrix products (a hi/lo split
// of the table for f32 accuracy). On this card a load returns the f32
// value itself, so the kernel is one read-only-cache load per output
// element and the result is exact. A single-channel table (the march's)
// takes the 4-wide kernel below: one thread loads four indices as an int4
// and stores four values as a float4.
//
// vreg_gather_launch replaces the Pallas kernel of
// materialist_tpu/ops/pallas/vreg_gather.py (vreg_gather ->
// _vreg_gather_tpu, _kernel): out[q] = table[idx[q]] for a single-channel
// table of at most 65,536 texels. The TPU kernel composed the lookup from
// in-register lane shuffles over 1024-texel planes. Here a table that fits
// one block's shared memory (227 KB, so up to 58,112 texels: a 128x128
// table does, a 256x256 one does not) is copied there once per block, and
// one block of 1024 threads per SM walks all the queries (every block
// pays for its copy of the table, so there are as few as fill the card);
// a larger table is read through the read-only cache, four queries per
// thread like onehot_gather's.
//
// Bound on the H100 for both: device-memory bytes (4 B of index read and
// 4 B per channel written per query, plus the table once); the table
// reads hit shared memory or L1/L2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVregThreads = 1024;
constexpr int kMaxSmemBytes = 232448;  // 227 KB usable by one block

__global__ void onehot_gather_kernel(const float* __restrict__ table,
                                     const int* __restrict__ idx,
                                     float* __restrict__ out, unsigned n,
                                     unsigned c) {
  const unsigned i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    const unsigned q = i / c;
    out[i] = __ldg(table + (long long)__ldg(idx + q) * c + (i - q * c));
  }
}

// Single-channel lookups through the read-only cache, four per thread;
// the last m % 4 queries go one per thread.
__global__ void lookup4_kernel(const float* __restrict__ table,
                               const int* __restrict__ idx,
                               float* __restrict__ out, int m) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int quads = m >> 2;
  if (t < quads) {
    const int4 q = __ldg(reinterpret_cast<const int4*>(idx) + t);
    float4 v;
    v.x = __ldg(table + q.x);
    v.y = __ldg(table + q.y);
    v.z = __ldg(table + q.z);
    v.w = __ldg(table + q.w);
    reinterpret_cast<float4*>(out)[t] = v;
  } else if (t - quads < (m & 3)) {
    const int j = 4 * quads + (t - quads);
    out[j] = __ldg(table + __ldg(idx + j));
  }
}

__global__ void vreg_gather_smem_kernel(const float* __restrict__ table,
                                        const int* __restrict__ idx,
                                        float* __restrict__ out, int m,
                                        int n_table) {
  extern __shared__ float tab[];
  for (int i = threadIdx.x; i < n_table; i += blockDim.x) tab[i] = table[i];
  __syncthreads();
  for (int q = blockIdx.x * blockDim.x + threadIdx.x; q < m;
       q += gridDim.x * blockDim.x)
    out[q] = tab[idx[q]];
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

int lookup4_launch(const float* table, const int* idx, float* out, int m,
                   cudaStream_t stream) {
  const int threads_needed = (m >> 2) + (m & 3);
  lookup4_kernel<<<(threads_needed + kThreads - 1) / kThreads, kThreads, 0,
                   stream>>>(table, idx, out, m);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int onehot_gather_launch(const float* table, const int* idx,
                                    float* out, int m, int c,
                                    cudaStream_t stream) {
  if (m <= 0) return 0;
  if (c == 1 && aligned16(idx) && aligned16(out))
    return lookup4_launch(table, idx, out, m, stream);
  const long long n = (long long)m * c;
  if (n >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  onehot_gather_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads,
                         0, stream>>>(table, idx, out, (unsigned)n,
                                      (unsigned)c);
  return (int)cudaGetLastError();
}

extern "C" int vreg_gather_launch(const float* table, const int* idx,
                                  float* out, int m, int n_table,
                                  cudaStream_t stream) {
  if (m <= 0) return 0;
  const size_t bytes = sizeof(float) * (size_t)n_table;
  if (bytes > (size_t)kMaxSmemBytes) {
    if (aligned16(idx) && aligned16(out))
      return lookup4_launch(table, idx, out, m, stream);
    onehot_gather_kernel<<<(m + kThreads - 1) / kThreads, kThreads, 0,
                           stream>>>(table, idx, out, (unsigned)m, 1u);
    return (int)cudaGetLastError();
  }
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaError_t e = cudaFuncSetAttribute(
      vreg_gather_smem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (e != cudaSuccess) return (int)e;
  const int need = (m + kVregThreads - 1) / kVregThreads;
  vreg_gather_smem_kernel<<<need < sms ? need : sms, kVregThreads, bytes,
                            stream>>>(table, idx, out, m, n_table);
  return (int)cudaGetLastError();
}
