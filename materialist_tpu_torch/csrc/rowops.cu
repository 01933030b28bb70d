// Row scatter-add: out[idx[q], c] += cot[q, c], the adjoint of a row
// gather, for the material-table gradient of bounces >= 1 and the
// emitter-table gradient of the sky lookup.
//
// Replaces the Pallas kernel of materialist_tpu/ops/pallas/rowops.py
// (row_scatter_add -> _row_scatter_tpu, _scatter_kernel).
//
// Bound on the H100: device-memory bytes (each cotangent row and index
// read once, each output row written once) and, for small tables, the
// serialisation of atomic adds that land on the same address. The TPU
// kernel sorted unstructured indices and swept one-hot matmul tiles; here
// one thread takes one (row, channel) element and adds it with an f32
// atomicAdd, so no sort is needed and the order of the sums is
// nondeterministic. Exact zeros are skipped (the zero-padded channels and
// the gated-off lanes). When the whole table fits in 32 KB of shared
// memory (the emitter: 512 x 3 floats) each block first accumulates into
// a private shared-memory copy and then adds it to the output once, which
// takes the same-address contention off device memory. With bf16 set,
// each contribution is rounded to bf16 (round to nearest even) before it
// is added, as the TPU's bf16 payload path rounds it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSmemFloats = 8192;  // 32 KB private table per block

__device__ __forceinline__ float payload(float x, int bf16) {
  return bf16 ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}

__global__ void scatter_global_kernel(const float* __restrict__ cot,
                                      const int* __restrict__ idx,
                                      float* __restrict__ out, long long n,
                                      int k, int bf16) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const float v = payload(cot[i], bf16);
    if (v != 0.f) {
      const long long q = i / k;
      const int c = (int)(i - q * k);
      atomicAdd(out + (long long)idx[q] * k + c, v);
    }
  }
}

__global__ void scatter_shared_kernel(const float* __restrict__ cot,
                                      const int* __restrict__ idx,
                                      float* __restrict__ out, long long n,
                                      int k, int n_rows, int bf16) {
  __shared__ float acc[kSmemFloats];
  const int table = n_rows * k;
  for (int i = threadIdx.x; i < table; i += blockDim.x) acc[i] = 0.f;
  __syncthreads();
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const float v = payload(cot[i], bf16);
    if (v != 0.f) {
      const long long q = i / k;
      const int c = (int)(i - q * k);
      atomicAdd(acc + idx[q] * k + c, v);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < table; i += blockDim.x)
    if (acc[i] != 0.f) atomicAdd(out + i, acc[i]);
}

}  // namespace

extern "C" int row_scatter_add_launch(const float* cot, const int* idx,
                                      float* out, int m, int k, int n_rows,
                                      int bf16, cudaStream_t stream) {
  cudaMemsetAsync(out, 0, sizeof(float) * (size_t)n_rows * k, stream);
  const long long n = (long long)m * k;
  if (n > 0) {
    long long grid = (n + kThreads - 1) / kThreads;
    if ((long long)n_rows * k <= kSmemFloats) {
      // few blocks, each with many elements: the private-table flush
      // (n_rows*k atomics per block) stays small against the input
      grid = grid > 264 ? 264 : grid;
      scatter_shared_kernel<<<(int)grid, kThreads, 0, stream>>>(
          cot, idx, out, n, k, n_rows, bf16);
    } else {
      grid = grid > 65535 ? 65535 : grid;
      scatter_global_kernel<<<(int)grid, kThreads, 0, stream>>>(
          cot, idx, out, n, k, bf16);
    }
  }
  return (int)cudaGetLastError();
}
