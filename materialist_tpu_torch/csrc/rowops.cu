// Row gather, out[q, c] = table[idx[q], c], and its adjoint, the row
// scatter-add out[idx[q], c] += cot[q, c].
//
// ---- Row gather (row_gather_launch)
//
// Replaces the Pallas kernel of materialist_tpu/ops/pallas/rowops.py
// (row_gather -> _row_gather_tpu, _gather_kernel). It pulls the state of
// the surviving rays through a wavefront compaction (continuation pack,
// draw streams, throughput chain, film cotangent) and fetches material
// rows at path-hit pixels.
//
// Bound on the H100: device-memory bytes (one index, one table row read
// and one output row written per query; no arithmetic). The TPU kernel
// had no fast gather, so it binned each block of queries by its index
// span and swept one-hot matmul tiles of the table; a GPU thread simply
// loads from the address it computes, so none of that is carried over.
// The output is walked element by element, element i = q*k + c: the k
// threads of a row read k consecutive floats of one table row and the
// stores of a warp are consecutive (fully coalesced), whatever k is. The
// kernel is bound by memory latency, not arithmetic, so each thread takes
// four elements a block's width apart and issues its four index loads and
// then its four row loads before the first store. The element counter is
// 32 bits wide whenever the output has fewer than 2^31 elements, and the
// widths the tracer uses are compiled in, which keeps the division by k
// cheap. The indices of a compaction ascend, so the rows a warp reads are
// near each other and share cache lines and DRAM pages; that only makes
// the reads cheaper, the result does not depend on the order of the
// indices. With bf16 set each value is rounded to bf16 (round to nearest
// even) on the way through.
//
// ---- Row scatter-add (row_scatter_add_launch): the adjoint of the
// gather, for the material-table gradient of bounces >= 1, the
// emitter-table gradient of the sky lookup, and the compaction scatters.
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
constexpr int kUnroll = 4;          // elements per thread of the gather

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

// I: the type of the element counter (unsigned below 2^31 elements).
// K: the row width when it is one the tracer uses (the division is then
// by a constant), 0 for any other width.
template <typename I, int K>
__global__ void gather_kernel(const float* __restrict__ table,
                              const int* __restrict__ idx,
                              float* __restrict__ out, I n, I k_any,
                              int bf16) {
  const I k = K > 0 ? (I)K : k_any;
  // kUnroll elements per thread, a block's width apart (stores stay
  // coalesced); all index loads, then all row loads, are issued before
  // the first store, so each thread keeps several reads in flight
  const I base = (I)blockIdx.x * (blockDim.x * kUnroll) + threadIdx.x;
  const float* src[kUnroll];
#pragma unroll
  for (int j = 0; j < kUnroll; ++j) {
    const I i = base + (I)j * blockDim.x;
    const I q = i < n ? i / k : 0;
    const I c = i < n ? i - q * k : 0;
    src[j] = table + (long long)__ldg(idx + q) * k + c;
  }
  float v[kUnroll];
#pragma unroll
  for (int j = 0; j < kUnroll; ++j) v[j] = __ldg(src[j]);
#pragma unroll
  for (int j = 0; j < kUnroll; ++j) {
    const I i = base + (I)j * blockDim.x;
    if (i < n) out[i] = payload(v[j], bf16);
  }
}

template <int K>
int gather_launch(const float* table, const int* idx, float* out,
                  long long n, int k, int bf16, cudaStream_t stream) {
  const long long per_block = (long long)kThreads * kUnroll;
  const long long grid = (n + per_block - 1) / per_block;
  if (grid > 0x7fffffffll) return (int)cudaErrorInvalidValue;
  if (n < (1ll << 31)) {
    gather_kernel<unsigned, K><<<(unsigned)grid, kThreads, 0, stream>>>(
        table, idx, out, (unsigned)n, (unsigned)k, bf16);
  } else {
    gather_kernel<long long, K><<<(unsigned)grid, kThreads, 0, stream>>>(
        table, idx, out, n, (long long)k, bf16);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int row_gather_launch(const float* table, const int* idx,
                                 float* out, int m, int k, int bf16,
                                 cudaStream_t stream) {
  const long long n = (long long)m * k;
  if (n <= 0) return 0;
  switch (k) {  // the tracer's widths: film/throughput, draws, pack, side
    case 3: return gather_launch<3>(table, idx, out, n, k, bf16, stream);
    case 5: return gather_launch<5>(table, idx, out, n, k, bf16, stream);
    case 6: return gather_launch<6>(table, idx, out, n, k, bf16, stream);
    case 8: return gather_launch<8>(table, idx, out, n, k, bf16, stream);
    case 13: return gather_launch<13>(table, idx, out, n, k, bf16, stream);
    default: return gather_launch<0>(table, idx, out, n, k, bf16, stream);
  }
}

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
