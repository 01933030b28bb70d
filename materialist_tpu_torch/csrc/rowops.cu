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
// Bound on the H100: device-memory bytes, counted in the 32-byte sectors
// the card reads (each distinct sector of the table that a fetched row
// touches, once; one index and one output row a query; no arithmetic).
// The TPU kernel had no fast gather, so it binned each block of queries
// by its index span and swept one-hot matmul tiles of the table; a GPU
// thread simply loads from the address it computes, so none of that is
// carried over. A gather is bound by memory latency and by the requests
// its loads make, so the design keeps every request whole:
//  - a row's index is loaded once, by one lane (a warp's 32 indices are
//    one 128-byte load), and handed to the lanes that move the row's
//    pieces by a shuffle;
//  - the row moves in the widest pieces its width and the table's
//    alignment allow: float4 for K = 8, 20, float2 for K = 6, else
//    floats; a view whose base is not aligned takes the float route;
//  - the lanes of a warp move consecutive pieces of the output, so every
//    store instruction writes 32 consecutive pieces and a load
//    instruction reads neighbouring bytes of a few rows;
//  - rows go through L1 (ld.global.nc), where neighbouring queries, the
//    padding rows of a compaction (all at index 0) and a row split over
//    two rounds share sectors. Reads past L1 (L1::no_allocate) measured
//    faster on seeded ascending indices from tables larger than L2, but
//    slower on the bench's own compactions, whose padding repeats row 0;
//  - a warp issues all row loads of its group of 32 rows before its first
//    store, with registers capped so that an SM holds 64 warps (32 for
//    rows wider than 8 floats), one group a warp. Holding 2 to 8 groups a
//    warp, whole rows a round, a persistent grid, or each lane loading
//    its row's index itself measured no faster at 1M queries.
// The widths the tracer uses are compiled in; any other width moves
// floats at a run-time width. Output offsets are 32 bits wide below 2^31
// elements. With bf16 set each value is rounded to bf16 (round to
// nearest even) on the way through.
//
// ---- Row scatter-add (row_scatter_add_launch): the adjoint of the
// gather, for the material-table gradient of bounces >= 1, the
// emitter-table gradient of the sky lookup, and the scatters of a
// wavefront compaction (film accumulation, throughput adjoint).
//
// Replaces the Pallas kernel of materialist_tpu/ops/pallas/rowops.py
// (row_scatter_add -> _row_scatter_tpu, _scatter_kernel).
//
// Bound on the H100: device-memory bytes (each cotangent row and index
// read once, each touched output row written once) and, where many rows
// carry one index, the serialisation of atomic adds on one address. The
// TPU kernel sorted unstructured indices and swept one-hot matmul tiles;
// none of that is carried over. Here a lane owns a row: one index load,
// the row read with the widest loads its width allows (K = 8: two float4),
// one zero test for the row (all-zero rows, the gated-off lanes and the
// padding of a compaction, are skipped). Its three families of callers get
// three treatments:
//  - unordered rows into a large table (material adjoint): the lanes of a
//    warp that hold the same index find each other with __match_any_sync
//    and fold their rows by a shuffle tree, so each distinct row of a warp
//    costs one atomic, K = 8 as two float4 atomics;
//  - coherent rows (the caller says its live indices ascend: the
//    compaction scatters): equal indices can only sit in neighbouring live
//    lanes, so a lane whose two live neighbours in the warp hold other
//    indices owns its output row alone and adds with a plain load and
//    store; the lanes at a warp's edge and the lanes of a run use atomics.
//    With `accumulate` the sums go into the caller's running table and
//    nothing is zeroed;
//  - tables of at most 32 KB (the emitter: 512 x 3 floats): the same fold,
//    then shared-memory atomics into the block's private table, which is
//    added to the output once.
// The order of the sums is nondeterministic. With bf16 set, each
// contribution is rounded to bf16 (round to nearest even) before it is
// added, as the TPU's bf16 payload path rounds it.
//
// ---- Compaction index (compact_sel_launch): flags (M,) -> the ascending
// positions of the first `cap` set flags, zero beyond their count, and
// the count. The JAX package builds it from a cumsum and a coherent
// scatter of f32-split positions (rowops.py compact_sel); here it is a
// count pass (each block of 4096 flags counts its set flags, 16 flags a
// thread as one 16-byte load) and a write pass (each block sums the counts
// of the blocks before it, scans its threads' counts through warp
// shuffles, and writes its positions as integers; the blocks share the
// zero fill of sel beyond the count). No atomics: the result is
// deterministic. Bound: 1 byte a flag in, 4 bytes a slot out, so it is
// limited by its two launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr size_t kSmemBytes = 32768;  // largest private table of a block

__device__ __forceinline__ float payload(float x, int bf16) {
  return bf16 ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}

// Folds the rows of the lanes named in `peers` (the lanes of the warp
// that hold this lane's index; 0 for a lane that takes no part) into the
// lowest of them, by a tree over their ranks: in each round a lane adds
// the row of the next peer above it, and the odd-ranked lanes, whose rows
// have then been taken, leave. Every lane of the warp calls it.
template <int W>
__device__ __forceinline__ void fold_peers(unsigned peers, float (&v)[W],
                                           int lane) {
  unsigned above = peers & (0xfffffffeu << lane);
  unsigned rank = __popc(peers & ((1u << lane) - 1u));
  while (__any_sync(0xffffffffu, above != 0u)) {
    const int next = __ffs(above);  // 1-based; 0: no peer above
#pragma unroll
    for (int c = 0; c < W; ++c) {
      const float up = __shfl_sync(0xffffffffu, v[c], (next - 1) & 31);
      if (next) v[c] += up;
    }
    above &= __ballot_sync(0xffffffffu, (rank & 1u) == 0u);
    rank >>= 1;
  }
}

enum { kUnordered = 0, kCoherent = 1, kSmallTable = 2 };

// K: the row width when it is compiled in (2, 3, 8), 0 for any other
// width, which goes channel by channel. A lane owns row q0 + lane.
template <int K, int MODE>
__global__ void scatter_rows_kernel(const float* __restrict__ cot,
                                    const int* __restrict__ idx,
                                    float* __restrict__ out, int m, int k_any,
                                    int n_rows, int bf16) {
  constexpr int W = K > 0 ? K : 1;
  const int k = K > 0 ? K : k_any;
  extern __shared__ __align__(16) float acc[];  // kSmallTable only
  float* dst_base = out;
  if (MODE == kSmallTable) {
    for (int i = threadIdx.x; i < n_rows * k; i += blockDim.x) acc[i] = 0.f;
    __syncthreads();
    dst_base = acc;
  }
  const int lane = threadIdx.x & 31;
  const int stride = gridDim.x * blockDim.x;
  for (int q0 = blockIdx.x * blockDim.x + (threadIdx.x & ~31); q0 < m;
       q0 += stride) {
    const int q = q0 + lane;
    const bool in = q < m;
    const int ix = in ? idx[q] : -1;
    for (int c0 = 0; c0 < k; c0 += W) {
      float v[W];
      if (!in) {
#pragma unroll
        for (int c = 0; c < W; ++c) v[c] = 0.f;
      } else if (K == 8) {
        const float4* p = reinterpret_cast<const float4*>(cot) + 2 * (size_t)q;
        const float4 a = __ldg(p), b = __ldg(p + 1);
        v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
        v[4 % W] = b.x, v[5 % W] = b.y, v[6 % W] = b.z, v[7 % W] = b.w;
      } else if (K == 2) {
        const float2 a = __ldg(reinterpret_cast<const float2*>(cot) + q);
        v[0] = a.x, v[1 % W] = a.y;
      } else {
#pragma unroll
        for (int c = 0; c < W; ++c) v[c] = __ldg(cot + (size_t)q * k + c0 + c);
      }
      bool live = false;
#pragma unroll
      for (int c = 0; c < W; ++c) {
        v[c] = payload(v[c], bf16);
        live = live || (v[c] != 0.f);
      }
      float* dst = dst_base + (size_t)(in ? ix : 0) * k + c0;
      const unsigned alive = __ballot_sync(0xffffffffu, live);
      if (MODE == kCoherent) {
        // the live indices ascend, so equal ones sit in neighbouring live
        // lanes: a lane that sees both neighbours and shares with neither
        // is the only writer of its row in the whole launch
        const unsigned below = alive & ((1u << lane) - 1u);
        const unsigned over = alive & ~((2u << lane) - 1u);
        const int prev = below ? 31 - __clz(below) : lane;
        const int next = over ? __ffs(over) - 1 : lane;
        const int ix_prev = __shfl_sync(0xffffffffu, ix, prev);
        const int ix_next = __shfl_sync(0xffffffffu, ix, next);
        const bool alone = below && over && ix_prev != ix && ix_next != ix;
        if (live && alone) {
          if (K == 8) {
            float4* d4 = reinterpret_cast<float4*>(dst);
            float4 a = d4[0], b = d4[1];
            a.x += v[0], a.y += v[1], a.z += v[2], a.w += v[3];
            b.x += v[4 % W], b.y += v[5 % W], b.z += v[6 % W],
                b.w += v[7 % W];
            d4[0] = a, d4[1] = b;
          } else {
#pragma unroll
            for (int c = 0; c < W; ++c) dst[c] += v[c];
          }
          live = false;  // done; the others go on to the atomics
        }
      } else {
        const unsigned peers = live ? __match_any_sync(alive, ix) : 0u;
        fold_peers<W>(peers, v, lane);
        live = live && lane == __ffs(peers) - 1;
      }
      if (live) {
        if (K == 8 && MODE != kSmallTable) {
          float4* d4 = reinterpret_cast<float4*>(dst);
          atomicAdd(d4, make_float4(v[0], v[1], v[2], v[3]));
          atomicAdd(d4 + 1,
                    make_float4(v[4 % W], v[5 % W], v[6 % W], v[7 % W]));
        } else {
#pragma unroll
          for (int c = 0; c < W; ++c)
            if (v[c] != 0.f) atomicAdd(dst + c, v[c]);
        }
      }
    }
  }
  if (MODE == kSmallTable) {
    __syncthreads();
    for (int i = threadIdx.x; i < n_rows * k; i += blockDim.x)
      if (acc[i] != 0.f) atomicAdd(out + i, acc[i]);
  }
}

template <int K>
void scatter_launch(const float* cot, const int* idx, float* out, int m, int k,
                    int n_rows, int bf16, int coherent, cudaStream_t stream) {
  const size_t table = sizeof(float) * (size_t)n_rows * k;
  if (table <= kSmemBytes && !coherent) {
    // 512 threads and two blocks an SM: few private tables to add up
    int grid = (m + 511) / 512;
    grid = grid > 264 ? 264 : grid;
    scatter_rows_kernel<K, kSmallTable><<<grid, 512, table, stream>>>(
        cot, idx, out, m, k, n_rows, bf16);
    return;
  }
  int grid = (m + kThreads - 1) / kThreads;
  grid = grid > 8192 ? 8192 : grid;
  if (coherent)
    scatter_rows_kernel<K, kCoherent><<<grid, kThreads, 0, stream>>>(
        cot, idx, out, m, k, n_rows, bf16);
  else
    scatter_rows_kernel<K, kUnordered><<<grid, kThreads, 0, stream>>>(
        cot, idx, out, m, k, n_rows, bf16);
}

// ---- compaction index

constexpr int kSelPer = 16;                      // flags a thread takes
constexpr int kSelTile = kThreads * kSelPer;     // flags a block takes

// 4-bit mask of the nonzero bytes of a word
__device__ __forceinline__ unsigned nonzero_bytes(unsigned w) {
  const unsigned t = (((w & 0x7f7f7f7fu) + 0x7f7f7f7fu) | w) & 0x80808080u;
  return ((t >> 7) & 1u) | ((t >> 14) & 2u) | ((t >> 21) & 4u) |
         ((t >> 28) & 8u);
}

// 16-bit mask of the set flags among flags[base .. base + 16)
__device__ __forceinline__ unsigned flags16(const uint8_t* __restrict__ flags,
                                            int base, int m, bool vec) {
  if (vec && base + kSelPer <= m) {
    const uint4 w = __ldg(reinterpret_cast<const uint4*>(flags + base));
    return nonzero_bytes(w.x) | (nonzero_bytes(w.y) << 4) |
           (nonzero_bytes(w.z) << 8) | (nonzero_bytes(w.w) << 12);
  }
  unsigned mask = 0;
  for (int j = 0; j < kSelPer; ++j)
    if (base + j < m && flags[base + j]) mask |= 1u << j;
  return mask;
}

// Sum of v over the block (kThreads threads); sh: kThreads / 32 ints.
__device__ __forceinline__ int block_sum(int v, int* sh) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = v;
  __syncthreads();
  int total = 0;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) total += sh[w];
  __syncthreads();
  return total;
}

__global__ void compact_count_kernel(const uint8_t* __restrict__ flags,
                                     int* __restrict__ counts, int m,
                                     int vec) {
  __shared__ int sh[kThreads / 32];
  const int base = blockIdx.x * kSelTile + threadIdx.x * kSelPer;
  const int total = block_sum(__popc(flags16(flags, base, m, vec)), sh);
  if (threadIdx.x == 0) counts[blockIdx.x] = total;
}

__global__ void compact_write_kernel(const uint8_t* __restrict__ flags,
                                     const int* __restrict__ counts,
                                     int* __restrict__ sel,
                                     int* __restrict__ count_out, int m,
                                     int cap, int vec) {
  __shared__ int sh[kThreads / 32];
  // set flags before this block, and in all blocks
  int before = 0, all = 0;
  for (int b = threadIdx.x; b < gridDim.x; b += kThreads) {
    const int c = counts[b];
    all += c;
    if (b < blockIdx.x) before += c;
  }
  before = block_sum(before, sh);
  all = block_sum(all, sh);
  // this thread's rank: an inclusive scan of the threads' counts, first
  // inside each warp by shuffles, then over the warps' totals
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int base = blockIdx.x * kSelTile + threadIdx.x * kSelPer;
  unsigned mask = flags16(flags, base, m, vec);
  int incl = __popc(mask);
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int up = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += up;
  }
  if (lane == 31) sh[warp] = incl;
  __syncthreads();
  int r = before + incl - __popc(mask);
  for (int w = 0; w < warp; ++w) r += sh[w];
  while (mask && r < cap) {
    const int j = __ffs(mask) - 1;
    mask &= mask - 1;
    sel[r++] = base + j;
  }
  const int count = all < cap ? all : cap;
  for (int j = count + blockIdx.x * kThreads + threadIdx.x; j < cap;
       j += gridDim.x * kThreads)
    sel[j] = 0;
  if (blockIdx.x == 0 && threadIdx.x == 0) *count_out = count;
}

// ---- row gather


template <int V> struct Vec;
template <> struct Vec<1> { using T = float; };
template <> struct Vec<2> { using T = float2; };
template <> struct Vec<4> { using T = float4; };

__device__ __forceinline__ float payload_v(float v, int bf16) {
  return payload(v, bf16);
}
__device__ __forceinline__ float2 payload_v(float2 v, int bf16) {
  return make_float2(payload(v.x, bf16), payload(v.y, bf16));
}
__device__ __forceinline__ float4 payload_v(float4 v, int bf16) {
  return make_float4(payload(v.x, bf16), payload(v.y, bf16),
                     payload(v.z, bf16), payload(v.w, bf16));
}

// Blocks an SM must hold, which caps the registers: rows of at most 8
// floats at 32 a thread (the whole SM's 64 warps), wider ones at 64.
template <int K>
constexpr int kGatherMinBlocks = K > 0 && K <= 8 ? 8 : 4;

// I: the type of the output offsets (unsigned below 2^31 elements).
// K: the row width when it is one the tracer uses, 0 for any other (then
// V = 1). V: floats a load (4 or 2 where the rows' alignment allows).
// Warp w moves the group of 32 rows w*32 .. w*32 + 31. Lane l loads the
// index of the group's row l (one 128-byte load a group). The group's
// output, 32*K floats, is cut into 32*K/V pieces of V floats; in round s
// lane l moves piece s*32 + l: it takes its row's index from the row's
// lane by a shuffle, loads V floats of the row and stores them beside its
// neighbours' (each round stores 32 consecutive pieces). All row loads of
// the group are issued before its first store.
template <typename I, int K, int V>
__global__ void __launch_bounds__(kThreads, kGatherMinBlocks<K>)
    gather_rows_kernel(const float* __restrict__ table,
                       const int* __restrict__ idx, float* __restrict__ out,
                       int m, int k_any, int bf16) {
  using T = typename Vec<V>::T;
  const int lane = threadIdx.x & 31;
  const unsigned q0 = (blockIdx.x * (unsigned)blockDim.x + threadIdx.x) &
                      ~31u;
  if (q0 >= (unsigned)m) return;
  const int ix = q0 + lane < (unsigned)m ? __ldg(idx + q0 + lane) : 0;
  if constexpr (K > 0) {
    constexpr int P = K / V;  // pieces a row
    const T* src = reinterpret_cast<const T*>(table);
    T v[P];
#pragma unroll
    for (int s = 0; s < P; ++s) {
      const int t = s * 32 + lane;
      const int r = t / P;
      const int row = __shfl_sync(0xffffffffu, ix, r);
      if (q0 + r < (unsigned)m)
        v[s] = __ldg(src + (size_t)row * P + (t - r * P));
    }
    T* dst = reinterpret_cast<T*>(out) + (I)q0 * P;
#pragma unroll
    for (int s = 0; s < P; ++s) {
      const int t = s * 32 + lane;
      if (q0 + t / P < (unsigned)m) dst[t] = payload_v(v[s], bf16);
    }
  } else {
    // run-time width: a row is k pieces of one float, 8 in flight
    const int k = k_any;
    float* dst = out + (I)q0 * k;
    for (int s0 = 0; s0 < k; s0 += 8) {
      float v[8];
      int t[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int tu = (s0 + u) * 32 + lane;
        const int r = tu / k;
        const int row = __shfl_sync(0xffffffffu, ix, r & 31);
        t[u] = s0 + u < k && q0 + r < (unsigned)m ? tu : -1;
        if (t[u] >= 0)
          v[u] = __ldg(table + (size_t)row * k + (tu - r * k));
      }
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (t[u] >= 0) dst[t[u]] = payload(v[u], bf16);
    }
  }
}

// One warp a group of 32 rows, 8 groups a block; 64-bit output offsets
// only where the output reaches 2^31 elements.
template <int K, int V>
int gather_launch(const float* table, const int* idx, float* out, int m,
                  int k, int bf16, cudaStream_t stream) {
  const unsigned grid = (unsigned)(((long long)m + kThreads - 1) / kThreads);
  if ((long long)m * k >= (1ll << 31))
    gather_rows_kernel<long long, K, V><<<grid, kThreads, 0, stream>>>(
        table, idx, out, m, k, bf16);
  else
    gather_rows_kernel<unsigned, K, V><<<grid, kThreads, 0, stream>>>(
        table, idx, out, m, k, bf16);
  return (int)cudaGetLastError();
}

// A width's route: the widest load that the width and the alignment of
// the table and the output allow (a view that starts inside a vector
// takes the float route).
template <int K>
int gather_width(const float* table, const int* idx, float* out, int m,
                 int k, int bf16, cudaStream_t stream) {
  if constexpr (K > 0 && K % 2 == 0) {
    constexpr int V = K % 4 == 0 ? 4 : 2;
    const uintptr_t base =
        reinterpret_cast<uintptr_t>(table) | reinterpret_cast<uintptr_t>(out);
    if (base % (4 * V) == 0)
      return gather_launch<K, V>(table, idx, out, m, k, bf16, stream);
  }
  return gather_launch<K, 1>(table, idx, out, m, k, bf16, stream);
}

}  // namespace

extern "C" int row_gather_launch(const float* table, const int* idx,
                                 float* out, int m, int k, int bf16,
                                 cudaStream_t stream) {
  if (m <= 0 || k <= 0) return 0;
  // the tracer's widths: film/throughput, draws, pack, material rows, the
  // side table of the standard material (13) and of the transparent one
  // (15 + 5); any other width, the transparent table's own 15 among them,
  // takes the run-time-width route
  switch (k) {
    case 3: return gather_width<3>(table, idx, out, m, k, bf16, stream);
    case 5: return gather_width<5>(table, idx, out, m, k, bf16, stream);
    case 6: return gather_width<6>(table, idx, out, m, k, bf16, stream);
    case 8: return gather_width<8>(table, idx, out, m, k, bf16, stream);
    case 13: return gather_width<13>(table, idx, out, m, k, bf16, stream);
    case 20: return gather_width<20>(table, idx, out, m, k, bf16, stream);
    default: return gather_width<0>(table, idx, out, m, k, bf16, stream);
  }
}

// coherent: the indices of the live (not all-zero) rows ascend.
// accumulate: add into `out` as it stands instead of into zeros.
extern "C" int row_scatter_add_launch(const float* cot, const int* idx,
                                      float* out, int m, int k, int n_rows,
                                      int bf16, int coherent, int accumulate,
                                      cudaStream_t stream) {
  if (!accumulate)
    cudaMemsetAsync(out, 0, sizeof(float) * (size_t)n_rows * k, stream);
  if (m > 0 && k > 0) {
    // the vector loads and atomics of a compiled-in width need aligned rows
    const bool aligned =
        ((reinterpret_cast<uintptr_t>(cot) | reinterpret_cast<uintptr_t>(out)) &
         15) == 0;
    if (k == 8 && aligned)
      scatter_launch<8>(cot, idx, out, m, k, n_rows, bf16, coherent, stream);
    else if (k == 3)
      scatter_launch<3>(cot, idx, out, m, k, n_rows, bf16, coherent, stream);
    else if (k == 2 && aligned)
      scatter_launch<2>(cot, idx, out, m, k, n_rows, bf16, coherent, stream);
    else
      scatter_launch<0>(cot, idx, out, m, k, n_rows, bf16, coherent, stream);
  }
  return (int)cudaGetLastError();
}

// flags (m,) bytes; sel (cap,) int32; count (1,) int32; counts: scratch of
// (m + 4095) / 4096 int32.
extern "C" int compact_sel_launch(const uint8_t* flags, int* sel, int* count,
                                  int* counts, int m, int cap,
                                  cudaStream_t stream) {
  const int grid = (m + kSelTile - 1) / kSelTile;
  if (grid < 1) return (int)cudaErrorInvalidValue;
  const int vec = (reinterpret_cast<uintptr_t>(flags) & 15) == 0;
  compact_count_kernel<<<grid, kThreads, 0, stream>>>(flags, counts, m, vec);
  compact_write_kernel<<<grid, kThreads, 0, stream>>>(flags, counts, sel,
                                                      count, m, cap, vec);
  return (int)cudaGetLastError();
}
