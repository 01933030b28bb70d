// Envmap NEE sampling, solid-angle pdf and bilinear fetch for small
// optimized emitters (H, W <= 64).
//
// Replaces the Pallas kernels of materialist_tpu/ops/pallas/envkernels.py:
//   env_sample_dir          (_env_sample_tpu, _make_sample_kernel)
//   env_pdf_dir             (_env_pdf_tpu, _make_pdf_kernel)
//   env_lookup_bilinear_tpu (_env_lookup_tpu, _make_lookup_kernel)
//
// Bound on the H100: device-memory bytes. Each query reads 8-12 bytes and
// writes 4-16; the tables (<= 2*64 + 2*64*64 floats, or a 64x64x3 emitter)
// are tiny. The TPU kernels resolved table reads with composed vreg
// gathers over (8,128) planes; here every block stages its tables in
// shared memory once and the table reads are shared-memory loads. The
// float operations follow the plain PyTorch versions
// (ops/kernels/envkernels.py), which follow materialist_tpu/ops/envmap.py.
//
// env_sample_dir moves 24 bytes a query but also runs some 150
// instructions for it (two searches, five divisions, two sincosf), so on
// this card its instruction stream costs about as much as its bytes. Its
// design:
//  - a grid of at most kSampleBlocksPerSm blocks per SM; a block walks
//    tiles of kThreads * kQ queries, and its tables come once, by
//    cp.async, while the first tile's uniforms are already being loaded;
//  - a thread holds kQ queries in flight, a block's width apart, each
//    loaded as one float2, and the next tile's are fetched before this
//    tile's are worked on. kQ is 4 where that still leaves every SM a
//    block, else 2 or 1: a small launch is a matter of latency, and more,
//    shorter threads end sooner, while every block pays for its tables;
//  - row and column come from a branch-free lower bound whose trip count
//    depends on the table size alone, so the kQ searches of a thread run
//    in lockstep and their shared-memory reads overlap. The CDFs are
//    running sums of positive terms (the sampler floors every texel at 1%
//    of the mean), hence strictly increasing, and the lower bound is the
//    count of entries below the uniform, which the plain version takes;
//  - conditional rows lie an odd number of floats apart, so lanes that
//    search different rows at the same column hit different banks;
//  - a warp writes its 32 directions through a 96-float stage as three
//    whole 128-byte lines instead of 96 stores 12 bytes apart.
// env_pdf_dir and env_lookup_bilinear keep one query per thread.
// env_pdf_dir moves 16 bytes a query but runs some 160 instructions for it
// (atan2f, acosf, sinf and three IEEE divisions), so its instruction
// stream, not its bytes, bounds it on this card, and a full grid of
// 23-register threads keeps the most of them issuing: a version with
// env_sample_dir's design (kQ queries in flight, a warp's directions as
// three 128-byte lines through a shared stage) gave the same bits and
// measured slower at every main-path shape on an NVIDIA H100 80GB HBM3 at
// 700 W (0.0107 against 0.0089 ms at 1,048,576 queries; PERF.md section 6).

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kPi = 3.14159265358979323846f;      // f32(pi)
constexpr float kTwoPi = 6.28318530717958647692f;   // f32(2 pi)
constexpr float kTwoPi2 = 19.7392088021787172f;     // f32(2 pi^2)
constexpr int kThreads = 256;
constexpr int kQMax = 4;                  // queries a thread has in flight
constexpr int kSampleBlocksPerSm = 4;

__device__ __forceinline__ float clip01(float x) {
  return fminf(fmaxf(x, 0.f), 1.f);
}

// `rows` rows of `w` floats into shared memory, `stride` floats apart,
// by 4-byte cp.async (any alignment, any stride).
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           int rows, int w, int stride) {
  for (int i = threadIdx.x; i < rows * w; i += kThreads) {
    const int r = i / w;
    __pipeline_memcpy_async(dst + r * stride + (i - r * w), src + i, 4);
  }
}

// The uniforms of one tile: query (tile * kQ + j) * kThreads + thread.
template <int kQ>
__device__ __forceinline__ void load_tile(const float* __restrict__ u2,
                                          int tile, int m, int vec,
                                          float2 (&x)[kQ]) {
#pragma unroll
  for (int j = 0; j < kQ; ++j) {
    const int q = (tile * kQ + j) * kThreads + threadIdx.x;
    if (q >= m) {
      x[j] = make_float2(0.5f, 0.5f);
    } else if (vec) {
      x[j] = __ldg(reinterpret_cast<const float2*>(u2) + q);
    } else {
      x[j] = make_float2(__ldg(u2 + 2 * (size_t)q),
                         __ldg(u2 + 2 * (size_t)q + 1));
    }
  }
}

// lo[j] = number of entries of the ascending base[j][0..n) below x[j]. The
// trip count depends on n alone, so the kQ searches advance together.
template <int kQ>
__device__ __forceinline__ void lower_bounds(const float* (&base)[kQ],
                                             const float (&x)[kQ], int n,
                                             int (&lo)[kQ]) {
#pragma unroll
  for (int j = 0; j < kQ; ++j) lo[j] = 0;
  while (n > 1) {
    const int half = n >> 1;
#pragma unroll
    for (int j = 0; j < kQ; ++j)
      lo[j] = (base[j][lo[j] + half - 1] < x[j]) ? lo[j] + half : lo[j];
    n -= half;
  }
#pragma unroll
  for (int j = 0; j < kQ; ++j) lo[j] += (base[j][lo[j]] < x[j]) ? 1 : 0;
}

// inv_h, inv_w: 1/h, 1/w where that is a power of two (the division is then
// a multiplication, with the same result), else 0. texel: (m, 2) int32 row
// and column of every query, or null.
template <int kQ>
__global__ void __launch_bounds__(kThreads, kSampleBlocksPerSm)
env_sample_dir_kernel(const float* __restrict__ m_cdf,
                      const float* __restrict__ m_pdf,
                      const float* __restrict__ c_cdf,
                      const float* __restrict__ c_pdf,
                      const float* __restrict__ u2, float* __restrict__ wi,
                      float* __restrict__ pdf, int* __restrict__ texel, int m,
                      int h, int w, int vec, float inv_h, float inv_w) {
  extern __shared__ float sm[];
  const int ws = w | 1;
  float* s_mcdf = sm;
  float* s_mpdf = s_mcdf + h;
  float* s_ccdf = s_mpdf + h;
  float* s_cpdf = s_ccdf + h * ws;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* stage = s_cpdf + h * ws + warp * 96;
  stage_rows(s_mcdf, m_cdf, 1, h, h);
  stage_rows(s_mpdf, m_pdf, 1, h, h);
  stage_rows(s_ccdf, c_cdf, h, w, ws);
  stage_rows(s_cpdf, c_pdf, h, w, ws);
  __pipeline_commit();
  constexpr int kTile = kThreads * kQ;
  const int n_tiles = (m + kTile - 1) / kTile;
  int tile = blockIdx.x;
  float2 cur[kQ];
  load_tile(u2, tile, m, vec, cur);
  __pipeline_wait_prior(0);
  __syncthreads();
  const float hw = (float)(h * w), hf = (float)h, wf = (float)w;
  for (; tile < n_tiles; tile += gridDim.x) {
    float2 nxt[kQ];
    if (tile + (int)gridDim.x < n_tiles) {
      load_tile(u2, tile + gridDim.x, m, vec, nxt);
    } else {
#pragma unroll
      for (int j = 0; j < kQ; ++j) nxt[j] = make_float2(0.5f, 0.5f);
    }
    float x0[kQ], x1[kQ];
    const float* base[kQ];
    int v[kQ], u[kQ];
#pragma unroll
    for (int j = 0; j < kQ; ++j) {
      x0[j] = cur[j].x;
      x1[j] = cur[j].y;
      base[j] = s_mcdf;
    }
    lower_bounds(base, x0, h, v);
#pragma unroll
    for (int j = 0; j < kQ; ++j) {
      v[j] = min(v[j], h - 1);
      base[j] = s_ccdf + v[j] * ws;
    }
    lower_bounds(base, x1, w, u);
#pragma unroll
    for (int j = 0; j < kQ; ++j) {
      const int vj = v[j], uj = min(u[j], w - 1);
      const float at_m = s_mcdf[vj];
      const float prev_m = vj > 0 ? s_mcdf[vj - 1] : 0.f;
      const float pdf_m = s_mpdf[vj];
      const float dv =
          clip01((x0[j] - prev_m) / fmaxf(at_m - prev_m, 1e-12f));
      const float* row = base[j];
      const float at_c = row[uj];
      const float prev_c = uj > 0 ? row[uj - 1] : 0.f;
      const float du =
          clip01((x1[j] - prev_c) / fmaxf(at_c - prev_c, 1e-12f));
      const float pdf_c = s_cpdf[vj * ws + uj];
      const float uu = (float)uj + du;
      const float vv = (float)vj + dv;
      const float pn = kTwoPi * uu, tn = kPi * vv;
      const float phi = inv_w > 0.f ? pn * inv_w : pn / wf;
      const float theta = inv_h > 0.f ? tn * inv_h : tn / hf;
      float st, ct, sp, cp;
      sincosf(theta, &st, &ct);
      sincosf(phi, &sp, &cp);
      const int q0 = (tile * kQ + j) * kThreads + warp * 32;  // the warp's
      const int q = q0 + lane;
      __syncwarp();
      stage[3 * lane] = st * sp;
      stage[3 * lane + 1] = ct;
      stage[3 * lane + 2] = -st * cp;
      __syncwarp();
      const size_t f0 = 3 * (size_t)q0, f_end = 3 * (size_t)m;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const size_t f = f0 + 32 * c + lane;
        if (f < f_end) wi[f] = stage[32 * c + lane];
      }
      if (q < m) {
        pdf[q] = (hw * (pdf_c * pdf_m)) / (kTwoPi2 * fmaxf(st, 1e-6f));
        if (texel) {
          texel[2 * (size_t)q] = vj;
          texel[2 * (size_t)q + 1] = uj;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kQ; ++j) cur[j] = nxt[j];
  }
}

__global__ void env_pdf_dir_kernel(const float* __restrict__ m_pdf,
                                   const float* __restrict__ c_pdf,
                                   const float* __restrict__ d,
                                   float* __restrict__ pdf, int m, int h,
                                   int w) {
  extern __shared__ float sm[];
  float* s_mpdf = sm;
  float* s_cpdf = sm + h;
  for (int i = threadIdx.x; i < h; i += blockDim.x) s_mpdf[i] = m_pdf[i];
  for (int i = threadIdx.x; i < h * w; i += blockDim.x) s_cpdf[i] = c_pdf[i];
  __syncthreads();
  for (int q = blockIdx.x * blockDim.x + threadIdx.x; q < m;
       q += gridDim.x * blockDim.x) {
    const float dx = d[3 * q], dy = d[3 * q + 1], dz = d[3 * q + 2];
    const float phi = atan2f(dx, -dz) / kTwoPi;
    const float u = (phi - floorf(phi)) * (float)w;
    const float theta = acosf(fminf(fmaxf(dy, -1.f), 1.f));
    const float v = theta / kPi * (float)h;
    const int ui = min(max((int)u, 0), w - 1);
    const int vi = min(max((int)v, 0), h - 1);
    const float st = fmaxf(sinf(theta), 1e-6f);
    pdf[q] = ((float)(h * w) * (s_cpdf[vi * w + ui] * s_mpdf[vi])) /
             (kTwoPi2 * st);
  }
}

__global__ void env_lookup_bilinear_kernel(const float* __restrict__ env,
                                           const int* __restrict__ u0i,
                                           const int* __restrict__ v0i,
                                           const float* __restrict__ du_,
                                           const float* __restrict__ dv_,
                                           float* __restrict__ out, int m,
                                           int h, int w) {
  extern __shared__ float s_env[];
  for (int i = threadIdx.x; i < h * w * 3; i += blockDim.x) s_env[i] = env[i];
  __syncthreads();
  for (int q = blockIdx.x * blockDim.x + threadIdx.x; q < m;
       q += gridDim.x * blockDim.x) {
    const int u0 = u0i[q], v0 = v0i[q];
    const int u1 = (u0 + 1 >= w) ? 0 : u0 + 1;
    const int v1 = min(v0 + 1, h - 1);
    const float du = du_[q], dv = dv_[q];
    const float w00 = (1.f - du) * (1.f - dv);
    const float w01 = du * (1.f - dv);
    const float w10 = (1.f - du) * dv;
    const float w11 = du * dv;
    const float* t00 = s_env + 3 * (v0 * w + u0);
    const float* t01 = s_env + 3 * (v0 * w + u1);
    const float* t10 = s_env + 3 * (v1 * w + u0);
    const float* t11 = s_env + 3 * (v1 * w + u1);
    for (int c = 0; c < 3; ++c) {
      float acc = w00 * t00[c];
      acc += w01 * t01[c];
      acc += w10 * t10[c];
      acc += w11 * t11[c];
      out[3 * q + c] = acc;
    }
  }
}

int grid_for(int m) {
  const int g = (m + kThreads - 1) / kThreads;
  // about 8 blocks per SM: each block stages the tables once and then
  // strides over its share of the queries
  return g < 1 ? 1 : (g > 1056 ? 1056 : g);
}

}  // namespace

// texel: null, or (m, 2) int32 for the row and column of every query.
extern "C" int env_sample_dir_launch(const float* m_cdf, const float* m_pdf,
                                     const float* c_cdf, const float* c_pdf,
                                     const float* u2, float* wi, float* pdf,
                                     int* texel, int m, int h, int w,
                                     cudaStream_t stream) {
  const int ws = w | 1;
  const size_t smem =
      sizeof(float) * (2 * h + 2 * h * ws + (kThreads / 32) * 96);
  // at most kSampleBlocksPerSm blocks on every SM (the count is kept per
  // calling thread for the device it last saw)
  static thread_local int resident = 0, resident_dev = -1;
  int dev = 0;
  cudaGetDevice(&dev);
  if (resident_dev != dev) {
    int sms = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    resident = (sms < 1 ? 1 : sms) * kSampleBlocksPerSm;
    resident_dev = dev;
  }
  int q = kQMax;
  while (q > 1 && (m + kThreads * q - 1) / (kThreads * q) <
                      resident / kSampleBlocksPerSm)
    q >>= 1;
  int grid = (m + kThreads * q - 1) / (kThreads * q);
  grid = grid < 1 ? 1 : (grid > resident ? resident : grid);
  const int vec = (reinterpret_cast<uintptr_t>(u2) & 7) == 0;
  const float inv_h = (h & (h - 1)) == 0 ? 1.f / (float)h : 0.f;
  const float inv_w = (w & (w - 1)) == 0 ? 1.f / (float)w : 0.f;
  auto kern = q == 4   ? env_sample_dir_kernel<4>
              : q == 2 ? env_sample_dir_kernel<2>
                       : env_sample_dir_kernel<1>;
  kern<<<grid, kThreads, smem, stream>>>(m_cdf, m_pdf, c_cdf, c_pdf, u2, wi,
                                         pdf, texel, m, h, w, vec, inv_h,
                                         inv_w);
  return (int)cudaGetLastError();
}

extern "C" int env_pdf_dir_launch(const float* m_pdf, const float* c_pdf,
                                  const float* d, float* pdf, int m, int h,
                                  int w, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (h + h * w);
  env_pdf_dir_kernel<<<grid_for(m), kThreads, smem, stream>>>(
      m_pdf, c_pdf, d, pdf, m, h, w);
  return (int)cudaGetLastError();
}

extern "C" int env_lookup_bilinear_launch(const float* env, const int* u0i,
                                          const int* v0i, const float* du,
                                          const float* dv, float* out, int m,
                                          int h, int w, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (h * w * 3);
  env_lookup_bilinear_kernel<<<grid_for(m), kThreads, smem, stream>>>(
      env, u0i, v0i, du, dv, out, m, h, w);
  return (int)cudaGetLastError();
}
