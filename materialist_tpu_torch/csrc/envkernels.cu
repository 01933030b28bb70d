// Envmap NEE sampling, solid-angle pdf and bilinear fetch for small
// optimized emitters (H, W <= 64).
//
// Replaces the Pallas kernels of materialist_tpu/ops/pallas/envkernels.py:
//   env_sample_dir          (_env_sample_tpu, _make_sample_kernel)
//   env_pdf_dir             (_env_pdf_tpu, _make_pdf_kernel)
//   env_lookup_bilinear_tpu (_env_lookup_tpu, _make_lookup_kernel)
// and, with no TPU kernel behind it, bounce_record: a fused bounce's trace
// record after the march (see its comment below).
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

#include <cuda_bf16.h>
#include <cuda_fp16.h>
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

// The pdf tables (h marginal, h*w conditional floats) into shared memory.
__device__ __forceinline__ void stage_pdf_tables(float* s_mpdf, float* s_cpdf,
                                                 const float* m_pdf,
                                                 const float* c_pdf, int h,
                                                 int w) {
  for (int i = threadIdx.x; i < h; i += blockDim.x) s_mpdf[i] = m_pdf[i];
  for (int i = threadIdx.x; i < h * w; i += blockDim.x) s_cpdf[i] = c_pdf[i];
  __syncthreads();
}

// Kernel D′'s density at a direction d: a = atan2f(d.x, -d.z), theta =
// acosf of d.y clamped to [-1, 1].
__device__ __forceinline__ float pdf_at_dir(float a, float theta,
                                            const float* s_mpdf,
                                            const float* s_cpdf, int h,
                                            int w) {
  const float phi = a / kTwoPi;
  const float u = (phi - floorf(phi)) * (float)w;
  const float v = theta / kPi * (float)h;
  const int ui = min(max((int)u, 0), w - 1);
  const int vi = min(max((int)v, 0), h - 1);
  const float st = fmaxf(sinf(theta), 1e-6f);
  return ((float)(h * w) * (s_cpdf[vi * w + ui] * s_mpdf[vi])) /
         (kTwoPi2 * st);
}

__global__ void env_pdf_dir_kernel(const float* __restrict__ m_pdf,
                                   const float* __restrict__ c_pdf,
                                   const float* __restrict__ d,
                                   float* __restrict__ pdf, int m, int h,
                                   int w) {
  extern __shared__ float sm[];
  float* s_mpdf = sm;
  float* s_cpdf = sm + h;
  stage_pdf_tables(s_mpdf, s_cpdf, m_pdf, c_pdf, h, w);
  for (int q = blockIdx.x * blockDim.x + threadIdx.x; q < m;
       q += gridDim.x * blockDim.x) {
    const float dx = d[3 * q], dy = d[3 * q + 1], dz = d[3 * q + 2];
    pdf[q] = pdf_at_dir(atan2f(dx, -dz), acosf(fminf(fmaxf(dy, -1.f), 1.f)),
                        s_mpdf, s_cpdf, h, w);
  }
}

// ---------------------------------------------------------------------
// bounce_record: the fused shade's record of one bounce, written after the
// march (render/shader.py::_trace_chunk_paths in fused mode). Per row it
// reads the lobe direction wi, the NEE direction wi_e and its pdf, the
// hit and shadowed flags, the alive flag and the shading normal (both
// through their strides: bounce 0 broadcasts them over the samples), and
// writes
//   aux  (5 bf16): normalize9(bf16(wi)), alive & !shadowed, alive & !hit
//   recb (13 bf16): pdf_e, D′'s pdf of wi, wi_e, du dv of wi_e's and of
//                   wi's bilinear taps, u0 v0 of wi_e's and of wi's taps
//   nrm  (3 f16): the normal
// bit for bit as the plain version (ops/kernels/envkernels.py::
// bounce_record_plain, a chain of PyTorch operations) writes them on the
// card. So each step rounds where that operation does: a division by a
// Python scalar is PyTorch's multiplication by the f32 reciprocal
// (inv_two_pi, inv_pi), torch.clamp keeps a NaN, Σ v² over three columns
// adds the first and the third, then the second (PyTorch's reduction
// splits three columns over two lanes), and the casts round to nearest
// even. D′'s pdf is pdf_at_dir, which divides; its atan2f and acosf are
// those of the taps of wi. A warp's records go out through a shared stage
// as whole 4-byte words.

constexpr int kAuxCols = 5, kRecbCols = 13, kNrmCols = 3;
constexpr int kRecCols = kAuxCols + kRecbCols + kNrmCols;  // 2 bytes each

__device__ __forceinline__ float clamp_keep_nan(float x, float lo, float hi) {
  return x != x ? x : fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ unsigned short bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// ops/kernels/envkernels.py::bilinear_coords of a direction whose
// atan2(x, -z) is a and whose acos(clamped y) is theta.
__device__ __forceinline__ void bilinear_taps(float a, float theta, int h,
                                              int w, float inv_two_pi,
                                              float inv_pi, int& u0i,
                                              int& v0i, float& du,
                                              float& dv) {
  const float phi = a * inv_two_pi;
  const float u = (phi - floorf(phi)) * (float)w;
  const float v = (theta * inv_pi) * (float)h;
  const float uf = u - 0.5f, vf = v - 0.5f;
  const float u0 = floorf(uf), v0 = floorf(vf);
  du = uf - u0;
  dv = vf - v0;
  const int r = (int)u0 % w;
  u0i = r < 0 ? r + w : r;                 // torch.remainder, w > 0
  v0i = min(max((int)v0, 0), h - 1);
}

// Of row q of (m, 3) directions d: atan2f(x, -z), y and acosf(y clamped).
__device__ __forceinline__ void dir_angles(const float* __restrict__ d,
                                           int q, float& a, float& y,
                                           float& theta) {
  const float dx = d[3 * (size_t)q], dz = d[3 * (size_t)q + 2];
  y = d[3 * (size_t)q + 1];
  a = atan2f(dx, -dz);
  theta = acosf(clamp_keep_nan(y, -1.f, 1.f));
}

__global__ void __launch_bounds__(kThreads) bounce_record_kernel(
    const float* __restrict__ m_pdf, const float* __restrict__ c_pdf,
    const float* __restrict__ wi, const float* __restrict__ wi_e,
    const float* __restrict__ pdf_e, const unsigned char* __restrict__ hit,
    const unsigned char* __restrict__ shadowed,
    const unsigned char* __restrict__ alive, long long alive_s0,
    long long alive_s1, const float* __restrict__ nrm, long long nrm_s0,
    long long nrm_s1, long long nrm_sc, unsigned short* __restrict__ aux,
    unsigned short* __restrict__ recb, unsigned short* __restrict__ nrm16,
    int m, int n1, int h, int w, float inv_two_pi, float inv_pi) {
  extern __shared__ float sm[];
  float* s_mpdf = sm;
  float* s_cpdf = sm + h;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // the stage: 16-byte aligned after the tables, kRecCols halves a row
  unsigned short* stage =
      reinterpret_cast<unsigned short*>(sm + ((h + h * w + 3) & ~3)) +
      warp * 32 * kRecCols;
  unsigned short* st_aux = stage;
  unsigned short* st_recb = stage + 32 * kAuxCols;
  unsigned short* st_nrm = st_recb + 32 * kRecbCols;
  stage_pdf_tables(s_mpdf, s_cpdf, m_pdf, c_pdf, h, w);
  const int step = gridDim.x * blockDim.x;
  for (int q0 = blockIdx.x * blockDim.x + warp * 32; q0 < m; q0 += step) {
    const int q = q0 + lane;
    if (q < m) {
      const int i = q / n1, j = q - i * n1;
      float a, y, theta;
      dir_angles(wi_e, q, a, y, theta);
      int u0e, v0e;
      float due, dve;
      bilinear_taps(a, theta, h, w, inv_two_pi, inv_pi, u0e, v0e, due, dve);
      dir_angles(wi, q, a, y, theta);
      int u0b, v0b;
      float dub, dvb;
      bilinear_taps(a, theta, h, w, inv_two_pi, inv_pi, u0b, v0b, dub, dvb);
      // D′ clamps a NaN to -1
      const float pdf_at = pdf_at_dir(
          a, y != y ? acosf(-1.f) : theta, s_mpdf, s_cpdf, h, w);
      float b[3];
#pragma unroll
      for (int c = 0; c < 3; ++c)
        b[c] = __bfloat162float(__float2bfloat16_rn(wi[3 * (size_t)q + c]));
      const float sq0 = b[0] * b[0], sq1 = b[1] * b[1], sq2 = b[2] * b[2];
      const float den = clamp_keep_nan(sqrtf((sq0 + sq2) + sq1), 1e-9f,
                                       INFINITY);
      const bool live = alive[i * alive_s0 + j * alive_s1] != 0;
      unsigned short* ra = st_aux + lane * kAuxCols;
#pragma unroll
      for (int c = 0; c < 3; ++c) ra[c] = bf16_bits(b[c] / den);
      ra[3] = bf16_bits(live && !shadowed[q] ? 1.f : 0.f);
      ra[4] = bf16_bits(live && !hit[q] ? 1.f : 0.f);
      unsigned short* rb = st_recb + lane * kRecbCols;
      rb[0] = bf16_bits(pdf_e[q]);
      rb[1] = bf16_bits(pdf_at);
#pragma unroll
      for (int c = 0; c < 3; ++c) rb[2 + c] = bf16_bits(wi_e[3 * (size_t)q + c]);
      rb[5] = bf16_bits(due);
      rb[6] = bf16_bits(dve);
      rb[7] = bf16_bits(dub);
      rb[8] = bf16_bits(dvb);
      // int32 -> int16 -> bf16, as the plain version's casts
      rb[9] = bf16_bits((float)(short)u0e);
      rb[10] = bf16_bits((float)(short)v0e);
      rb[11] = bf16_bits((float)(short)u0b);
      rb[12] = bf16_bits((float)(short)v0b);
      const float* nq = nrm + i * nrm_s0 + j * nrm_s1;
      unsigned short* rn = st_nrm + lane * kNrmCols;
#pragma unroll
      for (int c = 0; c < 3; ++c)
        rn[c] = __half_as_ushort(__float2half_rn(nq[c * nrm_sc]));
    }
    __syncwarp();
    const int rows = min(32, m - q0);
    const unsigned short* src[3] = {st_aux, st_recb, st_nrm};
    unsigned short* dst[3] = {aux + (size_t)q0 * kAuxCols,
                              recb + (size_t)q0 * kRecbCols,
                              nrm16 + (size_t)q0 * kNrmCols};
    const int cols[3] = {kAuxCols, kRecbCols, kNrmCols};
#pragma unroll
    for (int t = 0; t < 3; ++t) {
      // q0 is a multiple of 32, so a warp's records start on a whole
      // word; an odd half at the end of the last warp goes alone
      const int halves = rows * cols[t];
      const unsigned* s32 = reinterpret_cast<const unsigned*>(src[t]);
      unsigned* d32 = reinterpret_cast<unsigned*>(dst[t]);
      for (int k = lane; k < halves / 2; k += 32) d32[k] = s32[k];
      if ((halves & 1) && lane == 0) dst[t][halves - 1] = src[t][halves - 1];
    }
    __syncwarp();
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

// alive_s*, nrm_s*: element strides of the alive flags over the two
// leading axes (n0 = m / n1, n1) and of the normal over them and its
// column; aux, recb, nrm16: (m, 5), (m, 13) bf16 and (m, 3) f16.
extern "C" int bounce_record_launch(
    const float* m_pdf, const float* c_pdf, const float* wi,
    const float* wi_e, const float* pdf_e, const unsigned char* hit,
    const unsigned char* shadowed, const unsigned char* alive,
    long long alive_s0, long long alive_s1, const float* nrm,
    long long nrm_s0, long long nrm_s1, long long nrm_sc,
    unsigned short* aux, unsigned short* recb, unsigned short* nrm16, int m,
    int n1, int h, int w, float inv_two_pi, float inv_pi,
    cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((h + h * w + 3) & ~3) +
                      sizeof(unsigned short) * kThreads * kRecCols;
  bounce_record_kernel<<<grid_for(m), kThreads, smem, stream>>>(
      m_pdf, c_pdf, wi, wi_e, pdf_e, hit, shadowed, alive, alive_s0,
      alive_s1, nrm, nrm_s0, nrm_s1, nrm_sc, aux, recb, nrm16, m, n1, h, w,
      inv_two_pi, inv_pi);
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
