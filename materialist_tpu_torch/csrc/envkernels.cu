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
// shared memory once, one thread handles one query (grid-stride), and the
// table reads are shared-memory loads. sin/cos/acos/atan2 are the
// full-precision device functions. The float operations follow the plain
// PyTorch versions (ops/kernels/envkernels.py), which follow
// materialist_tpu/ops/envmap.py.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kPi = 3.14159265358979323846f;      // f32(pi)
constexpr float kTwoPi = 6.28318530717958647692f;   // f32(2 pi)
constexpr float kTwoPi2 = 19.7392088021787172f;     // f32(2 pi^2)
constexpr int kThreads = 256;

__device__ __forceinline__ float clip01(float x) {
  return fminf(fmaxf(x, 0.f), 1.f);
}

__global__ void env_sample_dir_kernel(const float* __restrict__ m_cdf,
                                      const float* __restrict__ m_pdf,
                                      const float* __restrict__ c_cdf,
                                      const float* __restrict__ c_pdf,
                                      const float* __restrict__ u2,
                                      float* __restrict__ wi,
                                      float* __restrict__ pdf, int m, int h,
                                      int w) {
  extern __shared__ float sm[];
  float* s_mcdf = sm;
  float* s_mpdf = s_mcdf + h;
  float* s_ccdf = s_mpdf + h;
  float* s_cpdf = s_ccdf + h * w;
  for (int i = threadIdx.x; i < h; i += blockDim.x) {
    s_mcdf[i] = m_cdf[i];
    s_mpdf[i] = m_pdf[i];
  }
  for (int i = threadIdx.x; i < h * w; i += blockDim.x) {
    s_ccdf[i] = c_cdf[i];
    s_cpdf[i] = c_pdf[i];
  }
  __syncthreads();
  for (int q = blockIdx.x * blockDim.x + threadIdx.x; q < m;
       q += gridDim.x * blockDim.x) {
    const float x0 = u2[2 * q];
    const float x1 = u2[2 * q + 1];
    // marginal row: count of CDF entries below x0
    int cnt = 0;
    for (int r = 0; r < h; ++r) cnt += (s_mcdf[r] < x0) ? 1 : 0;
    const int v = min(cnt, h - 1);
    const float at_m = s_mcdf[v];
    const float prev_m = v > 0 ? s_mcdf[v - 1] : 0.f;
    const float pdf_m = s_mpdf[v];
    const float dv = clip01((x0 - prev_m) / fmaxf(at_m - prev_m, 1e-12f));
    // conditional column: lower bound over the row's CDF
    const float* row = s_ccdf + v * w;
    int lo = 0, size = w;
    while (size > 0) {
      const int half = size / 2;
      const int mid = lo + half;
      if (row[mid] < x1) {
        lo = mid + 1;
        size = size - half - 1;
      } else {
        size = half;
      }
    }
    const int u = min(lo, w - 1);
    const float at_c = row[u];
    const float prev_c = u > 0 ? row[u - 1] : 0.f;
    const float du = clip01((x1 - prev_c) / fmaxf(at_c - prev_c, 1e-12f));
    const float pdf_c = s_cpdf[v * w + u];
    const float uu = (float)u + du;
    const float vv = (float)v + dv;
    const float phi = kTwoPi * uu / (float)w;
    const float theta = kPi * vv / (float)h;
    const float st = sinf(theta);
    wi[3 * q] = st * sinf(phi);
    wi[3 * q + 1] = cosf(theta);
    wi[3 * q + 2] = -st * cosf(phi);
    pdf[q] = ((float)(h * w) * (pdf_c * pdf_m)) / (kTwoPi2 * fmaxf(st, 1e-6f));
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

extern "C" int env_sample_dir_launch(const float* m_cdf, const float* m_pdf,
                                     const float* c_cdf, const float* c_pdf,
                                     const float* u2, float* wi, float* pdf,
                                     int m, int h, int w,
                                     cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * h + 2 * h * w);
  env_sample_dir_kernel<<<grid_for(m), kThreads, smem, stream>>>(
      m_cdf, m_pdf, c_cdf, c_pdf, u2, wi, pdf, m, h, w);
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
