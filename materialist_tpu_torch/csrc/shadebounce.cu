// Fused shade of one path vertex and its adjoint: two Disney BRDF
// evaluations (NEE direction and lobe direction), two bilinear emitter
// fetches from the recorded tap coords, balance-heuristic MIS, and the
// (throughput', radiance delta) update; the backward emits d_blob (albedo,
// roughness, metallic), d_throughput and d_le (the two fetches).
//
// Replaces the Pallas kernels of materialist_tpu/ops/pallas/shadebounce.py
// (_fwd_call/_make_fwd_kernel and _bwd_call/_make_bwd_kernel of
// shade_bounce_fused; the math is _bounce_math and _disney_soa).
//
// Bound on the H100: device-memory bytes. Per vertex the forward reads
// 80 B (blob 20, throughput 12, f16 normal 6, bf16 aux 16, bf16 record 26)
// and writes 24 B against ~250 FP32 operations; the backward reads 104 B
// and writes 56 B. The TPU kernel repacked every input into (C, 8, 128)
// planes in device memory before the call and ran the adjoint as an
// in-kernel jax.vjp; here one thread shades one vertex straight from the
// recorded bf16/f16 rows (no repacking pass), the emitter (<= 64x64x3 f32)
// sits in shared memory, and the adjoint is derived by hand (its plain
// PyTorch transcription, shade_bounce_bwd_explicit, is held against
// torch.autograd of the forward in the tests). pdf_b and pdf_b_at_e are
// detached; a gated-off term contributes exactly zero value and zero
// cotangent even where it would be inf/NaN; the nan_to_num of the lobe
// weight passes its cotangent only where the weight was finite.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kPi = 3.14159265358979323846f;
constexpr float kInvPi = 0.318309886183790671538f;
constexpr int kThreads = 256;

__device__ __forceinline__ float bf(const __nv_bfloat16* p, int i) {
  return __bfloat162float(p[i]);
}

__device__ __forceinline__ float pow5(float x) {
  const float x2 = x * x;
  return x * (x2 * x2);
}

struct Geom {  // detached geometry of one BRDF evaluation
  float no_l, no_v, vo_h, no_h;
};

__device__ __forceinline__ Geom geom(float wx, float wy, float wz, float vx,
                                     float vy, float vz, float nx, float ny,
                                     float nz) {
  float hx = wx + vx, hy = wy + vy, hz = wz + vz;
  float hn = sqrtf(hx * hx + hy * hy + hz * hz);
  hn = fmaxf(hn, 1e-12f);
  hx = hx / hn;
  hy = hy / hn;
  hz = hz / hn;
  Geom g;
  g.no_l = fmaxf(nx * wx + ny * wy + nz * wz, 0.f);
  g.no_v = fmaxf(nx * vx + ny * vy + nz * vz, 0.f);
  g.vo_h = fmaxf(vx * hx + vy * hy + vz * hz, 0.f);
  g.no_h = fmaxf(nx * hx + ny * hy + nz * hz, 0.f);
  return g;
}

// _disney_soa: f[c] (NoL folded in) and the mixture pdf; the scalar
// intermediates are kept for the adjoint.
struct Disney {
  float f[3], pdf;
  float d, den, g, ga, gb, k, f_out, f_in, diff_s, dg4, p5, one_m;
};

__device__ __forceinline__ Disney disney(const float a[3], float rough,
                                         float metal, const Geom& q) {
  Disney o;
  const float alpha = rough * rough;
  const float alpha2 = alpha * alpha;
  o.den = q.no_h * q.no_h * (alpha2 - 1.f) + 1.f + 1e-6f;
  o.d = alpha2 / (kPi * o.den * o.den);
  o.pdf = 0.5f * (o.d / (4.f * fmaxf(q.vo_h, 1e-6f)) * q.no_h) +
          0.5f * (q.no_l / kPi);
  o.one_m = 1.f - metal;
  const float f_d90 = 0.5f + 2.f * q.vo_h * q.vo_h * rough;
  o.f_out = 1.f + (f_d90 - 1.f) * pow5(1.f - q.no_v);
  o.f_in = 1.f + (f_d90 - 1.f) * pow5(1.f - q.no_l);
  o.diff_s = o.one_m / kPi * o.f_out * o.f_in * q.no_l;
  const float r1 = rough + 1.f;
  o.k = r1 * r1 / 8.f;
  o.ga = q.no_l * (1.f - o.k) + o.k + 1e-6f;
  o.gb = q.no_v * (1.f - o.k) + o.k + 1e-6f;
  o.g = 1.f / (o.ga * o.gb);
  o.dg4 = o.d * o.g / 4.f * q.no_l;
  o.p5 = pow5(1.f - q.vo_h);
  for (int c = 0; c < 3; ++c) {
    const float c0 = o.one_m * 0.04f + metal * a[c];
    const float fm = c0 + (1.f - c0) * o.p5;
    o.f[c] = a[c] * o.diff_s + o.dg4 * fm;
  }
  return o;
}

// Adjoint of disney() w.r.t. (albedo, roughness, metallic) for output
// cotangents ct[3] (the pdf is detached); accumulates into da/dr/dm.
__device__ __forceinline__ void disney_bwd(const float a[3], float rough,
                                           float metal, const Geom& q,
                                           const Disney& o, const float ct[3],
                                           float da[3], float& dr,
                                           float& dm) {
  const float alpha2 = rough * rough * rough * rough;
  const float pd2 = kPi * o.den * o.den;
  const float dd_da2 = 1.f / pd2 - 2.f * alpha2 * q.no_h * q.no_h / (pd2 * o.den);
  const float dd_dr = dd_da2 * 4.f * rough * rough * rough;
  const float dg_dk = -o.g * ((1.f - q.no_l) / o.ga + (1.f - q.no_v) / o.gb);
  const float dg_dr = dg_dk * (rough + 1.f) * 0.25f;
  const float ddg4_dr = (dd_dr * o.g + o.d * dg_dr) * 0.25f * q.no_l;
  const float dfd90_dr = 2.f * q.vo_h * q.vo_h;
  const float dfout_dr = dfd90_dr * pow5(1.f - q.no_v);
  const float dfin_dr = dfd90_dr * pow5(1.f - q.no_l);
  const float ddiff_dr =
      o.one_m * kInvPi * q.no_l * (dfout_dr * o.f_in + o.f_out * dfin_dr);
  const float ddiff_dm = -kInvPi * o.f_out * o.f_in * q.no_l;
  const float q5 = 1.f - o.p5;
  for (int c = 0; c < 3; ++c) {
    const float c0 = o.one_m * 0.04f + metal * a[c];
    const float fm = c0 + (1.f - c0) * o.p5;
    da[c] += ct[c] * (o.diff_s + o.dg4 * q5 * metal);
    dr += ct[c] * (a[c] * ddiff_dr + ddg4_dr * fm);
    dm += ct[c] * (a[c] * ddiff_dm + o.dg4 * q5 * (a[c] - 0.04f));
  }
}

// In-kernel 4-tap bilinear emitter fetch from recorded tap coords
// (phi-wrap on u, theta-clamp on v).
__device__ __forceinline__ void lookup4(const float* env, int h, int w, int u0,
                                        int v0, float du, float dv,
                                        float out[3]) {
  const int u1 = (u0 + 1 >= w) ? 0 : u0 + 1;
  const int v1 = min(v0 + 1, h - 1);
  const float w00 = (1.f - du) * (1.f - dv);
  const float w01 = du * (1.f - dv);
  const float w10 = (1.f - du) * dv;
  const float w11 = du * dv;
  for (int c = 0; c < 3; ++c) {
    float acc = w00 * env[3 * (v0 * w + u0) + c];
    acc += w01 * env[3 * (v0 * w + u1) + c];
    acc += w10 * env[3 * (v1 * w + u0) + c];
    acc += w11 * env[3 * (v1 * w + u1) + c];
    out[c] = acc;
  }
}

// Everything one vertex needs, forward values included.
struct Vertex {
  float a[3], rough, metal, t[3], le[3], lm[3];
  Geom ge, gb;
  Disney fe, fb;
  float s_nee, w[3], wraw_ok[3], w_mis_b;
  bool g_nee, g_miss;
};

__device__ __forceinline__ void load_vertex(
    int q, const float* env, int h, int w, const float* __restrict__ blob,
    const float* __restrict__ thr, const __half* __restrict__ nrm,
    const __nv_bfloat16* __restrict__ aux,
    const __nv_bfloat16* __restrict__ recb, Vertex& v) {
  const float* b = blob + 5 * q;
  v.a[0] = b[0];
  v.a[1] = b[1];
  v.a[2] = b[2];
  v.rough = b[3];
  v.metal = b[4];
  for (int c = 0; c < 3; ++c) v.t[c] = thr[3 * q + c];
  const float nx = __half2float(nrm[3 * q]);
  const float ny = __half2float(nrm[3 * q + 1]);
  const float nz = __half2float(nrm[3 * q + 2]);
  const __nv_bfloat16* x = aux + 8 * q;
  const float wox = bf(x, 0), woy = bf(x, 1), woz = bf(x, 2);
  const float wnx = bf(x, 3), wny = bf(x, 4), wnz = bf(x, 5);
  v.g_nee = bf(x, 6) > 0.f;
  v.g_miss = bf(x, 7) > 0.f;
  const __nv_bfloat16* r = recb + 13 * q;
  const float pdf_e = bf(r, 0), pdf_at = bf(r, 1);
  lookup4(env, h, w, (int)bf(r, 9), (int)bf(r, 10), bf(r, 5), bf(r, 6), v.le);
  lookup4(env, h, w, (int)bf(r, 11), (int)bf(r, 12), bf(r, 7), bf(r, 8),
          v.lm);

  v.ge = geom(bf(r, 2), bf(r, 3), bf(r, 4), wox, woy, woz, nx, ny, nz);
  v.fe = disney(v.a, v.rough, v.metal, v.ge);
  const float w_mis = pdf_e / (pdf_e + v.fe.pdf + 1e-9f);
  v.s_nee = w_mis / (pdf_e + 1e-9f);

  v.gb = geom(wnx, wny, wnz, wox, woy, woz, nx, ny, nz);
  v.fb = disney(v.a, v.rough, v.metal, v.gb);
  const float pdf_b = v.fb.pdf;
  const bool ok = pdf_b > 1e-6f;
  const float inv = 1.f / (pdf_b + 1e-6f);
  for (int c = 0; c < 3; ++c) {
    const float wc = ok ? v.fb.f[c] * inv : 0.f;
    const bool fin = isfinite(wc);
    v.w[c] = fin ? wc : 0.f;
    v.wraw_ok[c] = (ok && fin) ? inv : 0.f;  // d w / d fb
  }
  v.w_mis_b = pdf_b / (pdf_b + pdf_at + 1e-9f);
}

__global__ void shade_fwd_kernel(const float* __restrict__ env_g,
                                 const float* __restrict__ blob,
                                 const float* __restrict__ thr,
                                 const __half* __restrict__ nrm,
                                 const __nv_bfloat16* __restrict__ aux,
                                 const __nv_bfloat16* __restrict__ recb,
                                 float* __restrict__ thr_out,
                                 float* __restrict__ rad, int m, int h,
                                 int w) {
  extern __shared__ float env[];
  for (int i = threadIdx.x; i < h * w * 3; i += blockDim.x) env[i] = env_g[i];
  __syncthreads();
  for (int q = blockIdx.x * blockDim.x + threadIdx.x; q < m;
       q += gridDim.x * blockDim.x) {
    Vertex v;
    load_vertex(q, env, h, w, blob, thr, nrm, aux, recb, v);
    for (int c = 0; c < 3; ++c) {
      const float cn =
          v.g_nee ? v.t[c] * v.fe.f[c] * v.s_nee * v.le[c] : 0.f;
      const float cm =
          v.g_miss ? v.t[c] * v.w[c] * v.w_mis_b * v.lm[c] : 0.f;
      thr_out[3 * q + c] = v.t[c] * v.w[c];
      rad[3 * q + c] = cn + cm;
    }
  }
}

__global__ void shade_bwd_kernel(const float* __restrict__ env_g,
                                 const float* __restrict__ blob,
                                 const float* __restrict__ thr,
                                 const __half* __restrict__ nrm,
                                 const __nv_bfloat16* __restrict__ aux,
                                 const __nv_bfloat16* __restrict__ recb,
                                 const float* __restrict__ ct_thr,
                                 const float* __restrict__ ct_rad,
                                 float* __restrict__ d_blob,
                                 float* __restrict__ d_thr,
                                 float* __restrict__ d_le, int m, int h,
                                 int w) {
  extern __shared__ float env[];
  for (int i = threadIdx.x; i < h * w * 3; i += blockDim.x) env[i] = env_g[i];
  __syncthreads();
  for (int q = blockIdx.x * blockDim.x + threadIdx.x; q < m;
       q += gridDim.x * blockDim.x) {
    Vertex v;
    load_vertex(q, env, h, w, blob, thr, nrm, aux, recb, v);
    float ct_fe[3], ct_fb[3], da[3] = {0.f, 0.f, 0.f};
    float dr = 0.f, dm = 0.f;
    for (int c = 0; c < 3; ++c) {
      const float gt = ct_thr[3 * q + c];
      const float gr = ct_rad[3 * q + c];
      const float gn = v.g_nee ? gr : 0.f;
      const float gm = v.g_miss ? gr : 0.f;
      // miss term ((t*w)*w_mis_b)*lm and NEE term ((t*fe)*s_nee)*le
      const float ct_tw = gt + gm * v.lm[c] * v.w_mis_b;
      const float ct_tfe = gn * v.le[c] * v.s_nee;
      d_thr[3 * q + c] = ct_tw * v.w[c] + ct_tfe * v.fe.f[c];
      ct_fb[c] = ct_tw * v.t[c] * v.wraw_ok[c];
      ct_fe[c] = ct_tfe * v.t[c];
      d_le[6 * q + c] = gn * (v.t[c] * v.fe.f[c] * v.s_nee);
      d_le[6 * q + 3 + c] = gm * (v.t[c] * v.w[c] * v.w_mis_b);
    }
    disney_bwd(v.a, v.rough, v.metal, v.ge, v.fe, ct_fe, da, dr, dm);
    disney_bwd(v.a, v.rough, v.metal, v.gb, v.fb, ct_fb, da, dr, dm);
    float* o = d_blob + 5 * q;
    o[0] = da[0];
    o[1] = da[1];
    o[2] = da[2];
    o[3] = dr;
    o[4] = dm;
  }
}

int grid_for(int m) {
  const int g = (m + kThreads - 1) / kThreads;
  return g < 1 ? 1 : (g > 2112 ? 2112 : g);
}

}  // namespace

extern "C" int shade_bounce_fwd_launch(const float* env, const float* blob,
                                       const float* thr, const void* nrm,
                                       const void* aux, const void* recb,
                                       float* thr_out, float* rad, int m,
                                       int h, int w, cudaStream_t stream) {
  const size_t smem = sizeof(float) * h * w * 3;
  shade_fwd_kernel<<<grid_for(m), kThreads, smem, stream>>>(
      env, blob, thr, (const __half*)nrm, (const __nv_bfloat16*)aux,
      (const __nv_bfloat16*)recb, thr_out, rad, m, h, w);
  return (int)cudaGetLastError();
}

extern "C" int shade_bounce_bwd_launch(const float* env, const float* blob,
                                       const float* thr, const void* nrm,
                                       const void* aux, const void* recb,
                                       const float* ct_thr,
                                       const float* ct_rad, float* d_blob,
                                       float* d_thr, float* d_le, int m,
                                       int h, int w, cudaStream_t stream) {
  const size_t smem = sizeof(float) * h * w * 3;
  shade_bwd_kernel<<<grid_for(m), kThreads, smem, stream>>>(
      env, blob, thr, (const __half*)nrm, (const __nv_bfloat16*)aux,
      (const __nv_bfloat16*)recb, ct_thr, ct_rad, d_blob, d_thr, d_le, m, h,
      w);
  return (int)cudaGetLastError();
}
