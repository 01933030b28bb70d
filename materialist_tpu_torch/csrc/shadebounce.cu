// Fused shade of one path vertex and its adjoint: two Disney BRDF
// evaluations (NEE direction and lobe direction), two bilinear emitter
// fetches from the recorded tap coords, balance-heuristic MIS, and the
// (throughput', radiance delta) update; the backward emits d_blob (albedo,
// roughness, metallic), d_throughput and, where the caller asks for it,
// d_env, the emitter table's gradient (H, W, 3).
//
// Replaces the Pallas kernels of materialist_tpu/ops/pallas/shadebounce.py
// (_fwd_call/_make_fwd_kernel and _bwd_call/_make_bwd_kernel of
// shade_bounce_fused; the math is _bounce_math and _disney_soa) and the
// envmap gradient that follows the backward there (_denv_from_dle).
//
// Bound on the H100: device-memory bytes. Per vertex the forward reads
// 80 B (blob 20, throughput 12, f16 normal 6, bf16 aux 16, bf16 record 26)
// and writes 24 B against ~250 FP32 operations; the backward reads 104 B
// and writes 32 B (d_blob, d_throughput). The TPU kernel repacked every
// input into (C, 8, 128) planes in device memory before the call and ran
// the adjoint as an in-kernel jax.vjp; here one thread shades one vertex
// straight from the recorded bf16/f16 rows (no repacking pass), the emitter
// (<= 64x64x3 f32) sits in shared memory, and the adjoint is derived by
// hand (its plain PyTorch transcription, shade_bounce_bwd_explicit, is held
// against torch.autograd of the forward in the tests). pdf_b and pdf_b_at_e
// are detached; a gated-off term contributes exactly zero value and zero
// cotangent even where it would be inf/NaN; the nan_to_num of the lobe
// weight passes its cotangent only where the weight was finite.
//
// d_env is accumulated here, not contracted on tensor cores. The TPU
// kernel wrote each vertex's two fetch cotangents (d_le, 24 B) and a
// one-hot contraction on the MXU summed them afterwards, because a tap
// scatter was VPU-bound there. That contraction has 1,536 output bins
// (16x32x3), a contraction length of M and no reuse of either operand:
// on this card it is bound by the bytes of its one-hot planes, far from
// the tensor cores. Here each look's cotangent goes to its 4 bilinear taps
// (u wraps at the seam, v clamps at the pole: both v taps of a pole row
// land on one bin) in a table in shared memory beside the emitter copy,
// and each block adds its nonzero bins into d_env with global float
// atomics at its end: d_le never reaches device memory, and gated-off
// looks add nothing. NEE directions crowd onto the sampler's bright
// texels and escaped rays of one warp see nearly the same sky, so many
// lanes of a warp hit one bin: the lanes that share a look's base tap are
// grouped with __match_any_sync and their 12 tap values summed by
// shuffles in log2(group) steps, and only the group's lowest lane adds.
// Float atomics on shared memory are compare-and-swap loops on sm_90a,
// so each warp adds into a table of its own, without atomics (a bin is
// 4 floats, one 16-byte access); the block's tables are summed at the
// flush. With d_env the launch is one wave of resident blocks, three to
// an SM, so each block zeroes and flushes its tables once. An emitter of
// more than 548 texels (16x32 has 512; the kernels take up to 64x64),
// whose 8 tables would not leave room for 3 blocks, keeps one table for
// the block, added to with shared atomics. The global atomics add the
// blocks in an order that changes from run to run, so d_env's last bits
// do too, as the step's already do through C' (csrc/rowops.cu).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kPi = 3.14159265358979323846f;
constexpr float kInvPi = 0.318309886183790671538f;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// blocks of B' on an SM: the register cap this sets (80 a thread where
// it would take 96, a few bytes spilled) makes it faster, with d_env or
// without
constexpr int kBwdBlocksPerSm = 3;
// a table per warp where the emitter and the tables leave room for
// kBwdBlocksPerSm blocks on an SM
constexpr int kPerWarpSmem = 75 * 1024;

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

// Sums each x[k] over the lanes of the warp whose key is this lane's
// (peers: __match_any_sync's mask of them); the lowest lane of each group
// ends with its group's sums. A pairwise tree in the order of the lanes,
// so a group of g lanes takes ceil(log2 g) steps and a lane alone none.
// Every lane of the warp calls it.
template <int N>
__device__ __forceinline__ void reduce_peers(unsigned peers, float (&x)[N]) {
  const int lane = threadIdx.x & 31;
  int rank = __popc(peers & ((1u << lane) - 1u));
  unsigned above = peers & (0xfffffffeu << lane);
  while (__any_sync(0xffffffffu, above != 0u)) {
    const int next = __ffs(above);  // 1 + the lane of the next peer, or 0
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const float t = __shfl_sync(0xffffffffu, x[k], (next - 1) & 31);
      if (next) x[k] += t;
    }
    // the peers of odd rank are summed into the one below them
    above &= ~__ballot_sync(0xffffffffu, rank & 1);
    rank >>= 1;
  }
}

// Adds one look's fetch cotangent ct[3] to its 4 bilinear taps (those of
// lookup4) in tbl. A lane with on == false adds nothing. Every lane of the
// warp calls it. per_warp: tbl is this warp's own table, added to without
// atomics; else the block's, added to with shared atomics.
__device__ __forceinline__ void scatter_look(float* tbl, bool per_warp,
                                             int h, int w, bool on, int u0,
                                             int v0, float du, float dv,
                                             const float ct[3]) {
  const float wt[4] = {(1.f - du) * (1.f - dv), du * (1.f - dv),
                       (1.f - du) * dv, du * dv};
  float x[12];
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int c = 0; c < 3; ++c) x[3 * t + c] = on ? wt[t] * ct[c] : 0.f;
  const unsigned peers = __match_any_sync(0xffffffffu, on ? v0 * w + u0 : -1);
  reduce_peers(peers, x);
  const bool lead = on && __ffs(peers) - 1 == (int)(threadIdx.x & 31);
  const int u1 = (u0 + 1 >= w) ? 0 : u0 + 1;
  const int v1 = min(v0 + 1, h - 1);
  const int bin[4] = {v0 * w + u0, v0 * w + u1, v1 * w + u0, v1 * w + u1};
  if (per_warp) {
    // The leaders' base taps differ, and so do their bins of each tap:
    // u1 and v1 follow u0 and v0 one to one, but at the pole, where both
    // v taps land on v0's bins. Fold those into the v0 taps first; then
    // one tap at a time, a plain add, and the warp syncs before the next.
    const bool pole = v1 == v0;
    if (pole)
#pragma unroll
      for (int c = 0; c < 6; ++c) x[c] += x[6 + c];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      if (lead && (t < 2 || !pole)) {
        float4* p = reinterpret_cast<float4*>(tbl) + bin[t];
        float4 a = *p;
        a.x += x[3 * t];
        a.y += x[3 * t + 1];
        a.z += x[3 * t + 2];
        *p = a;
      }
      __syncwarp();
    }
  } else if (lead) {
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int c = 0; c < 3; ++c) atomicAdd(&tbl[4 * bin[t] + c], x[3 * t + c]);
  }
}

// d_env == nullptr: no emitter gradient (no table, no taps).
__global__ void __launch_bounds__(kThreads, kBwdBlocksPerSm)
shade_bwd_kernel(const float* __restrict__ env_g,
                                 const float* __restrict__ blob,
                                 const float* __restrict__ thr,
                                 const __half* __restrict__ nrm,
                                 const __nv_bfloat16* __restrict__ aux,
                                 const __nv_bfloat16* __restrict__ recb,
                                 const float* __restrict__ ct_thr,
                                 const float* __restrict__ ct_rad,
                                 float* __restrict__ d_blob,
                                 float* __restrict__ d_thr,
                                 float* __restrict__ d_env, int m, int h,
                                 int w, bool per_warp) {
  extern __shared__ float4 smem4[];
  const int n_bins = h * w, n_env = n_bins * 3;
  // this block's share of d_env, 4 floats a bin (rgb and a pad, so that a
  // bin is one 16-byte access): a table per warp, or one for the block;
  // then the emitter
  float* tbl = reinterpret_cast<float*>(smem4);
  const bool want_env = d_env != nullptr;
  const int n_tbl = want_env ? (per_warp ? kWarps : 1) : 0;
  float* env = tbl + 4 * n_bins * n_tbl;
  for (int i = threadIdx.x; i < n_env; i += blockDim.x) env[i] = env_g[i];
  for (int i = threadIdx.x; i < n_bins * n_tbl; i += blockDim.x)
    smem4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  float* own = tbl + (per_warp ? (threadIdx.x >> 5) * 4 * n_bins : 0);
  __syncthreads();
  // whole warps walk the rows together: the taps' shuffles need every lane
  for (int q0 = blockIdx.x * blockDim.x; q0 < m;
       q0 += gridDim.x * blockDim.x) {
    const int q = q0 + threadIdx.x;
    float ct_le[3] = {0.f, 0.f, 0.f}, ct_lm[3] = {0.f, 0.f, 0.f};
    bool on_e = false, on_m = false;
    if (q < m) {
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
        ct_le[c] = gn * (v.t[c] * v.fe.f[c] * v.s_nee);
        ct_lm[c] = gm * (v.t[c] * v.w[c] * v.w_mis_b);
      }
      on_e = v.g_nee;
      on_m = v.g_miss;
      disney_bwd(v.a, v.rough, v.metal, v.ge, v.fe, ct_fe, da, dr, dm);
      disney_bwd(v.a, v.rough, v.metal, v.gb, v.fb, ct_fb, da, dr, dm);
      float* o = d_blob + 5 * q;
      o[0] = da[0];
      o[1] = da[1];
      o[2] = da[2];
      o[3] = dr;
      o[4] = dm;
    }
    if (want_env) {
      const __nv_bfloat16* r = recb + 13 * (q < m ? q : 0);
      scatter_look(own, per_warp, h, w, on_e, (int)bf(r, 9), (int)bf(r, 10),
                   bf(r, 5), bf(r, 6), ct_le);
      scatter_look(own, per_warp, h, w, on_m, (int)bf(r, 11),
                   (int)bf(r, 12), bf(r, 7), bf(r, 8), ct_lm);
    }
  }
  if (!want_env) return;
  __syncthreads();
  for (int i = threadIdx.x; i < n_env; i += blockDim.x) {
    const int j = 4 * (i / 3) + i % 3;
    float a = tbl[j];
    for (int k = 1; k < n_tbl; ++k) a += tbl[k * 4 * n_bins + j];
    if (a != 0.f) atomicAdd(d_env + i, a);
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

// d_env: nullptr for no emitter gradient, else zeros on entry.
extern "C" int shade_bounce_bwd_launch(const float* env, const float* blob,
                                       const float* thr, const void* nrm,
                                       const void* aux, const void* recb,
                                       const float* ct_thr,
                                       const float* ct_rad, float* d_blob,
                                       float* d_thr, float* d_env, int m,
                                       int h, int w, cudaStream_t stream) {
  const size_t table = sizeof(float4) * h * w;
  const bool per_warp =
      d_env != nullptr && kWarps * table + 3 * h * w * 4 <= kPerWarpSmem;
  const size_t smem = sizeof(float) * h * w * 3 +
                      (d_env == nullptr ? 0 : (per_warp ? kWarps : 1) * table);
  if (smem > 48 * 1024) {  // beyond the default: opt in
    const cudaError_t e = cudaFuncSetAttribute(
        shade_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int blocks = grid_for(m);
  if (d_env != nullptr) {
    // one wave of resident blocks: each block zeroes and flushes its
    // tables once
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, shade_bwd_kernel, kThreads, smem);
    if (e != cudaSuccess) return (int)e;
    const int wave = per_sm * sms > 0 ? per_sm * sms : 1;
    if (blocks > wave) blocks = wave;
  }
  shade_bwd_kernel<<<blocks, kThreads, smem, stream>>>(
      env, blob, thr, (const __half*)nrm, (const __nv_bfloat16*)aux,
      (const __nv_bfloat16*)recb, ct_thr, ct_rad, d_blob, d_thr, d_env, m, h,
      w, per_warp);
  return (int)cudaGetLastError();
}
