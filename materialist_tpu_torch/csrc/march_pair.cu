// Screen-space marches against the depth heightfield. march_pair_launch:
// the lobe ray (hit, pixel index, t) and the NEE shadow ray (shadowed) of
// one path vertex in one pass. march_single_launch: one ray per query
// (hit, pixel index, t), with a shadow_only mode that stops after the
// coarse scan; it is the march of a render without NEE.
//
// Replaces the Pallas kernels of materialist_tpu/ops/pallas/march_kernel.py
// (march_pair -> _march_pair_tpu, _make_pair_kernel, _march_one_v3, and
// march_fused -> _march_fused_tpu, _make_kernel). Both launches share
// march_one and the table set-up below, so they have the same bound.
//
// Bound on the H100: neither bytes (40 B read, 13 B written per ray) nor
// FP32 rate; the march is a dependent chain of ~(n_steps + 2 fine_steps)
// projections per ray, each with one table read, so latency and occupancy
// bound it. The TPU kernel built each table read from broadcast-row lane
// gathers over (8,128) planes; here the min-depth mip (<= 1024 texels) and
// the mean-depth fine table (<= 4096 texels) sit in shared memory and one
// thread marches one ray, so a read is one shared-memory load. The mip and
// fine factors are the JAX package's _mip_factor/_fine_factor (they are
// semantics: other factors give other hits); t follows the shared
// exponential schedule t_lo * ratio^i by repeated multiplication, and the
// float operations keep the order of _march_one_v3.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct Geo {
  int h, w, mip_f, mh, mw, fine_f, fh, fw;
  float focal, cx, cy, bias_lo, bias_hi, interval_frac;
};

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return min(max(x, lo), hi);
}

__device__ __forceinline__ void project(const Geo& g, float qx, float qy,
                                        float qz, int& ui, int& vi,
                                        bool& inside) {
  const float inv = 1.f / fmaxf(-qz, 1e-6f);
  const float uf = g.cx + g.focal * qx * inv - 0.5f;
  const float vf = g.cy - g.focal * qy * inv - 0.5f;
  ui = (int)floorf(uf + 0.5f);
  vi = (int)floorf(vf + 0.5f);
  inside = (ui >= 0) && (ui < g.w) && (vi >= 0) && (vi < g.h) && (qz < 0.f);
}

// One march (coarse + optional fine); semantics of _march_one_v3.
__device__ void march_one(const Geo& g, const float* mip, const float* fine,
                          float t_lo, float ox, float oy, float oz, float dx,
                          float dy, float dz, int n_steps, int fine_steps,
                          float ratio, bool shadow_only, bool& hit_out,
                          int& idx_out, float& t_out) {
  int ui0, vi0;
  bool ins0;
  project(g, ox, oy, oz, ui0, vi0, ins0);
  const int start_cell = clampi(vi0 / g.mip_f, 0, g.mh - 1) * g.mw +
                         clampi(ui0 / g.mip_f, 0, g.mw - 1);
  float t = t_lo, t_prev = t_lo;
  bool prev_cand = false, exited = false;
  int edge_cnt = 0;
  float tb1 = t_lo, tc1 = t_lo, tb2 = t_lo, tc2 = t_lo;
  for (int i = 0; i < n_steps; ++i) {
    const float qx = ox + t * dx;
    const float qy = oy + t * dy;
    const float qz = oz + t * dz;
    int ui, vi;
    bool inside;
    project(g, qx, qy, qz, ui, vi, inside);
    const int mi = clampi(vi / g.mip_f, 0, g.mh - 1) * g.mw +
                   clampi(ui / g.mip_f, 0, g.mw - 1);
    const float min_d = mip[mi];
    const float ray_d = -qz;
    const bool cand = inside && (ray_d > min_d * g.bias_lo) &&
                      (mi != start_cell) && !exited;
    const bool rising = cand && !prev_cand;
    if (rising && edge_cnt == 0) {
      tb1 = t_prev;
      tc1 = t;
    }
    if (rising && edge_cnt == 1) {
      tb2 = t_prev;
      tc2 = t;
    }
    edge_cnt += rising ? 1 : 0;
    exited = exited || (!inside && edge_cnt == 0);
    prev_cand = cand;
    t_prev = t;
    t = t * ratio;
  }
  if (shadow_only) {
    hit_out = edge_cnt > 0;
    idx_out = 0;
    t_out = tc1;
    return;
  }
  bool hit = false;
  float t_hit = tc1, excess_hit = 0.f, local_hit = 1.f;
  int idx_hit = 0;
  for (int k = 0; k < 2 * fine_steps; ++k) {
    const bool second = k >= fine_steps;
    const float lo_t = second ? tb2 : tb1;
    const float hi_t = (second ? tc2 : tc1) * ratio;
    const bool gate = edge_cnt > (second ? 1 : 0);
    const float kk = (float)(second ? k - fine_steps : k);
    const float frac = (kk + 1.f) / (float)fine_steps;
    const float tt = lo_t + (hi_t - lo_t) * frac;
    const float qx = ox + tt * dx;
    const float qy = oy + tt * dy;
    const float qz = oz + tt * dz;
    int ui, vi;
    bool inside;
    project(g, qx, qy, qz, ui, vi, inside);
    const int fidx = clampi(vi / g.fine_f, 0, g.fh - 1) * g.fw +
                     clampi(ui / g.fine_f, 0, g.fw - 1);
    const float surf = fine[fidx];
    const float ray_d = -qz;
    const bool ok = inside && (surf < 1.0e29f);
    const bool crossing = ok && (ray_d > surf * g.bias_hi) && gate && !hit;
    if (crossing) {
      t_hit = tt;
      idx_hit = clampi(vi, 0, g.h - 1) * g.w + clampi(ui, 0, g.w - 1);
      excess_hit = ray_d - surf * g.bias_hi;
      local_hit = ray_d;
      hit = true;
    }
  }
  const bool thin = excess_hit < g.interval_frac * fmaxf(local_hit, 1e-6f);
  hit_out = hit && thin;
  idx_out = idx_hit;
  t_out = t_hit;
}

__global__ void march_pair_kernel(
    const float* __restrict__ origin, const float* __restrict__ d_lobe,
    const float* __restrict__ d_nee, const float* __restrict__ mip_g,
    const float* __restrict__ fine_g, const float* __restrict__ t_lo_p,
    uint8_t* __restrict__ hit, int* __restrict__ idx, float* __restrict__ t,
    uint8_t* __restrict__ shad, int m, Geo g, int n_steps, int fine_steps,
    float ratio, int s_steps, int s_fine_steps, float s_ratio,
    int s_shadow_only) {
  extern __shared__ float sm[];
  float* mip = sm;
  float* fine = sm + g.mh * g.mw;
  for (int i = threadIdx.x; i < g.mh * g.mw; i += blockDim.x) mip[i] = mip_g[i];
  for (int i = threadIdx.x; i < g.fh * g.fw; i += blockDim.x)
    fine[i] = fine_g[i];
  __syncthreads();
  const float t_lo = *t_lo_p;
  for (int q = blockIdx.x * blockDim.x + threadIdx.x; q < m;
       q += gridDim.x * blockDim.x) {
    const float ox = origin[3 * q], oy = origin[3 * q + 1],
                oz = origin[3 * q + 2];
    bool h;
    int ix;
    float tt;
    march_one(g, mip, fine, t_lo, ox, oy, oz, d_lobe[3 * q], d_lobe[3 * q + 1],
              d_lobe[3 * q + 2], n_steps, fine_steps, ratio, false, h, ix, tt);
    hit[q] = h ? 1 : 0;
    idx[q] = ix;
    t[q] = tt;
    march_one(g, mip, fine, t_lo, ox, oy, oz, d_nee[3 * q], d_nee[3 * q + 1],
              d_nee[3 * q + 2], s_steps, s_fine_steps, s_ratio,
              s_shadow_only != 0, h, ix, tt);
    shad[q] = h ? 1 : 0;
  }
}

__global__ void march_single_kernel(
    const float* __restrict__ origin, const float* __restrict__ dir,
    const float* __restrict__ mip_g, const float* __restrict__ fine_g,
    const float* __restrict__ t_lo_p, uint8_t* __restrict__ hit,
    int* __restrict__ idx, float* __restrict__ t, int m, Geo g, int n_steps,
    int fine_steps, float ratio, int shadow_only) {
  extern __shared__ float sm[];
  float* mip = sm;
  float* fine = sm + g.mh * g.mw;
  for (int i = threadIdx.x; i < g.mh * g.mw; i += blockDim.x) mip[i] = mip_g[i];
  for (int i = threadIdx.x; i < g.fh * g.fw; i += blockDim.x)
    fine[i] = fine_g[i];
  __syncthreads();
  const float t_lo = *t_lo_p;
  for (int q = blockIdx.x * blockDim.x + threadIdx.x; q < m;
       q += gridDim.x * blockDim.x) {
    bool h;
    int ix;
    float tt;
    march_one(g, mip, fine, t_lo, origin[3 * q], origin[3 * q + 1],
              origin[3 * q + 2], dir[3 * q], dir[3 * q + 1], dir[3 * q + 2],
              n_steps, fine_steps, ratio, shadow_only != 0, h, ix, tt);
    hit[q] = h ? 1 : 0;
    idx[q] = ix;
    t[q] = tt;
  }
}

Geo make_geo(int h, int w, int mip_f, int mh, int mw, int fine_f, int fh,
             int fw, float focal, float cx, float cy, float bias_lo,
             float bias_hi, float interval_frac) {
  // bias_lo/bias_hi are 1 -/+ bias_frac rounded once from double, as the
  // JAX kernel's weakly typed constants are
  Geo g;
  g.h = h;
  g.w = w;
  g.mip_f = mip_f;
  g.mh = mh;
  g.mw = mw;
  g.fine_f = fine_f;
  g.fh = fh;
  g.fw = fw;
  g.focal = focal;
  g.cx = cx;
  g.cy = cy;
  g.bias_lo = bias_lo;
  g.bias_hi = bias_hi;
  g.interval_frac = interval_frac;
  return g;
}

}  // namespace

extern "C" int march_single_launch(
    const float* origin, const float* dir, const float* mip,
    const float* fine, const float* t_lo, uint8_t* hit, int* idx, float* t,
    int m, int h, int w, int mip_f, int mh, int mw, int fine_f, int fh,
    int fw, float focal, float cx, float cy, float bias_lo, float bias_hi,
    float interval_frac, int n_steps, int fine_steps, float ratio,
    int shadow_only, cudaStream_t stream) {
  const Geo g = make_geo(h, w, mip_f, mh, mw, fine_f, fh, fw, focal, cx, cy,
                         bias_lo, bias_hi, interval_frac);
  const size_t smem = sizeof(float) * (mh * mw + fh * fw);
  int grid = (m + kThreads - 1) / kThreads;
  grid = grid < 1 ? 1 : grid;
  march_single_kernel<<<grid, kThreads, smem, stream>>>(
      origin, dir, mip, fine, t_lo, hit, idx, t, m, g, n_steps, fine_steps,
      ratio, shadow_only);
  return (int)cudaGetLastError();
}

extern "C" int march_pair_launch(
    const float* origin, const float* d_lobe, const float* d_nee,
    const float* mip, const float* fine, const float* t_lo, uint8_t* hit,
    int* idx, float* t, uint8_t* shad, int m, int h, int w, int mip_f,
    int mh, int mw, int fine_f, int fh, int fw, float focal, float cx,
    float cy, float bias_lo, float bias_hi, float interval_frac, int n_steps,
    int fine_steps, int s_steps, int s_fine_steps, float ratio, float s_ratio,
    int s_shadow_only, cudaStream_t stream) {
  const Geo g = make_geo(h, w, mip_f, mh, mw, fine_f, fh, fw, focal, cx, cy,
                         bias_lo, bias_hi, interval_frac);
  const size_t smem = sizeof(float) * (mh * mw + fh * fw);
  int grid = (m + kThreads - 1) / kThreads;
  grid = grid < 1 ? 1 : grid;
  march_pair_kernel<<<grid, kThreads, smem, stream>>>(
      origin, d_lobe, d_nee, mip, fine, t_lo, hit, idx, t, shad, m, g,
      n_steps, fine_steps, ratio, s_steps, s_fine_steps, s_ratio,
      s_shadow_only);
  return (int)cudaGetLastError();
}
