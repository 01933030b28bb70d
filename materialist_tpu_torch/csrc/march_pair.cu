// Screen-space marches against the depth heightfield. march_pair_launch:
// the lobe ray (hit, pixel index, t) and the NEE shadow ray (shadowed) of
// one path vertex. march_single_launch: one ray per query (hit, pixel
// index, t), with a shadow_only mode that stops after the coarse scan; it
// is the march of a render without NEE.
//
// Replaces the Pallas kernels of materialist_tpu/ops/pallas/march_kernel.py
// (march_pair -> _march_pair_tpu, _make_pair_kernel, _march_one_v3, and
// march_fused -> _march_fused_tpu, _make_kernel). Both launches run the one
// kernel below, so they have the same bound.
//
// Bound on the H100: the schedulers' instruction rate, not latency. A ray
// moves 40 bytes in and 13 out and its table reads hit shared memory, but
// every march step is a projection with an IEEE division, two table
// coordinates, clamps and compares. What the build and the card say
// (nvcc 12.8 -Xptxas -v; NVIDIA H100 80GB HBM3 at 700 W, M = 4*512^2
// vertices of chip_smoke.py's seeded depth map): 55 registers, no spills;
// a coarse step is about 70 SASS instructions; with 3, 4 or 5 resident
// blocks of 256 threads an SM the launch takes the same 0.191 ms, with 6
// (40 registers) or 8 (32) it gets slower, so more warps in flight buy
// nothing. The first version of this kernel (run-time integer divisions,
// every loop at its full 56 steps a vertex) took 0.264 ms. What is left
// above the rays' own steps (two thirds of the full trip counts) is the
// spread of trip counts inside a warp: a warp runs as long as its slowest
// ray. What the design does:
//  - fewer instructions a step: the mip and fine factors are powers of two
//    (the wrapper raises on another), so a table coordinate is a shift; the
//    tracer's step counts (24/6 and 16/2) are template parameters, and the
//    geometry is a __grid_constant__ parameter, read from the constant bank;
//  - loops that stop when nothing they could change is read any more (each
//    exit says below why it is exact);
//  - the lobe and the shadow march of a vertex are two work items, taken by
//    different warps, so a warp's loop has one trip count and the two
//    chains of a vertex run side by side;
//  - a persistent grid (as many blocks as fit the card at once): a block
//    brings the two tables into shared memory once, with cp.async, and its
//    warps then walk over tiles of 32 rays;
//  - a tile's rays are staged through shared memory with coalesced loads,
//    and the origin is read with a period (o_rows), so the samples of a
//    pixel can share one origin row without a copy.
// Measured and left out: a tile's 32 flags packed into eight 32-bit stores
// (1% slower than a byte a lane), and more resident warps (above). The
// compiled-in step counts are worth 10% against the run-time instance.
// The mip and fine factors are the JAX package's _mip_factor/_fine_factor
// (they are semantics: other factors give other hits); t follows the
// shared exponential schedule t_lo * ratio^i by repeated multiplication,
// and the float operations keep the order of _march_one_v3 (the build has
// -fmad=false), so every output equals the full-trip-count loop's.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStage = 2 * 96;  // floats a warp stages: origin, direction

struct Geo {
  int h, w, mip_s, mh, mw, fine_s, fh, fw;  // mip_s, fine_s: log2 factors
  float focal, cx, cy, bias_lo, bias_hi, interval_frac;
};

// One of the two marches of a vertex.
struct Chain {
  const float* dir;
  int n_steps, fine_steps, shadow_only;
  float ratio;
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
  ui = __float2int_rd(uf + 0.5f);
  vi = __float2int_rd(vf + 0.5f);
  inside = (ui >= 0) && (ui < g.w) && (vi >= 0) && (vi < g.h) && (qz < 0.f);
}

// Cell of a table 2^s times coarser than the image. The shift floors where
// the reference's division by the factor floors too; below zero both land
// on the clamp's 0.
__device__ __forceinline__ int cell(int ui, int vi, int s, int th, int tw) {
  return clampi(vi >> s, 0, th - 1) * tw + clampi(ui >> s, 0, tw - 1);
}

// One march (coarse + optional fine); semantics of _march_one_v3. NS, FS:
// the step counts when they are compiled in, 0 for the run-time ones.
template <int NS, int FS>
__device__ __forceinline__ void march_one(
    const Geo& g, const float* mip, const float* fine, float t_lo, float ox,
    float oy, float oz, float dx, float dy, float dz, const Chain& c,
    bool& hit_out, int& idx_out, float& t_out) {
  const int n_steps = NS > 0 ? NS : c.n_steps;
  const int fine_steps = FS > 0 ? FS : c.fine_steps;
  const float ratio = c.ratio;
  int ui, vi;
  bool inside;
  project(g, ox, oy, oz, ui, vi, inside);
  const int start_cell = cell(ui, vi, g.mip_s, g.mh, g.mw);
  float t = t_lo, t_prev = t_lo;
  bool prev_cand = false;
  int edge_cnt = 0;
  float tb1 = t_lo, tc1 = t_lo, tb2 = t_lo, tc2 = t_lo;
  // what is read after the scan: tb1, tc1 (first rising edge), tb2, tc2
  // (second), and edge_cnt compared with 0 and 1; shadow_only reads the
  // first edge alone
  const int edges_read = c.shadow_only ? 1 : 2;
  for (int i = 0; i < n_steps; ++i) {
    const float qx = ox + t * dx;
    const float qy = oy + t * dy;
    const float qz = oz + t * dz;
    project(g, qx, qy, qz, ui, vi, inside);
    const int mi = cell(ui, vi, g.mip_s, g.mh, g.mw);
    const float ray_d = -qz;
    const bool cand =
        inside && (ray_d > mip[mi] * g.bias_lo) && (mi != start_cell);
    if (cand && !prev_cand) {
      if (edge_cnt == 0) {
        tb1 = t_prev;
        tc1 = t;
      } else {
        tb2 = t_prev;
        tc2 = t;
      }
      // exact: a later edge writes none of the values read, and edge_cnt
      // only grows
      if (++edge_cnt >= edges_read) break;
    }
    // exact: a ray that left the frustum before its first edge can have no
    // candidate any more, so no later step changes anything
    if (!inside && edge_cnt == 0) break;
    prev_cand = cand;
    t_prev = t;
    t = t * ratio;
  }
  if (c.shadow_only) {
    hit_out = edge_cnt > 0;
    idx_out = 0;
    t_out = tc1;
    return;
  }
  bool hit = false;
  float t_hit = tc1, excess_hit = 0.f, local_hit = 1.f;
  int idx_hit = 0;
  // exact: an interval without its edge has its gate closed and cannot
  // cross, and only the first crossing is kept
  for (int half = 0; half < 2 && half < edge_cnt && !hit; ++half) {
    const float lo_t = half ? tb2 : tb1;
    const float hi_t = (half ? tc2 : tc1) * ratio;
    for (int k = 0; k < fine_steps; ++k) {
      const float frac = ((float)k + 1.f) / (float)fine_steps;
      const float tt = lo_t + (hi_t - lo_t) * frac;
      const float qx = ox + tt * dx;
      const float qy = oy + tt * dy;
      const float qz = oz + tt * dz;
      project(g, qx, qy, qz, ui, vi, inside);
      const float surf = fine[cell(ui, vi, g.fine_s, g.fh, g.fw)];
      const float ray_d = -qz;
      if (inside && (surf < 1.0e29f) && (ray_d > surf * g.bias_hi)) {
        t_hit = tt;
        idx_hit = clampi(vi, 0, g.h - 1) * g.w + clampi(ui, 0, g.w - 1);
        excess_hit = ray_d - surf * g.bias_hi;
        local_hit = ray_d;
        hit = true;
        break;
      }
    }
  }
  const bool thin = excess_hit < g.interval_frac * fmaxf(local_hit, 1e-6f);
  hit_out = hit && thin;
  idx_out = idx_hit;
  t_out = t_hit;
}

// n floats of a table into shared memory: 16-byte cp.async where the
// source allows it, the rest by plain loads.
__device__ __forceinline__ void load_table(float* dst, const float* src,
                                           int n) {
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    done = n & ~3;
    for (int i = 4 * threadIdx.x; i < done; i += 4 * kThreads)
      __pipeline_memcpy_async(dst + i, src + i, 16);
  }
  for (int i = done + threadIdx.x; i < n; i += kThreads) dst[i] = src[i];
}

// Work item `it` of a warp's `round`-th turn: tile it / n_chains, and the
// chain alternates from turn to turn (the number of warps is even), so
// every warp takes long lobe marches and short shadow marches in turn.
template <int NS0, int FS0, int NS1, int FS1>
__global__ void __launch_bounds__(kThreads, 4) march_kernel(
    const float* __restrict__ origin, int o_rows,
    const float* __restrict__ mip_g, const float* __restrict__ fine_g,
    const float* __restrict__ t_lo_p, uint8_t* __restrict__ hit,
    int* __restrict__ idx, float* __restrict__ t, uint8_t* __restrict__ shad,
    int m, int n_chains, const __grid_constant__ Geo g,
    const __grid_constant__ Chain c0, const __grid_constant__ Chain c1) {
  extern __shared__ __align__(16) float sm[];
  const int mip_n = g.mh * g.mw, fine_n = g.fh * g.fw;
  float* mip = sm;
  float* fine = sm + ((mip_n + 3) & ~3);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* so = fine + ((fine_n + 3) & ~3) + warp * kStage;
  float* sd = so + 96;
  load_table(mip, mip_g, mip_n);
  load_table(fine, fine_g, fine_n);
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
  const float t_lo = *t_lo_p;
  const int n_warps = gridDim.x * kWarps;
  const int n_items = ((m + 31) >> 5) * n_chains;
  const int o_fl = 3 * o_rows;
  int round = 0;
  for (int it = blockIdx.x * kWarps + warp; it < n_items;
       it += n_warps, ++round) {
    const int tile = n_chains == 2 ? it >> 1 : it;
    const int chain = n_chains == 2 ? (it + round) & 1 : 0;
    const Chain& c = chain ? c1 : c0;
    const int q0 = tile << 5;
    const int cnt = min(32, m - q0);
    const int fo = 3 * (q0 % o_rows);
    __syncwarp();
    for (int j = lane; j < 3 * cnt; j += 32) {
      int f = fo + j;
      while (f >= o_fl) f -= o_fl;
      so[j] = origin[f];
      sd[j] = c.dir[3 * (size_t)q0 + j];
    }
    __syncwarp();
    if (lane < cnt) {
      const float ox = so[3 * lane], oy = so[3 * lane + 1],
                  oz = so[3 * lane + 2];
      const float dx = sd[3 * lane], dy = sd[3 * lane + 1],
                  dz = sd[3 * lane + 2];
      bool h;
      int ix;
      float tt;
      if (chain) {
        march_one<NS1, FS1>(g, mip, fine, t_lo, ox, oy, oz, dx, dy, dz, c1, h,
                            ix, tt);
        shad[q0 + lane] = h ? 1 : 0;
      } else {
        march_one<NS0, FS0>(g, mip, fine, t_lo, ox, oy, oz, dx, dy, dz, c0, h,
                            ix, tt);
        hit[q0 + lane] = h ? 1 : 0;
        idx[q0 + lane] = ix;
        t[q0 + lane] = tt;
      }
    }
  }
}

template <int NS0, int FS0, int NS1, int FS1>
int launch(const float* origin, int o_rows, const float* mip,
           const float* fine, const float* t_lo, uint8_t* hit, int* idx,
           float* t, uint8_t* shad, int m, int n_chains, const Geo& g,
           const Chain& c0, const Chain& c1, cudaStream_t stream) {
  auto kern = march_kernel<NS0, FS0, NS1, FS1>;
  const int smem = (int)sizeof(float) * (((g.mh * g.mw + 3) & ~3) +
                                         ((g.fh * g.fw + 3) & ~3) +
                                         kWarps * kStage);
  // the persistent grid: as many blocks as the card holds at once
  // (kept per calling thread for the device and table size it last saw)
  static thread_local int resident = 0, resident_smem = -1, resident_dev = -1;
  int dev = 0;
  cudaGetDevice(&dev);
  if (resident_smem != smem || resident_dev != dev) {
    int sms = 0, per_sm = 0;
    resident_dev = dev;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads,
                                                  smem);
    resident = sms * (per_sm < 1 ? 1 : per_sm);
    resident_smem = smem;
  }
  const int n_items = ((m + 31) >> 5) * n_chains;
  int grid = (n_items + kWarps - 1) / kWarps;
  grid = grid < 1 ? 1 : (grid > resident ? resident : grid);
  kern<<<grid, kThreads, smem, stream>>>(origin, o_rows, mip, fine, t_lo, hit,
                                         idx, t, shad, m, n_chains, g, c0,
                                         c1);
  return (int)cudaGetLastError();
}

int dispatch(const float* origin, int o_rows, const float* mip,
             const float* fine, const float* t_lo, uint8_t* hit, int* idx,
             float* t, uint8_t* shad, int m, int n_chains, const Geo& g,
             const Chain& c0, const Chain& c1, cudaStream_t stream) {
  // the tracer's step counts compiled in; any others at run time
  if (c0.n_steps == 24 && c0.fine_steps == 6 &&
      (n_chains == 1 || (c1.n_steps == 16 && c1.fine_steps == 2)))
    return launch<24, 6, 16, 2>(origin, o_rows, mip, fine, t_lo, hit, idx, t,
                                shad, m, n_chains, g, c0, c1, stream);
  return launch<0, 0, 0, 0>(origin, o_rows, mip, fine, t_lo, hit, idx, t,
                            shad, m, n_chains, g, c0, c1, stream);
}

Geo make_geo(int h, int w, int mip_s, int mh, int mw, int fine_s, int fh,
             int fw, float focal, float cx, float cy, float bias_lo,
             float bias_hi, float interval_frac) {
  // bias_lo/bias_hi are 1 -/+ bias_frac rounded once from double, as the
  // JAX kernel's weakly typed constants are
  return Geo{h,     w,  mip_s, mh,      mw,      fine_s,       fh, fw,
             focal, cx, cy,    bias_lo, bias_hi, interval_frac};
}

}  // namespace

// origin (o_rows, 3): ray q starts at row q % o_rows. mip_s, fine_s: log2
// of the mip and fine factors.
extern "C" int march_single_launch(
    const float* origin, const float* dir, const float* mip,
    const float* fine, const float* t_lo, uint8_t* hit, int* idx, float* t,
    int m, int o_rows, int h, int w, int mip_s, int mh, int mw, int fine_s,
    int fh, int fw, float focal, float cx, float cy, float bias_lo,
    float bias_hi, float interval_frac, int n_steps, int fine_steps,
    float ratio, int shadow_only, cudaStream_t stream) {
  const Geo g = make_geo(h, w, mip_s, mh, mw, fine_s, fh, fw, focal, cx, cy,
                         bias_lo, bias_hi, interval_frac);
  const Chain c0 = {dir, n_steps, fine_steps, shadow_only, ratio};
  return dispatch(origin, o_rows, mip, fine, t_lo, hit, idx, t, nullptr, m, 1,
                  g, c0, c0, stream);
}

extern "C" int march_pair_launch(
    const float* origin, const float* d_lobe, const float* d_nee,
    const float* mip, const float* fine, const float* t_lo, uint8_t* hit,
    int* idx, float* t, uint8_t* shad, int m, int o_rows, int h, int w,
    int mip_s, int mh, int mw, int fine_s, int fh, int fw, float focal,
    float cx, float cy, float bias_lo, float bias_hi, float interval_frac,
    int n_steps, int fine_steps, int s_steps, int s_fine_steps, float ratio,
    float s_ratio, int s_shadow_only, cudaStream_t stream) {
  const Geo g = make_geo(h, w, mip_s, mh, mw, fine_s, fh, fw, focal, cx, cy,
                         bias_lo, bias_hi, interval_frac);
  const Chain c0 = {d_lobe, n_steps, fine_steps, 0, ratio};
  const Chain c1 = {d_nee, s_steps, s_fine_steps, s_shadow_only, s_ratio};
  return dispatch(origin, o_rows, mip, fine, t_lo, hit, idx, t, shad, m, 2, g,
                  c0, c1, stream);
}
