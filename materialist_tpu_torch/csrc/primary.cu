// primary_state: the jittered primary vertex of a chunk (film jitter > 0).
//
// No Pallas kernel stands behind it: the JAX package builds the vertex from
// 3x3 shifted copies of the geometry maps, which XLA fuses
// (materialist_tpu/render/shader.py::_primary_state). The port's plain
// version (ops/kernels/primary.py::primary_state_plain) issued some 115
// launches for it, twice a chunk: a cat of the maps, a replicate pad and
// its copy, four bilinear taps of index arithmetic and gathers, the
// weighted sum, the normalisation and the camera ray.
//
// One thread a row (sample i, local pixel j of the film rows). It reads the
// row's two uniforms of the jitter draw and the four taps' distance, normal
// and validity from the unpadded maps, the replicate pad being clamped
// indices, and writes the row's geometric normal, position (optional),
// outgoing direction and validity, bit for bit as the plain version writes
// them on the card. So each step rounds where that chain of PyTorch
// operations does (-fmad=false): a division by a Python scalar is
// PyTorch's multiplication by the f32 reciprocal (inv_focal),
// torch.clamp_min keeps a NaN, the taps are summed t00 + t01 + t10 + t11
// and Σ v² over three columns adds the first and the third, then the
// second (PyTorch's reduction splits three columns over two lanes).
//
// Bound on the H100: device-memory bytes, 8 read and 25-37 written a row;
// the maps (17 B a pixel) stay in L2 while neighbouring rows share taps.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float clamp_min_keep_nan(float x, float lo) {
  return x != x ? x : fmaxf(x, lo);
}

__global__ void __launch_bounds__(kThreads) primary_state_kernel(
    const float* __restrict__ u, const float* __restrict__ dist,
    const float* __restrict__ normal, const unsigned char* __restrict__ valid,
    float* __restrict__ nrm0, float* __restrict__ pos0,
    float* __restrict__ wo0, unsigned char* __restrict__ valid0, int m,
    int n_loc, int off, int h, int w, float r, float cx, float cy,
    float inv_focal) {
  const int step = gridDim.x * blockDim.x;
  for (int q = blockIdx.x * blockDim.x + threadIdx.x; q < m; q += step) {
    const int base = off + q % n_loc;
    const int ub = base % w, vb = base / w;
    const float ju = (u[2 * (size_t)q] * 2.0f - 1.0f) * r;
    const float jv = (u[2 * (size_t)q + 1] * 2.0f - 1.0f) * r;
    const float cu = ((float)ub + 0.5f) + ju;
    const float cv = ((float)vb + 0.5f) + jv;
    const float fu = cu - 0.5f, fv = cv - 0.5f;
    const float u0 = floorf(fu), v0 = floorf(fv);
    const float wu = fu - u0, wv = fv - v0;
    const int du0 = min(max((int)u0 - ub, -1), 0);
    const int dv0 = min(max((int)v0 - vb, -1), 0);
    const float wgt[4] = {(1.0f - wu) * (1.0f - wv), wu * (1.0f - wv),
                          (1.0f - wu) * wv, wu * wv};
    float acc[4], wsum;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int row = min(max(vb + dv0 + (t >> 1), 0), h - 1);
      const int col = min(max(ub + du0 + (t & 1), 0), w - 1);
      const size_t p = (size_t)row * w + col;
      const float wk = wgt[t] * (valid[p] ? 1.0f : 0.0f);
      const float g[4] = {dist[p], normal[3 * p], normal[3 * p + 1],
                          normal[3 * p + 2]};
      if (t == 0) {
        wsum = wk;
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[c] = g[c] * wk;
      } else {
        wsum = wsum + wk;
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[c] = acc[c] + g[c] * wk;
      }
    }
    const float den = clamp_min_keep_nan(wsum, 1e-9f);
    const float d = acc[0] / den;
    const float n[3] = {acc[1] / den, acc[2] / den, acc[3] / den};
    const float nn = clamp_min_keep_nan(
        sqrtf((n[0] * n[0] + n[2] * n[2]) + n[1] * n[1]), 1e-9f);
    const float x = (cu - cx) * inv_focal;
    const float y = -(cv - cy) * inv_focal;
    // Σ d² of d = (x, y, -1): x², then (-1)², then y²
    const float nd =
        clamp_min_keep_nan(sqrtf((x * x + 1.0f) + y * y), 1e-9f);
    const size_t o = 3 * (size_t)q;
#pragma unroll
    for (int c = 0; c < 3; ++c) nrm0[o + c] = n[c] / nn;
    if (pos0 != nullptr) {
      pos0[o] = x * d;
      pos0[o + 1] = y * d;
      pos0[o + 2] = -d;
    }
    wo0[o] = -x / nd;
    wo0[o + 1] = -y / nd;
    wo0[o + 2] = 1.0f / nd;
    valid0[q] = wsum > 1e-6f;
  }
}

int grid_for(int m) {
  const int g = (m + kThreads - 1) / kThreads;
  // at most 16 blocks per SM of the H100's 132; the rest stride
  return g < 1 ? 1 : (g > 132 * 16 ? 132 * 16 : g);
}

}  // namespace

// u: (m, 2) uniforms of the jitter draw, row q = sample * n_loc + local
// pixel; dist, valid: (h, w); normal: (h, w, 3); nrm0, wo0: (m, 3); pos0:
// (m, 3) or null; valid0: (m,) bool. off: the film rows' first pixel id.
extern "C" int primary_state_launch(
    const float* u, const float* dist, const float* normal,
    const unsigned char* valid, float* nrm0, float* pos0, float* wo0,
    unsigned char* valid0, int m, int n_loc, int off, int h, int w, float r,
    float cx, float cy, float inv_focal, cudaStream_t stream) {
  primary_state_kernel<<<grid_for(m), kThreads, 0, stream>>>(
      u, dist, normal, valid, nrm0, pos0, wo0, valid0, m, n_loc, off, h, w,
      r, cx, cy, inv_focal);
  return (int)cudaGetLastError();
}
