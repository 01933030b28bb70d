"""The port's paired march (plain version of kernel A:
render/screenspace.py::march_mip twice) against the JAX package's
march_pair on the CPU. Tolerance: >= 99.9% of hit / idx / shadowed flags
equal (last-ulp float differences can flip a crossing at a silhouette)
and t within 1e-4 where both hit the same pixel."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from materialist_tpu.camera import Camera as JCam
from materialist_tpu.ops.pallas.march_kernel import march_pair as jpair
from materialist_tpu.render.scene import make_gbuffer as jmk
from materialist_tpu_torch.camera import Camera
from materialist_tpu_torch.ops.kernels import march as mk
from materialist_tpu_torch.render.scene import make_gbuffer

torch.set_num_threads(2)


def _scene(res, seed):
    rng = np.random.default_rng(seed)
    depth = (2.0 + 0.2 * rng.uniform(size=(res, res))).astype(np.float32)
    for _ in range(5):
        r0, c0 = rng.integers(0, res - 16, 2)
        hh, ww = rng.integers(4, 16, 2)
        depth[r0:r0 + hh, c0:c0 + ww] -= rng.uniform(0.3, 0.9)
    mask = np.zeros((res, res), bool)
    mask[: res // 8, : res // 4] = True
    return depth, mask


@pytest.mark.parametrize("seed,shadow_fine", [(0, 2), (1, 0)])
def test_march_pair_matches_jax(seed, shadow_fine):
    res, s = 64, 2
    depth, mask = _scene(res, seed)
    gj = jmk(jnp.asarray(depth), JCam(res, res), flip_depth=False, mask=mask)
    gt = make_gbuffer(depth, Camera(res, res), flip_depth=False, mask=mask)
    rng = np.random.default_rng(seed + 10)
    n = res * res

    def hemi(nrm):
        v = rng.normal(size=(s, n, 3)).astype(np.float32)
        v /= np.linalg.norm(v, axis=-1, keepdims=True)
        flip = np.sum(v * nrm, -1, keepdims=True) < 0
        return np.where(flip, -v, v).astype(np.float32)

    nrm = np.asarray(gj.normal_geo).reshape(1, n, 3)
    origin = np.broadcast_to(np.asarray(gj.position).reshape(1, n, 3),
                             (s, n, 3)).astype(np.float32)
    dl, dn = hemi(nrm), hemi(nrm)
    kw = dict(n_steps=24, fine_steps=6, shadow_steps=16,
              shadow_fine_steps=shadow_fine, interval_frac=0.05)
    hj, sj = jpair(JCam(res, res), gj.dist, gj.valid, jnp.asarray(origin),
                   jnp.asarray(dl), jnp.asarray(dn), **kw)
    tab = mk.march_tables(gt.dist, gt.valid)
    ht, st = mk.march_pair(Camera(res, res), tab, torch.from_numpy(origin),
                           torch.from_numpy(dl), torch.from_numpy(dn), **kw)
    for name, a, b in (("hit", hj.hit, ht.hit), ("idx", hj.idx, ht.idx),
                       ("shadowed", sj, st)):
        agree = float(np.mean(np.asarray(a) == b.numpy()))
        assert agree >= 0.999, f"{name} agreement {agree:.5f}"
    both = np.asarray(hj.hit) & ht.hit.numpy() & (np.asarray(hj.idx)
                                                  == ht.idx.numpy())
    assert both.mean() > 0.05          # the scene exercises real hits
    np.testing.assert_allclose(ht.t.numpy()[both], np.asarray(hj.t)[both],
                               atol=1e-4)


def test_march_factors_match_jax():
    from materialist_tpu.ops.pallas import march_kernel as jmkern
    for h, w in ((32, 32), (64, 64), (512, 512), (256, 512), (1024, 1024)):
        assert mk._mip_factor(h, w) == jmkern._mip_factor(h, w)
        assert mk._fine_factor(h, w) == jmkern._fine_factor(h, w)
