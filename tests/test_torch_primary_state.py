"""The jittered primary vertex (``ops/kernels/primary.py``, kernel P) on the
CPU: ``render/shader.py::_primary_state``, which takes the plain version
here, equals the JAX package's ``_primary_state`` element for element on
the same G-buffer and key (valid0 and pos0 bit for bit; the two unit
vectors within 4 ulps, since XLA's CPU norm sums Σ v² in its own order),
over a whole film and a slice at its top and at its bottom edge, 4 and 8
samples, jitter 0.5 and 0.25, invalid pixels at the border and inside,
and a width that is not a multiple of 32; the CPU counts no launch of P.
The kernel itself is held to the plain version on the card by
``tests/test_torch_kernels_cuda.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from materialist_tpu.camera import Camera as JCam
from materialist_tpu.render import shader as jsh
from materialist_tpu.render.scene import GBuffer as JGBuffer
from materialist_tpu_torch import rng
from materialist_tpu_torch.camera import Camera
from materialist_tpu_torch.ops.kernels import _lib
from materialist_tpu_torch.render import shader
from materialist_tpu_torch.render.scene import make_gbuffer

H = 24

# (width, film rows (row0, n_rows) or None for the whole film, samples,
# jitter, lattice streams)
CASES = {
    "whole_w37_s4_r05": (37, None, 4, 0.5, True),
    "whole_w37_s8_r025": (37, None, 8, 0.25, True),
    "top_w37_s8_r05": (37, (0, 5), 8, 0.5, True),
    "bottom_w37_s4_r025": (37, (H - 5, 5), 4, 0.25, True),
    "bottom_w64_s8_r05": (64, (H - 3, 3), 8, 0.5, True),
    "whole_w37_s4_iid": (37, None, 4, 0.5, False),
}


def _gbuffer(w):
    """A seeded depth map of two steps, with invalid pixels along the
    left column, the top row's first pixels, the last column and a block
    inside."""
    g = torch.Generator().manual_seed(w)
    depth = 2.0 + 0.3 * torch.rand((H, w), generator=g)
    depth[5:15, 8:22] -= 0.7
    mask = torch.zeros((H, w))
    mask[:, 0] = 1
    mask[0, :6] = 1
    mask[:, -1] = 1
    mask[10:13, 20:24] = 1
    return make_gbuffer(depth, Camera(H, w), flip_depth=False, mask=mask)


@pytest.mark.parametrize("case", list(CASES))
def test_primary_state_equals_jax(case):
    w, rows, s, r, lds = CASES[case]
    gb = _gbuffer(w)
    assert not gb.valid[:, 0].any() and gb.valid[H // 2, w // 2]
    cam = Camera(H, w)
    film = None if rows is None else shader.FilmSlice(*rows)
    cfg = shader.RenderConfig(film_jitter=r, lds=lds)
    _lib.reset_launches()
    got = shader._primary_state(rng.key(7), cfg, cam, gb, s, film)
    assert _lib.LAUNCHES["primary_state"] == 0

    jgb = JGBuffer(*[jnp.asarray(t.numpy()) for t in gb])
    want = jsh._primary_state(
        jax.random.PRNGKey(7), jsh.RenderConfig(film_jitter=r, lds=lds),
        JCam(H, w), jgb, s, None if rows is None else jsh.FilmSlice(*rows))
    n_loc = (H if rows is None else rows[1]) * w
    for name, a, b, ulps in zip(("nrm_geo0", "pos0", "wo0", "valid0"), got,
                                want, (4, 0, 4, 0)):
        a, b = a.numpy(), np.array(b)
        assert a.shape == b.shape == ((s, n_loc, 3) if b.ndim == 3
                                      else (s, n_loc)), name
        assert a.dtype == b.dtype, name
        if ulps:
            gap = np.abs(a.view(np.int32).astype(np.int64)
                         - b.view(np.int32).astype(np.int64))
            gap[(a == 0) & (b == 0)] = 0       # +0 and -0
            assert gap.max() <= ulps, name
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)
    # invalid pixels inside and at the border leave some samples invalid
    assert 0 < got[3].sum() < got[3].numel()
