"""LPIPS-alex of the port against the JAX package's on the CPU, with
seeded weights (the published weights are not in the repository): the
port's state dict carried by the JAX package's converter
(``convert_lpips_state_dict``), the JAX parameters carried back by
``convert.lpips_from_flax``, and ``load_lpips`` on a state dict in the
``lpips`` package's layout.

Bounds: distances within 1e-5 relative (convolutions summed in another
order); 0 for identical images."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from materialist_tpu.models import lpips as jlp
from materialist_tpu_torch.models import convert as tconvert
from materialist_tpu_torch.models import lpips as tlp

torch.set_num_threads(2)


def _seeded_lpips(seed):
    """The port's LPIPS with seeded trunk biases and lin weights (some
    negative, which the forward clamps)."""
    g = torch.Generator().manual_seed(seed)
    net = tlp.LPIPS()
    with torch.no_grad():
        for name, p in net.named_parameters():
            if name.endswith("bias"):
                p.copy_(0.05 * torch.randn(p.shape, generator=g))
            elif name.startswith("lin"):
                p.copy_(0.1 * torch.randn(p.shape, generator=g) + 0.05)
    return net


def _images(seed, shape=(2, 64, 64, 3)):
    r = np.random.default_rng(seed)
    return (r.uniform(size=shape).astype(np.float32),
            r.uniform(size=shape).astype(np.float32))


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


@pytest.fixture(scope="module")
def jax_lpips():
    return jax.jit(jlp.LPIPS().apply, static_argnames="normalize")


@pytest.mark.parametrize("normalize", [True, False])
def test_lpips_matches_jax(jax_lpips, normalize):
    net = _seeded_lpips(0)
    params = jlp.convert_lpips_state_dict(net.state_dict())
    x, y = _images(1)
    if not normalize:
        x, y = 2 * x - 1, 2 * y - 1
    ref = np.asarray(jax_lpips({"params": params}, jnp.asarray(x),
                               jnp.asarray(y), normalize=normalize))
    with torch.no_grad():
        got = net(_nchw(x), _nchw(y), normalize=normalize).numpy()
    assert got.shape == ref.shape == (2,) and (ref > 0).all()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=0)
    with torch.no_grad():
        same = net(_nchw(x), _nchw(x), normalize=normalize).numpy()
    np.testing.assert_array_equal(same, 0.0)


def test_lpips_from_flax_matches_jax(jax_lpips):
    """JAX parameters, seeded with numpy, carried to the port."""
    r = np.random.default_rng(2)
    shapes = jax.eval_shape(lambda: jlp.LPIPS().init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
        jnp.zeros((1, 64, 64, 3))))["params"]
    params = jax.tree.map(lambda s: (r.normal(0, 0.1, s.shape) + (
        0.05 if len(s.shape) == 1 else 0.0)).astype(np.float32), shapes)
    net = tlp.LPIPS()
    net.load_state_dict(tconvert.lpips_from_flax(params))      # strict
    x, y = _images(3)
    ref = np.asarray(jax_lpips({"params": params}, jnp.asarray(x),
                               jnp.asarray(y), normalize=True))
    with torch.no_grad():
        got = net(_nchw(x), _nchw(y), normalize=True).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=0)


def test_load_lpips_package_layout(tmp_path, jax_lpips):
    """A state dict with only the keys the forward reads, in the ``lpips``
    package's names (``net.slice{k}.{idx}``, ``lin{i}.model.1.weight``),
    as ``perceptual_fn`` on (B, 3, H, W) maps in [0, 1]."""
    net = _seeded_lpips(4)
    sd = {k: v for k, v in net.state_dict().items()
          if k in tlp.required_keys()}
    assert len(sd) == 15
    path = str(tmp_path / "alex_full.pth")
    torch.save(sd, path)
    fn = tlp.load_lpips(path, device="cpu")
    x, y = _images(5)
    params = jlp.convert_lpips_state_dict(sd)
    ref = float(np.mean(jax_lpips({"params": params}, jnp.asarray(x),
                                  jnp.asarray(y), normalize=True)))
    with torch.no_grad():
        got = float(fn(_nchw(x), _nchw(y)))
        one = float(fn(_nchw(x)[0], _nchw(y)[0]))
    assert got == pytest.approx(ref, rel=1e-5)
    assert one > 0
    torch.save({k: v for k, v in sd.items() if "lin4" not in k}, path)
    with pytest.raises(KeyError, match="lin4"):
        tlp.load_lpips(path, device="cpu")


def test_lpips_fn_from_a_module_or_a_state_dict_equals_load_lpips(tmp_path):
    """``lpips_fn`` of a seeded module, of its state dict and
    ``load_lpips`` of that state dict saved give the same value; a module
    left in train mode is put in eval mode (its dropout off)."""
    net = _seeded_lpips(6)
    sd = {k: v for k, v in net.state_dict().items()
          if k in tlp.required_keys()}
    path = str(tmp_path / "alex_seeded.pth")
    torch.save(sd, path)
    x, y = _images(7)
    x, y = _nchw(x), _nchw(y)
    with torch.no_grad():
        from_file = float(tlp.load_lpips(path, device="cpu")(x, y))
        from_sd = float(tlp.lpips_fn(sd, device="cpu")(x, y))
        from_module = float(tlp.lpips_fn(net.train(), device="cpu")(x, y))
    assert from_file == from_sd == from_module > 0
    assert not net.training
    assert not any(p.requires_grad for p in net.parameters())
    with pytest.raises(KeyError, match="lin0"):
        tlp.lpips_fn({k: v for k, v in sd.items() if "lin0" not in k},
                     device="cpu")
