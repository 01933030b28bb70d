"""The deterministic MaterialNet training step of materialist_tpu_torch,
on the CPU: ``ops/resize.py::bicubic_scale`` (DINOv2's pos-embed
interpolation as two fixed interpolation matrices) against the JAX
package's, in value and through its VJP, at the pos-embed shapes that the
trainers and inference reach; ``bilinear_align_corners``'s matrix
backward against the JAX package's VJP and ``F.interpolate``'s own; no
upsampling backward of ``F.interpolate`` in the graph of the training
loss; and ``models/train.py::make_train_step`` running each step under
deterministic algorithms (raising, not warning), with the caller's
setting restored after it, on error too.

Inputs are seeded numpy. Bound: 1e-6 of the largest value (the port
takes the JAX package's float32 sample positions and tap weights and
normalises them in float64)."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from materialist_tpu.ops import resize as jresize
from materialist_tpu_torch.models import dpt as tdpt
from materialist_tpu_torch.models import train as ttrain
from materialist_tpu_torch.ops import resize as tresize
from torch_matnet_common import TINY_TRAIN, nchw, seeded_batch

torch.set_num_threads(2)

# (in grid, out grid): the device trainer at 224×336, the native grid
# with the +0.1 offset, and a small one
POS_EMBED_SHAPES = [((37, 37), (16, 24)), ((37, 37), (37, 37)),
                    ((5, 5), (3, 4))]


def _scale(hw, out):
    return tuple((o + 0.1) / i for o, i in zip(out, hw))


@pytest.mark.parametrize("hw,out", POS_EMBED_SHAPES,
                         ids=["37to16x24", "37to37", "5to3x4"])
def test_bicubic_scale_value_and_vjp_match_jax(hw, out):
    r = np.random.default_rng(sum(out))
    x = r.normal(0, 0.02, hw + (24,)).astype(np.float32)
    s = _scale(hw, out)
    ref, vjp = jax.vjp(lambda a: jresize.bicubic_scale(a, s), jnp.asarray(x))
    ct = r.standard_normal(ref.shape).astype(np.float32)
    ref_grad = np.asarray(vjp(jnp.asarray(ct))[0])
    xt = torch.from_numpy(x.transpose(2, 0, 1)[None].copy()).requires_grad_()
    got = tresize.bicubic_scale(xt, s)
    got.backward(torch.from_numpy(ct.transpose(2, 0, 1)[None].copy()))
    got = got.detach().numpy()[0].transpose(1, 2, 0)
    grad = xt.grad.numpy()[0].transpose(1, 2, 0)
    assert got.shape == ref.shape == out + (24,)
    for a, b in ((got, np.asarray(ref)), (grad, ref_grad)):
        assert np.abs(a - b).max() <= 1e-6 * np.abs(b).max()


@pytest.mark.parametrize("shape,size", [((2, 8, 4, 6), (8, 12)),
                                        ((1, 4, 16, 24), (28, 42)),
                                        ((1, 2, 1, 5), (3, 7))],
                         ids=["fusion", "output", "one_row"])
def test_bilinear_align_corners_vjp_matches_jax(shape, size):
    """The DPT decoder's upsampling (the fusion blocks' ×2 and the output
    to the image size): the forward and its matrix backward against the
    JAX package's and against ``F.interpolate``'s autograd."""
    r = np.random.default_rng(size[0])
    x = r.standard_normal(shape).astype(np.float32)
    ct = r.standard_normal(shape[:2] + size).astype(np.float32)
    nhwc = (0, 2, 3, 1)
    ref, vjp = jax.vjp(lambda a: jresize.bilinear_align_corners(a, size),
                       jnp.asarray(x.transpose(nhwc)))
    ref_grad = np.asarray(vjp(jnp.asarray(ct.transpose(nhwc)))[0])
    xt = torch.from_numpy(x).requires_grad_()
    got = tresize.bilinear_align_corners(xt, size)
    got.backward(torch.from_numpy(ct))
    xf = torch.from_numpy(x).requires_grad_()
    torch.nn.functional.interpolate(xf, size=size, mode="bilinear",
                                    align_corners=True).backward(
        torch.from_numpy(ct))
    grad = xt.grad.numpy()
    for a, b in ((got.detach().numpy().transpose(nhwc), np.asarray(ref)),
                 (grad.transpose(nhwc), ref_grad), (grad, xf.grad.numpy())):
        assert np.abs(a - b).max() <= 1e-6 * np.abs(b).max()


def _backward_nodes(t):
    seen, todo, names = set(), [t.grad_fn], set()
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.add(type(fn).__name__)
        todo.extend(f for f, _ in fn.next_functions)
    return names


def test_no_upsample_backward_in_the_graph():
    """Neither ``bicubic_scale`` alone nor the tiny net's training loss
    at 28×42 (a 2×3 patch grid, so the pos-embed is interpolated) holds
    an ``UpsampleBicubic2D`` backward node, and the loss no upsampling
    backward of ``F.interpolate`` at all (``UpsampleBilinear2D``: its
    deterministic CUDA version is a sorted ``index_put_``)."""
    x = torch.randn(1, 8, 37, 37, requires_grad=True)
    own = _backward_nodes(tresize.bicubic_scale(x, _scale((37, 37),
                                                          (16, 24))))
    net = tdpt.MaterialNet(**TINY_TRAIN,
                           generator=torch.Generator().manual_seed(0))
    batch = nchw(seeded_batch(1))
    loss = ttrain.matnet_losses(net(batch["im"]), batch)["total"]
    whole = _backward_nodes(loss)
    assert len(whole) > 10
    for names in (own, whole):
        assert not [n for n in names if "Bicubic" in n], names
    assert not [n for n in whole if "Upsample" in n], whole


@pytest.mark.parametrize("caller", [(False, False), (True, True)],
                         ids=["off", "warn_only"])
def test_train_step_runs_deterministic_and_restores(caller):
    """The step's forward sees deterministic algorithms on and raising,
    without the NaN fill of new tensors; the caller's settings are back
    after a step and after a step that raises (a batch without depth: the
    losses raise after the forward)."""
    net = tdpt.MaterialNet(**TINY_TRAIN,
                           generator=torch.Generator().manual_seed(0))
    det = torch.utils.deterministic

    def setting():
        return (torch.are_deterministic_algorithms_enabled(),
                torch.is_deterministic_algorithms_warn_only_enabled(),
                det.fill_uninitialized_memory)
    seen = []
    net.register_forward_pre_hook(lambda m, a: seen.append(setting()))
    step = ttrain.scratch_step(net, 1e-4, 10)
    batch = nchw(seeded_batch(1))
    fill = det.fill_uninitialized_memory
    torch.use_deterministic_algorithms(caller[0], warn_only=caller[1])
    try:
        losses = step(batch)
        assert np.isfinite(float(losses["total"]))
        assert seen == [(True, False, False)]
        assert setting() == caller + (fill,)
        with pytest.raises(KeyError):
            step({k: v for k, v in batch.items() if k != "depth"})
        assert seen == [(True, False, False)] * 2
        assert setting() == caller + (fill,)
    finally:
        torch.use_deterministic_algorithms(False)


def test_step_on_the_card_needs_the_cublas_workspace(monkeypatch):
    """A step whose parameters lie on a CUDA device refuses to run unless
    ``CUBLAS_WORKSPACE_CONFIG`` is one of cuBLAS's deterministic
    settings; on the CPU it needs nothing."""
    on_card = [types.SimpleNamespace(is_cuda=True)]
    for value in (None, ":0:0"):
        if value is None:
            monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
        else:
            monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", value)
        with pytest.raises(RuntimeError, match="CUBLAS_WORKSPACE_CONFIG"):
            ttrain._check_cublas(on_card)
        ttrain._check_cublas([types.SimpleNamespace(is_cuda=False)])
    for value in ttrain.CUBLAS_DETERMINISTIC:
        monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", value)
        ttrain._check_cublas(on_card)
