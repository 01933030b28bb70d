"""MaterialNet training of the port against the JAX package on the CPU:
the losses (with and without a seeded-LPIPS perceptual term), the frozen
set of partial fine-tuning, and one step of the frozen recipe from the
same parameters and batch; ``train`` on a seeded EXR tree.

The JAX side's parameters come from ``jax.eval_shape`` and seeded numpy
(a Flax ``init`` outside ``jit`` takes ~30 s here). Bounds: loss terms
within 1e-5 relative; parameters after the step within 1e-6 absolute
(AdamW's first step moves each trained parameter by about lr = 1e-4);
frozen parameters bit-unchanged."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from materialist_tpu.models import dpt as jdpt
from materialist_tpu.models import lpips as jlp
from materialist_tpu.models import train as jtrain
from materialist_tpu_torch.models import convert as tconvert
from materialist_tpu_torch.models import dpt as tdpt
from materialist_tpu_torch.models import lpips as tlp
from materialist_tpu_torch.models import train as ttrain
from torch_matnet_common import (TINY_TRAIN, lift_output_biases, nchw,
                                 seeded_batch, seeded_params)

torch.set_num_threads(2)


def _rel(a, b):
    a, b = (x.detach() if isinstance(x, torch.Tensor) else x for x in (a, b))
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-12)


def test_silog_loss_matches_jax():
    r = np.random.default_rng(0)
    pred = r.uniform(0.0, 3.0, (2, 1, 16, 16)).astype(np.float32)
    pred[0, 0, :2] = 0.0                      # clamped at 1e-4
    tgt = r.uniform(0.5, 3.0, (2, 1, 16, 16)).astype(np.float32)
    valid = (r.uniform(size=tgt.shape) < 0.8).astype(np.float32)
    got = ttrain.silog_loss(*(torch.from_numpy(x) for x in (pred, tgt, valid)))
    ref = jtrain.silog_loss(*(jnp.asarray(x.transpose(0, 2, 3, 1))
                              for x in (pred, tgt, valid)))
    assert _rel(got, ref) <= 1e-5
    same = ttrain.silog_loss(torch.from_numpy(tgt), torch.from_numpy(tgt),
                             torch.from_numpy(valid))
    assert float(same) < 1e-5


@pytest.fixture(scope="module")
def lpips_pair():
    """The same seeded LPIPS in both packages, as ``perceptual_fn``."""
    g = torch.Generator().manual_seed(3)
    net = tlp.LPIPS()
    with torch.no_grad():
        for name, p in net.named_parameters():
            if name.endswith("bias") or name.startswith("lin"):
                p.copy_(0.05 * torch.randn(p.shape, generator=g) + 0.02)
    params = jlp.convert_lpips_state_dict(net.state_dict())
    jnet = jlp.LPIPS()

    def jfn(pred, target):
        return jnp.mean(jnet.apply({"params": params}, pred, target,
                                   normalize=True))

    def tfn(pred, target):
        return torch.mean(net(pred, target, normalize=True))

    return jfn, tfn


@pytest.mark.parametrize("perceptual", [False, True])
def test_matnet_losses_match_jax(perceptual, lpips_pair):
    """Seeded prediction and target maps at 64×64 (LPIPS's AlexNet needs
    more than 31 rows)."""
    batch = seeded_batch(1, hw=(64, 64))
    pred = seeded_batch(2, hw=(64, 64))
    pred["depth"] = pred["depth"] * 1.3
    jfn, tfn = lpips_pair if perceptual else (None, None)
    ref = jtrain.matnet_losses({k: jnp.asarray(v) for k, v in pred.items()},
                               {k: jnp.asarray(v) for k, v in batch.items()},
                               jfn)
    got = ttrain.matnet_losses(nchw(pred), nchw(batch), tfn)
    assert set(got) == set(ref)
    for k in ref:
        assert _rel(got[k], ref[k]) <= 1e-5, (k, float(got[k]),
                                              float(ref[k]))
    if perceptual:
        plain = ttrain.matnet_losses(nchw(pred), nchw(batch))
        assert float(got["albedo"]) > float(plain["albedo"])


def test_trainable_names_match_freeze_labels():
    """The "train" leaves of the JAX package's freeze_labels, renamed by
    matnet_from_flax, are exactly the port's trainable parameters, at the
    vit-b width."""
    shapes = jax.eval_shape(lambda: jdpt.MaterialNet().init(
        jax.random.PRNGKey(0), jnp.zeros((1, 28, 28, 3))))["params"]
    labels = jtrain.freeze_labels(shapes)
    flags = jax.tree.map(lambda lab: np.float32(lab == "train"), labels)
    renamed = tconvert.matnet_from_flax(flags)
    train = {k for k, v in renamed.items() if float(v) == 1.0}
    tnet = tdpt.MaterialNet()
    assert set(renamed) == set(tnet.state_dict())
    assert ttrain.trainable_names(tnet) == train
    # depth: output_conv2 (2 convolutions); material: 4 layer*_rn,
    # refinenet1-3 (10 each), refinenet4 (6), output_conv1, output_conv2
    assert len(train) == 4 + (4 + 3 * 10 + 6 + 2 + 4)


@pytest.fixture(scope="module")
def frozen_step_case():
    """One step of the frozen recipe (lr 1e-4) in both packages from the
    same seeded parameters and batch."""
    batch = seeded_batch(4)
    jnet = jdpt.MaterialNet(**TINY_TRAIN)
    params = lift_output_biases(seeded_params(jnet, 5,
                                              jnp.asarray(batch["im"])))
    opt = jtrain.make_optimizer(params, lr=1e-4)
    step = jtrain.make_train_step(jnet, opt)
    jp = jax.tree.map(jnp.asarray, params)
    p2, _, jlosses = step(jp, opt.init(jp),
                          {k: jnp.asarray(v) for k, v in batch.items()})

    tnet = tdpt.MaterialNet(**TINY_TRAIN)
    tnet.load_state_dict(tconvert.matnet_from_flax(params))
    before = {k: v.clone() for k, v in tnet.state_dict().items()}
    tstep = ttrain.make_train_step(tnet, ttrain.make_optimizer(tnet, 1e-4))
    tlosses = tstep(nchw(batch))
    return (jlosses, tconvert.matnet_from_flax(jax.tree.map(np.asarray, p2)),
            tlosses, tnet, before)


def test_frozen_step_losses_match_jax(frozen_step_case):
    jl, _, tl, _, _ = frozen_step_case
    assert set(tl) == set(jl)
    for k in jl:
        assert np.isfinite(float(tl[k]))
        assert _rel(tl[k], jl[k]) <= 1e-5, (k, float(tl[k]), float(jl[k]))


def test_frozen_step_params_match_jax(frozen_step_case):
    _, ref, _, tnet, before = frozen_step_case
    train = ttrain.trainable_names(tnet)
    got = tnet.state_dict()
    moved = 0
    for k, v in got.items():
        if k in train:
            np.testing.assert_allclose(v.numpy(), ref[k].numpy(), rtol=0,
                                       atol=1e-6, err_msg=k)
            moved += int(not torch.equal(v, before[k]))
        else:
            assert torch.equal(v, before[k]), k
            assert not tnet.get_parameter(k).requires_grad
    assert moved == len(train)


def _exr_tree(root, h=28, w=42, n=4):
    from materialist_tpu_torch.io import exr as exr_io
    scene = root / "scene000"
    scene.mkdir()
    r = np.random.default_rng(6)
    for i in range(n):
        for name, arr in (("im", r.random((h, w, 3))),
                          ("albedo", r.random((h, w, 3))),
                          ("material", r.random((h, w, 3))),
                          ("depth", r.uniform(500, 3000, (h, w, 1))),
                          ("normal", r.standard_normal((h, w, 3)))):
            exr_io.write(str(scene / f"{i}_{name}.exr"),
                         arr.astype(np.float32), half=True)
    (root / "train.txt").write_text("scene000\n")
    return str(root)


def test_train_on_cpu(tmp_path, monkeypatch):
    """``train`` on a seeded 4-sample tree at 28×42, with the tiny net in
    place of the vit-b one (chip_smoke.py trains that on the card): two
    epochs of two steps, a checkpoint per epoch, frozen tensors
    unchanged."""
    monkeypatch.setattr(ttrain, "MaterialNet", functools.partial(
        tdpt.MaterialNet, **TINY_TRAIN))
    root = _exr_tree(tmp_path)
    params = tdpt.MaterialNet(
        **TINY_TRAIN, generator=torch.Generator().manual_seed(1)).state_dict()
    ckpt = str(tmp_path / "ckpt.npz")
    net, hist = ttrain.train(root, params=params, epochs=2, batch_size=2,
                             im_hw=(28, 42), save_path=ckpt,
                             return_history=True, device="cpu")
    assert len(hist) == 4 and np.isfinite(hist).all()
    train = ttrain.trainable_names(net)
    for k, v in net.state_dict().items():
        assert torch.equal(v, params[k]) == (k not in train), k
    with np.load(ckpt) as data:
        assert int(data["__step__"]) == 4


def test_train_refuses_cpu_without_request(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttrain.train(str(tmp_path))
