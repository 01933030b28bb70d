"""The from-scratch recipe and the checkpoint of the port against the JAX
package on the CPU: three steps of ``clip_by_global_norm`` then AdamW
under warm-up-cosine against the optax chain of the trainers (the clip
triggered and not), the schedule itself, and ``save_checkpoint`` read
back by both packages; then the two trainers' ``main`` on the CPU with
the tiny net.

Bounds: parameters after three steps within 1e-6 absolute, but for the
key slice of each attention's qkv bias, whose gradient is 0 up to rounding
(its last gradient must be under 1e-5 of the query bias's); the schedule
within 1e-7 relative at every step; forwards of a loaded checkpoint
within 1e-5 of the same package's forward of the same (f16-rounded)
weights, and within 1e-4 relative across the packages (LayerNorm)."""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from materialist_tpu.models import dpt as jdpt
from materialist_tpu.models import matnet as jmatnet
from materialist_tpu.models import train as jtrain
from materialist_tpu_torch.cli import train_matnet_device as tdev
from materialist_tpu_torch.cli import train_matnet_scratch as tscr
from materialist_tpu_torch.models import convert as tconvert
from materialist_tpu_torch.models import dpt as tdpt
from materialist_tpu_torch.models import matnet as tmatnet
from materialist_tpu_torch.models import train as ttrain
from torch_matnet_common import (TINY_TRAIN, lift_output_biases, nchw,
                                 seeded_batch, seeded_params)

torch.set_num_threads(2)
LR, WARMUP, DECAY = 1e-4, 2, 10


@pytest.mark.parametrize("lr,warmup,decay", [(LR, WARMUP, DECAY),
                                             (3e-4, 100, 300)],
                         ids=["test_chain", "trainers_300_steps"])
def test_schedule_matches_optax(lr, warmup, decay):
    ref = optax.warmup_cosine_decay_schedule(0.0, lr, warmup_steps=warmup,
                                             decay_steps=decay,
                                             end_value=0.1 * lr)
    got = ttrain.warmup_cosine_decay_schedule(0.0, lr, warmup, decay,
                                              0.1 * lr)
    for c in range(decay + 3):
        r = float(ref(jnp.int32(c)))
        assert abs(got(c) - r) <= 1e-7 * max(r, 1e-30), c
    assert got(0) == 0.0 and got(decay + 2) == pytest.approx(0.1 * lr)


@pytest.mark.parametrize("clip", [1.0, 1e6], ids=["clipped", "unclipped"])
def test_chain_arithmetic_matches_optax(clip):
    """The chain alone on the same seeded gradients (global norm about
    30): the clip, AdamW's moments, decay and bias corrections, and the
    schedule's learning rate at steps 0, 1, 2."""
    r = np.random.default_rng(11)
    shapes = {"a": (4, 5), "b": (7,), "c": (2, 3, 3)}
    params = {k: r.normal(0, 1, s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: r.normal(0, 5, s).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    sched = optax.warmup_cosine_decay_schedule(
        0.0, LR, warmup_steps=WARMUP, decay_steps=DECAY, end_value=0.1 * LR)
    opt = optax.chain(optax.clip_by_global_norm(clip),
                      optax.adamw(sched, weight_decay=0.01))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = opt.init(jp)
    for g in grads:
        upd, state = opt.update({k: jnp.asarray(v) for k, v in g.items()},
                                state, jp)
        jp = optax.apply_updates(jp, upd)

    tp = [torch.nn.Parameter(torch.from_numpy(params[k])) for k in shapes]
    topt = torch.optim.AdamW(tp, lr=LR, betas=ttrain.BETAS, eps=ttrain.EPS,
                             weight_decay=0.01)
    tsched = ttrain.warmup_cosine_decay_schedule(0.0, LR, WARMUP, DECAY,
                                                 0.1 * LR)
    for count, g in enumerate(grads):
        for p, k in zip(tp, shapes):
            p.grad = torch.from_numpy(g[k])
        norm = ttrain.clip_by_global_norm(tp, clip)
        assert (float(norm) >= clip) == (clip == 1.0)
        topt.param_groups[0]["lr"] = tsched(count)
        topt.step()
    for p, k in zip(tp, shapes):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]),
                                   rtol=0, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("clip", [1.0, 1e6], ids=["clipped", "unclipped"])
def test_scratch_chain_matches_optax(clip):
    """Three steps of the tiny net on three seeded batches, nothing
    frozen. At clip 1 its gradient norm (over 1) is clipped at every
    step. The seeded tiny net amplifies a parameter difference about 150×
    into its maps, so two trajectories that start 1e-7 apart can end a
    few 1e-6 apart at other seeds; the chain's arithmetic alone is held
    by the test above."""
    batches = [seeded_batch(10 + i) for i in range(3)]
    jnet = jdpt.MaterialNet(**TINY_TRAIN)
    params = lift_output_biases(seeded_params(
        jnet, 7, jnp.asarray(batches[0]["im"])))
    sched = optax.warmup_cosine_decay_schedule(
        0.0, LR, warmup_steps=WARMUP, decay_steps=DECAY, end_value=0.1 * LR)
    opt = optax.chain(optax.clip_by_global_norm(clip),
                      optax.adamw(sched, weight_decay=0.01))
    step = jtrain.make_train_step(jnet, opt)
    jp = jax.tree.map(jnp.asarray, params)
    state = opt.init(jp)
    for b in batches:
        jp, state, _ = step(jp, state, {k: jnp.asarray(v)
                                        for k, v in b.items()})
    ref = tconvert.matnet_from_flax(jax.tree.map(np.asarray, jp))

    tnet = tdpt.MaterialNet(**TINY_TRAIN)
    tnet.load_state_dict(tconvert.matnet_from_flax(params))
    if clip == 1.0:
        tstep = ttrain.scratch_step(tnet, LR, DECAY, warmup_steps=WARMUP)
    else:
        tstep = ttrain.make_train_step(
            tnet, ttrain.make_optimizer(tnet, LR, freeze=False),
            clip_norm=clip, schedule=ttrain.warmup_cosine_decay_schedule(
                0.0, LR, WARMUP, DECAY, 0.1 * LR))
    for b in batches:
        tstep(nchw(b))
        norm = torch.sqrt(sum(torch.sum(p.grad ** 2)
                              for p in tnet.parameters()))
        assert (abs(float(norm) - 1.0) < 1e-5) == (clip == 1.0)
    c = TINY_TRAIN["embed_dim"]
    for k, v in tnet.state_dict().items():
        assert tnet.get_parameter(k).requires_grad
        got, want = v.numpy(), ref[k].numpy()
        if k.endswith("attn.qkv.bias"):
            # the key bias: softmax is invariant to it, so its gradient is
            # 0 up to rounding noise, which Adam normalizes into steps of
            # any size up to lr in either package: held to the first
            # instead of to the JAX package's noise
            g = tnet.get_parameter(k).grad.abs()
            assert float(g[c:2 * c].max()) <= 1e-5 * float(g[:c].max()), k
            got, want = np.delete(got, np.s_[c:2 * c]), np.delete(
                want, np.s_[c:2 * c])
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6, err_msg=k)


def _rel_err(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-12))


@pytest.mark.parametrize("half", [False, True], ids=["f32", "f16"])
def test_checkpoint_loads_in_both(tmp_path, half):
    tnet = tdpt.MaterialNet(**TINY_TRAIN,
                            generator=torch.Generator().manual_seed(8))
    path = str(tmp_path / "ckpt.npz")
    ttrain.save_checkpoint(path, tnet, 7, config=tnet.encoder_config(),
                           half=half)
    if half:                      # the weights the file holds
        with torch.no_grad():
            for p in tnet.parameters():
                p.copy_(p.half().float())
    x = np.random.default_rng(9).random((1, 28, 42, 3)).astype(np.float32)
    with torch.no_grad():
        own = {k: v.numpy().transpose(0, 2, 3, 1)
               for k, v in tnet(nchw({"x": x})["x"]).items()}

    jparams, step, cfg = jtrain.load_checkpoint(path)
    assert step == 7 and cfg == json.loads(json.dumps(
        tnet.encoder_config()))
    jinf = jmatnet.MatNetInference(weights_path=path)
    assert jinf.net == jdpt.MaterialNet(**TINY_TRAIN)
    jref = jax.jit(jdpt.MaterialNet(**TINY_TRAIN).apply)(
        {"params": tconvert.matnet_to_flax(tnet.state_dict())},
        jnp.asarray(x))
    jgot = jinf._forward(jinf.params, jnp.asarray(x))

    tinf = tmatnet.MatNetInference(weights_path=path, device="cpu")
    with torch.no_grad():
        tgot = tinf.net(nchw({"x": x})["x"])
    for k in own:
        np.testing.assert_allclose(np.asarray(jgot[k]), np.asarray(jref[k]),
                                   rtol=0, atol=1e-5, err_msg=k)
        np.testing.assert_allclose(tgot[k].numpy().transpose(0, 2, 3, 1),
                                   own[k], rtol=0, atol=1e-5, err_msg=k)
        assert _rel_err(own[k], jgot[k]) < 1e-4, k


@pytest.fixture
def tiny_trainers(monkeypatch):
    """The trainers with the tiny net at 28×42 in place of the reduced
    net at their film sizes."""
    net = functools.partial(tdpt.MaterialNet, **TINY_TRAIN)
    monkeypatch.setattr(tdev, "REDUCED", TINY_TRAIN)
    monkeypatch.setattr(tdev, "IM_HW", (28, 42))
    monkeypatch.setattr(tscr, "IM_HW", (28, 42))
    return net


@pytest.mark.parametrize("trainer", ["device", "scratch"])
def test_trainer_main_on_cpu(tmp_path, tiny_trainers, trainer):
    """Both trainers end to end on the CPU: data, 3 steps, the f16
    checkpoint that ``MatNetInference`` rebuilds from its config, and the
    log with the held-out PSNR of every map."""
    out = tmp_path / trainer
    if trainer == "device":
        tdev.main([str(out), "--tuples", "4", "--eval-tuples", "2", "--spp",
                   "2", "--steps", "3", "--batch", "2", "--device", "cpu"])
    else:
        tscr.main([str(out), "--scenes", "1", "--per-scene", "4", "--spp",
                   "2", "--steps", "3", "--batch", "2", "--device", "cpu"])
    log = json.loads((out / "train_log.json").read_text())
    assert log["steps"] == 3
    assert set(log["heldout_psnr_db"]) == set(ttrain.MAP_KEYS)
    assert all(np.isfinite(h["total"]) for h in log["history"])
    inf = tmatnet.MatNetInference(
        weights_path=str(out / "matnet_scratch.npz"), device="cpu")
    assert inf.net.encoder_config() == tiny_trainers().encoder_config()
    with np.load(out / "matnet_scratch.npz") as data:
        assert data["['pretrained']['pos_embed']"].dtype == np.float16


def test_trainers_refuse_cpu_without_request(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (tdev.main, tscr.main):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main([str(tmp_path / "out"), "--steps", "1"])
