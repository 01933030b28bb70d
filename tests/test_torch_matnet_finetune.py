"""The port's MaterialNet fine-tuning step against the benchmark's plain
reference (``perfbench/reference/matnet.py``) on the CPU: a small net that
keeps every kind of layer (embed 64, 4 layers of 4 heads, features 16,
out_channels (8, 16, 32, 64), each encoder layer a level of the heads),
seeded as the benchmark seeds it (``perfbench/loops/finetune.py``), batch 2
at 518², the pos-embed's native grid.

The five maps, each loss term and the total, the trained tensors'
gradients under the freeze, the batch each step draws, and AdamW's
updates. A control, the port's forward in bfloat16, must fail the maps'
tolerance.
"""

import statistics

import pytest
import torch

from materialist_tpu_torch import rng
from materialist_tpu_torch.cli.train_matnet_device import make_device_step
from materialist_tpu_torch.models import train as T
from materialist_tpu_torch.models.lpips import lpips_fn
from perfbench.loops import finetune as bench
from perfbench.reference import matnet as ref

torch.set_num_threads(2)

SMALL = dict(embed_dim=64, enc_depth=4, num_heads=4, features=16,
             out_channels=[8, 16, 32, 64], layer_idx=[0, 1, 2, 3],
             image=518, batch=2, tuples=3, lr=1e-4, weight_decay=0.01)
SEED = 5
# a map's largest gap over its largest value: the two compute in float32
# with attention and the align-corners taps in another order (measured
# ≤ 2.1e-6); bfloat16 rounds each operation at 2⁻⁹ and misses by ≥ 7e-3
MAP_TOL = 2e-5
# a loss term's relative gap: sums of the same float32 values in another
# order (measured ≤ 1.5e-7)
LOSS_TOL = 2e-6
# a trained tensor's gradient gap over the larger of its norm and the
# median tensor's: the maps' rounding gaps move pixels across the ReLU and
# L1 edges, where one pixel's share of the sum flips (measured ≤ 1.2e-5)
GRAD_TOL = 1e-4
# an update's gap, same measure: the reference's AdamW against
# torch.optim.AdamW on the port's own gradient; each element may differ by
# one float32 rounding of the parameter, ~6e-8·|p| against steps of lr
# (1e-4)
CHANGE_TOL = 1e-4


@pytest.fixture(scope="module")
def case():
    data = bench.make_data(SMALL, SEED, "cpu")
    net = bench.seeded_net(SMALL, SEED)
    lp = bench.seeded_lpips(SEED + 1)
    return dict(data=data, net=net, lp=lp,
                P={k: v.detach().clone() for k, v in net.state_dict().items()},
                L={k: v.detach().clone() for k, v in lp.state_dict().items()})


def _batch(data, i):
    """The batch of step i as the port's device step draws it."""
    return make_device_step(lambda b: b, data, SMALL["batch"])(
        rng.fold_in(rng.key(SEED), i))


def _worst(got, want):
    norms = {k: float(w.norm()) for k, w in want.items()}
    med = statistics.median(norms.values())
    return max(float((got[k] - w).norm()) / max(norms[k], med)
               for k, w in want.items())


def test_batch_draw_matches_the_reference(case):
    for i in (0, 7):
        got = _batch(case["data"], i)
        want = ref.draw_batch(case["data"], SEED, i, SMALL["batch"])
        assert set(got) == set(want)
        for k in got:
            assert torch.equal(got[k], want[k]), (i, k)


def test_maps_match_the_reference_and_bfloat16_does_not(case):
    im = _batch(case["data"], 0)["im"]
    with torch.no_grad():
        want = ref.forward(case["P"], im, SMALL["layer_idx"],
                           SMALL["num_heads"])
        got = case["net"](im)
        low = bench.seeded_net(SMALL, SEED).to(torch.bfloat16)(
            im.to(torch.bfloat16))
    assert set(got) == set(want) == set(T.MAP_KEYS)
    gaps = {k: float((got[k] - w).abs().max() / w.abs().max())
            for k, w in want.items()}
    assert max(gaps.values()) <= MAP_TOL, gaps
    low_gaps = {k: float((low[k].float() - w).abs().max() / w.abs().max())
                for k, w in want.items()}
    assert min(low_gaps.values()) > MAP_TOL, low_gaps


def test_loss_terms_match_the_reference(case):
    batch = _batch(case["data"], 1)
    with torch.no_grad():
        pred = ref.forward(case["P"], batch["im"], SMALL["layer_idx"],
                           SMALL["num_heads"])
        got = T.matnet_losses(pred, batch, lpips_fn(case["lp"], "cpu"))
        want = ref.losses(pred, batch, case["L"])
        bare = T.matnet_losses(pred, batch)
    assert set(got) == set(want)
    for k in want:
        assert abs(float(got[k]) - float(want[k])) <= LOSS_TOL * abs(
            float(want[k])), k
    # the perceptual term is live
    assert float(got["albedo"]) - float(bare["albedo"]) > 1e-3


def test_frozen_step_gradients_and_updates_match_the_reference(case):
    net = bench.seeded_net(SMALL, SEED)
    opt = T.make_optimizer(net, lr=SMALL["lr"],
                           weight_decay=SMALL["weight_decay"], freeze=True)
    step = make_device_step(T.make_train_step(
        net, opt, perceptual_fn=lpips_fn(case["lp"], "cpu")),
        case["data"], SMALL["batch"])
    trained = {n: p for n, p in net.named_parameters() if p.requires_grad}
    assert set(trained) == {n for n in case["P"] if ref.trainable(n)}
    frozen = {n: p.detach().clone() for n, p in net.named_parameters()
              if not p.requires_grad}
    m = {n: torch.zeros_like(p) for n, p in trained.items()}
    v = {n: torch.zeros_like(p) for n, p in trained.items()}
    for i in range(2):
        before = {n: p.detach().clone() for n, p in trained.items()}
        P = dict(case["P"], **before)
        loss = float(step(rng.fold_in(rng.key(SEED), i))["total"])
        terms, grads = ref.loss_and_grads(
            P, case["L"], ref.draw_batch(case["data"], SEED, i,
                                         SMALL["batch"]),
            SMALL["layer_idx"], SMALL["num_heads"])
        assert abs(loss - terms["total"]) <= LOSS_TOL * terms["total"]
        got = {n: p.grad for n, p in trained.items()}
        assert _worst(got, grads) <= GRAD_TOL
        upd, want, nowd = {}, {}, {}
        for n, p in trained.items():
            new, m1, v1 = ref.adamw(before[n], got[n], m[n], v[n], i,
                                    SMALL["lr"], SMALL["weight_decay"])
            skip = ref.adamw(before[n], got[n], m[n], v[n], i, SMALL["lr"],
                             SMALL["weight_decay"], "wd")[0]
            m[n], v[n] = m1, v1
            want[n], nowd[n] = new - before[n], skip - before[n]
            upd[n] = p.detach() - before[n]
        assert _worst(upd, want) <= CHANGE_TOL
        # the same update without the weight decay is told apart
        assert _worst(nowd, want) > CHANGE_TOL
    for n, p in net.named_parameters():
        if not p.requires_grad:
            assert p.grad is None and torch.equal(p.detach(), frozen[n]), n
