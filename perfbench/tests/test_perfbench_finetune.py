"""The ``matnet518.finetune`` cell on the CPU at a small width (embed 64,
4 layers of 4 heads, features 16) and the configuration's 518² crop,
batch 2, past the harness's look for a card: the result line, the plain
reference agreeing with the program (its check passes), and each fault
planted in the program underneath a run failing the check: the LPIPS
term dropped, half the batch left out of the loss, the weight decay
skipped, and a step that leaves its state unchanged."""

from __future__ import annotations

import json
import os

import pytest
import torch

from perfbench.tests.conftest import ROOT

CELL = "matnet518.finetune"
SMALL = dict(embed_dim=64, enc_depth=4, num_heads=4, features=16,
             out_channels=[8, 16, 32, 64], layer_idx=[0, 1, 2, 3],
             batch=2, tuples=3)


def run_cell(trace=0, seed=11, seconds=0.5):
    from perfbench import run
    args = run.parse_args(["--workload", CELL, "--seed", str(seed),
                           "--seconds", str(seconds), "--trace", str(trace)])
    args.size = SMALL
    return run.run(args, device="cpu")


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_result_and_check():
    out = run_cell()
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    want = {m["name"]: m["unit"] for m in bench()["end_to_end"]
            if CELL in m.get("workloads", [CELL])}
    assert set(want) == {"step_ms", "step_p95_ms", "setup_s"}
    assert {k: v["unit"] for k, v in out["metrics"].items()} == want
    with open(os.path.join(ROOT, "perfbench", "limits", f"{CELL}.json")) as f:
        limits = json.load(f)
    assert set(out["checks"]) == set(limits) == {"loss_gap", "grad_gap",
                                                 "change_gap"}


def test_traced_run_reads_the_programs_spans():
    out = run_cell(trace=1)
    assert out["correct"] is True, out["checks"]
    names = {m["name"] for m in bench()["per_layer"]
             if CELL in m.get("workloads", [CELL])}
    assert names == {"matnet.mfu.finetune", "train.host_ms.finetune",
                     "device.idle_share.finetune", "device.peak_gib.finetune"}
    # the program's span is read on the CPU too; the device's metrics and
    # the share of the card's peak not
    assert set(out["metrics"]) == {"train.host_ms.finetune"}


def fault_lpips_dropped(monkeypatch):
    from materialist_tpu_torch.models import lpips
    monkeypatch.setattr(lpips, "lpips_fn",
                        lambda *a, **k: lambda p, t: torch.zeros(()))


def fault_half_batch(monkeypatch):
    from materialist_tpu_torch.models import train
    orig = train.matnet_losses

    def half(pred, batch, perceptual_fn=None):
        h = batch["im"].shape[0] // 2
        return orig({k: v[:h] for k, v in pred.items()},
                    {k: v[:h] for k, v in batch.items()}, perceptual_fn)
    monkeypatch.setattr(train, "matnet_losses", half)


def fault_no_weight_decay(monkeypatch):
    from materialist_tpu_torch.models import train
    orig = train.make_optimizer
    monkeypatch.setattr(train, "make_optimizer",
                        lambda net, lr, weight_decay, freeze: orig(
                            net, lr, 0.0, freeze))


def fault_unchanged_step(monkeypatch):
    monkeypatch.setattr(torch.optim.AdamW, "step",
                        lambda self, closure=None: None)


@pytest.mark.parametrize("fault", [fault_lpips_dropped, fault_half_batch,
                                   fault_no_weight_decay,
                                   fault_unchanged_step],
                         ids=lambda f: f.__name__)
def test_fault_fails_the_check(monkeypatch, fault):
    fault(monkeypatch)
    out = run_cell()
    assert out["correct"] is False, out["checks"]
