"""The control of each cell, on the card at the cell's own size: the plain
reference with its per-vertex shading in bfloat16 (and TF32 matrix
products), in the program's place, must fail the cell's check. Run on the
card: ``python -m pytest perfbench/tests -m cuda``."""

from __future__ import annotations

import json
import os

import pytest
import torch

from perfbench.tests.conftest import ROOT

CELLS = ("raw1024.inverse", "cli512.relight")


def _load(*parts):
    with open(os.path.join(ROOT, *parts)) as f:
        return json.load(f)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_check(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from perfbench import inputs
    from perfbench.loops import inverse, relight
    config, mix = cell.split(".")
    conf = _load("perfbench", "configs", f"{config}.json")
    traffic = _load("perfbench", "traffic", f"{mix}.json")
    limits = _load("perfbench", "limits", f"{cell}.json")
    dev = torch.device("cuda")
    seed = 4242
    if traffic["loop"] == "inverse":
        phase = __import__(f"perfbench.phases.{conf['phase']}",
                           fromlist=["INPUTS"])
        inp = inputs.load(conf, phase.INPUTS, dev)
        ref = inverse.reference_steps(conf, traffic, inp, seed, dev)
        low = inverse.reference_steps(conf, traffic, inp, seed, dev,
                                      dtype=torch.bfloat16)
        checks = inverse.compare(low, ref, limits)
    else:
        inp = inputs.load(conf, "relight", dev)
        ref = relight.reference_image(conf, traffic, inp, seed)
        low = relight.reference_image(conf, traffic, inp, seed,
                                      torch.bfloat16)
        gap = relight.image_gap(low.cpu().numpy(), ref)
        checks = {"image_gap": {"value": gap, "limit": limits["image_gap"]}}
    assert any(v["value"] > v["limit"] for v in checks.values()), checks
