"""One run of each cell on the CPU at a tiny film, past the harness's look
for a card: the result line's schema, and the plain reference agreeing
with the program's CPU path (its check passes with every gap near 0)."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from perfbench.tests.conftest import ROOT, TINY

CELLS = ("raw1024.inverse", "cli512.relight")


def run_cell(cell, trace=0, seed=11, seconds=0.6):
    from perfbench import run
    args = run.parse_args(["--workload", cell, "--seed", str(seed),
                           "--seconds", str(seconds), "--trace", str(trace)])
    args.size = TINY if cell.endswith(".inverse") else {"film": 32}
    return run.run(args, device="cpu")


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("cell", CELLS)
def test_result_schema_and_check(cell):
    out = run_cell(cell)
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert out["correct"] is True
    assert out["attempted"] >= 1 and out["failed"] == 0
    b = bench()
    want = {m["name"]: m["unit"] for m in b["end_to_end"]
            if cell in m.get("workloads", [cell])}
    assert {k: v["unit"] for k, v in out["metrics"].items()} == want
    for v in out["metrics"].values():
        assert v["value"] > 0
    assert set(out["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    with open(os.path.join(ROOT, "perfbench", "limits", f"{cell}.json")) as f:
        limits = json.load(f)
    assert set(out["checks"]) == set(limits)
    for name, c in out["checks"].items():
        assert c["limit"] == limits[name]
        # the reference follows the CPU path to rounding
        assert c["value"] <= 1e-5, (name, c)
    json.dumps(out)


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reports_spans_and_breakdown(cell):
    out = run_cell(cell, trace=1)
    assert list(out)[-2:] == ["breakdown", "checks"]
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"busy_s", "window_s"} <= set(out["device"])
    names = {m["name"] for m in bench()["per_layer"]
             if cell in m.get("workloads", [cell])}
    assert set(out["metrics"]) <= names
    # the synchronised spans are read on the CPU too; device metrics not
    spans = {n for n in names if n.startswith(("step.", "render."))}
    assert spans <= set(out["metrics"])
    assert out["correct"] is True


def test_seed_sets_the_inputs():
    a = run_cell("raw1024.inverse", seed=5)["checks"]
    b = run_cell("raw1024.inverse", seed=5)["checks"]
    assert a == b


def test_no_card_exits_nonzero_without_a_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        "raw1024.inverse", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
