"""BENCHMARK.json against the benchmark's contract and its files: names,
units, every file found by name, every per-layer metric's end-to-end
metric reported in each of its cells."""

from __future__ import annotations

import json
import os
import re

import pytest

from perfbench.tests.conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys_and_limits():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(b["paths"]) <= 16
    for p in b["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert os.path.isdir(os.path.join(ROOT, p))
    assert 1 <= len(b["command"]) <= 32
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    assert 1 + 2 * 0 <= len(b["configs"]) <= 24
    assert 1 <= len(b["workloads"]) <= 24
    assert 1 <= len(b["end_to_end"]) <= 16
    assert 1 <= len(b["per_layer"]) <= 128
    assert len(json.dumps(b)) <= 64 * 1024
    # a full check of 24 cells fits its time
    rs = b["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_names_unique_and_well_formed(section):
    names = [e["name"] for e in bench()[section]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n


def test_metrics_units_sources_and_bounds():
    b = bench()
    every = {m["name"] for m in b["end_to_end"] + b["per_layer"]}
    assert len(every) == len(b["end_to_end"]) + len(b["per_layer"])
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in {"host_clock", "device_trace"}
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" and "workloads" not in m
               for m in b["end_to_end"])
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]


def test_every_cell_reports_setup_another_metric_and_a_layer():
    b = bench()
    for c in b["workloads"]:
        e2e = [m["name"] for m in b["end_to_end"]
               if c["name"] in m.get("workloads", [c["name"]])]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(c["name"] in m.get("workloads", [c["name"]])
                   for m in b["per_layer"])


def test_per_layer_moves_is_reported_in_its_cells():
    b = bench()
    e2e = {m["name"]: m for m in b["end_to_end"]}
    cells = [c["name"] for c in b["workloads"]]
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", cells):
            assert cell in e2e[m["moves"]].get("workloads", cells), (m, cell)


def test_layers_are_those_of_perf_md():
    with open(os.path.join(ROOT, "PERF.md")) as f:
        perf = f.read()
    for layer in {m["layer"] for m in bench()["per_layer"]}:
        assert layer in perf, layer


def test_cells_one_chip_configs_and_traffic_found_by_name():
    b = bench()
    configs = {c["name"]: c for c in b["configs"]}
    seen = set()
    for c in b["workloads"]:
        assert c["chips"] == 1
        assert (c["config"], c["traffic"]) not in seen
        seen.add((c["config"], c["traffic"]))
        assert c["config"] in configs
        assert NAME.match(c["traffic"])
        assert 1 <= len(c["why"]) <= 200
        traffic = os.path.join(ROOT, "perfbench", "traffic",
                               f"{c['traffic']}.json")
        with open(traffic) as f:
            loop = json.load(f)["loop"]
        assert os.path.exists(os.path.join(ROOT, "perfbench", "loops",
                                           f"{loop}.py"))
        assert os.path.exists(os.path.join(ROOT, "perfbench", "limits",
                                           f"{c['name']}.json"))
    used = {c["config"] for c in b["workloads"]}
    assert used == set(configs)
    files = [c["file"] for c in b["configs"]]
    assert len(files) == len(set(files))
    for c in b["configs"]:
        assert c["file"].startswith("perfbench/")
        with open(os.path.join(ROOT, c["file"])) as f:
            conf = json.load(f)
        assert conf["name"] == c["name"]
        assert conf["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16
        assert 1 <= len(c["source"]) <= 200
    # a cell of the inverse loop finds its phase on both sides
    for c in b["workloads"]:
        with open(os.path.join(ROOT, "perfbench", "traffic",
                               f"{c['traffic']}.json")) as f:
            if json.load(f)["loop"] != "inverse":
                continue
        with open(os.path.join(ROOT, configs[c["config"]]["file"])) as f:
            phase = json.load(f)["phase"]
        assert os.path.exists(os.path.join(
            ROOT, "perfbench", "phases", f"{phase}.py"))
        assert os.path.exists(os.path.join(
            ROOT, "perfbench", "reference", f"phase_{phase}.py"))


def test_every_metric_has_its_reader():
    b = bench()
    for m in b["end_to_end"] + b["per_layer"]:
        assert os.path.exists(os.path.join(ROOT, "perfbench", "metrics",
                                           f"{m['name']}.py")), m["name"]


def test_every_launch_counter_has_its_bound():
    from materialist_tpu_torch.ops.kernels import _lib

    from perfbench import files
    for name in _lib.LAUNCHES:
        mod = files.load("roofline", name)
        assert callable(mod.bound)
        assert "chip_smoke.py:" in mod.__doc__


def test_every_kernel_has_its_counters():
    from materialist_tpu_torch.ops.kernels import _lib

    from perfbench import files
    names = set(_lib.kernel_names())
    claimed = set()
    for counter in _lib.LAUNCHES:
        kernels = set(files.load("roofline", counter).KERNELS)
        assert kernels and kernels <= names, (counter, kernels - names)
        claimed |= kernels
    assert claimed == names


def test_roofline_bounds_at_main_path_shapes():
    from perfbench import files
    b, f = files.load("roofline", "shade_bounce_fwd").bound((1048576, 16, 32))
    assert b == 1048576 * 104 + 16 * 32 * 12 and f == 1048576 * 260
    b, f = files.load("roofline", "row_gather").bound((1048576, 3, 131072, 1))
    assert b == 131072 * (4 + 8 * 3) and f == 0
    b, _ = files.load("roofline", "row_scatter_add_coherent").bound(
        (131072, 3, 1048576, 0))
    assert b == 131072 * 16 + 1048576 * 12
    assert files.load("roofline", "row_scatter_add_coherent").bound(
        (131072, 3, 1048576, 1)) is None
    assert files.load("roofline", "march_pair").bound((1048576,)) is None
    assert files.load("roofline", "onehot_gather").bound(None) is None


def _profile(launches, by_shape, port_by_name):
    return dict(launches=launches, launches_by_shape=by_shape,
                port_by_name=port_by_name)


def test_roofline_share_leaves_unbounded_kernels_out_of_both_sums():
    from perfbench import files
    from perfbench.metrics._common import (PEAK_BYTES_PER_S,
                                           PEAK_FP32_PER_S, roofline_share)
    fwd = (1048576, 16, 32)
    b, f = files.load("roofline", "shade_bounce_fwd").bound(fwd)
    want = 2 * max(b / PEAK_BYTES_PER_S, f / PEAK_FP32_PER_S)
    names = {"void shade_fwd_kernel<1>(float const*)": 400.0,
             "march_kernel(float const*, int)": 1000.0,
             "void scatter_rows_kernel<3, 1>(float const*)": 50.0}
    prof = _profile(
        {"shade_bounce_fwd": 2, "march_pair": 3,
         "row_scatter_add_coherent": 2},
        {("shade_bounce_fwd", fwd): 2, ("march_pair", (1048576,)): 3,
         ("row_scatter_add_coherent", (131072, 3, 1048576, 0)): 1,
         ("row_scatter_add_coherent", (131072, 3, 1048576, 1)): 1},
        names)
    # A (no steps) and C′ (one launch into a running table) are left out
    # of the bound and of the time; B alone is left
    assert roofline_share(prof) == pytest.approx(100.0 * want / 400e-6)
    # a counter with launches but no shape (F) leaves its kernels out
    prof = _profile({"shade_bounce_fwd": 2, "onehot_gather": 1},
                    {("shade_bounce_fwd", fwd): 2},
                    {"void shade_fwd_kernel<1>(float const*)": 400.0,
                     "onehot_gather_kernel(float const*)": 80.0})
    assert roofline_share(prof) == pytest.approx(100.0 * want / 400e-6)
    # nothing bounded: nothing to read
    prof = _profile({"march_pair": 3}, {("march_pair", (1048576,)): 3},
                    {"march_kernel(float const*, int)": 1000.0})
    assert roofline_share(prof) is None
