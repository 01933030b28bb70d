"""The port's spans and counters (``materialist_tpu_torch/utils/
profiling.py``) on the CPU:

- spans nest, a span's self ms is its total less its children's, the
  counters added under a root land in its record, and each root keeps
  only its last ``RECENT`` records;
- with no profiler recording no ``record_function`` is opened; under
  ``torch.profiler`` the program's spans are ranges in ``prof.events()``,
  nested as in the code;
- a 32² render and a phase step give the same bits with a profiler
  recording and without;
- ``rng.values`` and ``glue.cat_bytes`` equal their counts by hand from
  the shapes of a small step;
- no span name of the program is a label of the benchmark's loops;
- ``by_ranges`` gives each kernel to the innermost span around its launch
  (through ``cpu_parent``; by the host time of the launch for the autograd
  engine's thread) and each idle gap to the span the host was in;
- the benchmark's readers of the spans return None on an empty context
  and read the window's records;
- ``PhaseTimer`` times its phases as spans of the one store.
"""

import ast
import contextlib
import glob
import os
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from materialist_tpu_torch import rng
from materialist_tpu_torch.camera import Camera
from materialist_tpu_torch.opt import schedules
from materialist_tpu_torch.opt.step import make_phase_step
from materialist_tpu_torch.render import forward  # noqa: F401 (its spans)
from materialist_tpu_torch.render.scene import Materials, make_gbuffer
from materialist_tpu_torch.render.shader import (RenderConfig,
                                                 render_with_bsdf)
from materialist_tpu_torch.utils import profiling as P

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES = 32
CPU = torch.autograd.DeviceType.CPU
CUDA = torch.autograd.DeviceType.CUDA


def test_spans_nest_self_is_total_less_children_and_counts_land_in_root():
    outer, inner, leaf = (P.span("t.nest_outer"), P.span("t.nest_inner"),
                          P.span("t.nest_leaf"))
    with outer:
        P.count("t.counter", 3)
        with inner:
            time.sleep(0.002)
            with leaf:
                P.count("t.counter", 4)
                time.sleep(0.002)
        with inner:
            pass
    rec = P.recent("t.nest_outer")[-1]
    s = rec["spans"]
    assert rec["root"] == "t.nest_outer" and rec["profiled"] is False
    assert s["t.nest_inner"]["calls"] == 2 and s["t.nest_leaf"]["calls"] == 1
    assert s["t.nest_leaf"]["self_ms"] == s["t.nest_leaf"]["host_ms"] >= 2
    assert s["t.nest_inner"]["self_ms"] == pytest.approx(
        s["t.nest_inner"]["host_ms"] - s["t.nest_leaf"]["host_ms"])
    assert s["t.nest_outer"]["self_ms"] == pytest.approx(
        s["t.nest_outer"]["host_ms"] - s["t.nest_inner"]["host_ms"])
    assert rec["host_ms"] == s["t.nest_outer"]["host_ms"]
    assert rec["counts"] == {"t.counter": 7}
    # inner spans close no record; a counter outside every span is dropped
    assert P.recent("t.nest_inner") == []
    P.count("t.counter", 100)
    with outer:
        pass
    assert P.recent("t.nest_outer")[-1]["counts"] == {}
    calls, ms = P.totals()["t.nest_inner"]
    assert calls >= 2 and ms >= 2


def test_one_span_object_per_name_and_numbered_spans():
    assert P.span("t.same") is P.span("t.same")
    series = P.Numbered("t.bounce", 2)
    assert series[1] is P.span("t.bounce1")
    assert series[5] is P.span("t.bounce5")
    assert series[5].name == "t.bounce5"


def test_records_are_bounded_per_root():
    root = P.span("t.bounded")
    for _ in range(P.RECENT + 7):
        with root:
            P.count("t.n", 1)
    recs = P.recent("t.bounded")
    assert len(recs) == P.RECENT
    assert P.totals()["t.bounded"][0] >= P.RECENT + 7


def test_no_profiler_opens_no_range(monkeypatch):
    opened = []
    monkeypatch.setattr(P._aprof, "record_function",
                        lambda name: opened.append(name))
    with P.span("t.quiet"):
        with P.span("t.quiet_inner"):
            pass
    assert opened == []
    assert P.recent("t.quiet")[-1]["profiled"] is False


def test_program_spans_are_ranges_of_a_profile_nested_as_in_the_code():
    gbuf, cam, mats, env = scene()
    cfg = RenderConfig(spp=2, chunk=2, march_steps=6, shadow_steps=4)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.no_grad():
            render_with_bsdf(rng.key(3), cfg, cam, gbuf, mats, env)
    ev = [e for e in prof.events() if e.name in P._SPANS]
    names = {e.name for e in ev}
    assert {"trace.chunk", "trace.bounce0", "trace.draws", "trace.march",
            "shade.chunk", "shade.bounce2", "shade.eval", "rng.bits",
            "rng.keys"} <= names

    def parents(e):
        out = []
        while e.cpu_parent is not None:
            e = e.cpu_parent
            if e.name in P._SPANS:
                out.append(e.name)
        return out
    draws = next(e for e in ev if e.name == "trace.draws")
    assert parents(draws) == ["trace.bounce0", "trace.chunk"]
    bits = next(e for e in ev if e.name == "rng.bits")
    assert parents(bits)[:3] == ["trace.draws", "trace.bounce0",
                                 "trace.chunk"]
    film = [e for e in ev if e.name == "shade.film"]
    assert {tuple(parents(e)) for e in film} == {
        ("shade.bounce0", "shade.chunk"), ("shade.bounce1", "shade.chunk"),
        ("shade.bounce2", "shade.chunk"), ("shade.chunk",)}
    assert P.recent("trace.chunk")[-1]["profiled"] is True


def scene():
    r = np.random.default_rng(0)
    depth = (2.0 + 0.3 * r.uniform(size=(RES, RES))).astype(np.float32)
    depth[6:16, 8:22] -= 0.7
    depth[20:28, 3:12] -= 0.4
    cam = Camera(RES, RES)
    gbuf = make_gbuffer(depth, cam, flip_depth=False)

    def u(lo, hi, c):
        return torch.from_numpy(r.uniform(lo, hi, (RES, RES, c)).astype(
            np.float32))
    mats = Materials(u(0.2, 0.9, 3), u(0.2, 0.9, 1), u(0.0, 0.5, 1),
                     gbuf.normal_geo.clone())
    env = torch.from_numpy(((r.uniform(size=(16, 32, 3)) + 0.1)
                            * 2).astype(np.float32))
    return gbuf, cam, mats, env


def phase_case(cfg):
    gbuf, cam, mats, env = scene()
    params = {"albedo": mats.albedo, "roughness": mats.roughness,
              "metallic": mats.metallic, "normal": mats.normal,
              "envmap": env}
    params = {k: v.clone().requires_grad_() for k, v in params.items()}
    gt = torch.full((RES, RES, 3), 0.3)

    def maps_of(p, extra):
        return Materials(p["albedo"], p["roughness"], p["metallic"],
                         p["normal"]), p["envmap"]

    def loss_of(maps, img, extra):
        loss = torch.mean((img - gt) ** 2)
        return loss, loss.detach()
    phase = make_phase_step(cfg, cam, gbuf, maps_of, loss_of, device="cpu")
    opt = schedules.adam_plain(1e-3)
    return phase, phase.make_step(opt), params, opt.init(
        list(params.values()))


def one_step(cfg, profiled):
    phase, step, params, state = phase_case(cfg)
    ctx = (profile(activities=[ProfilerActivity.CPU]) if profiled
           else contextlib.nullcontext())
    with ctx:
        recs = phase.trace_all(params, None, rng.key(5))
        loss, _, _ = step(params, state, None, recs)
    return loss, {k: v.detach().clone() for k, v in params.items()}


def test_render_and_step_are_bit_identical_under_a_profiler():
    gbuf, cam, mats, env = scene()
    cfg = RenderConfig(spp=4, chunk=2, march_steps=6, shadow_steps=4,
                       film_jitter=0.5)
    imgs = []
    for profiled in (False, True):
        with torch.no_grad():
            if profiled:
                with profile(activities=[ProfilerActivity.CPU]):
                    imgs.append(render_with_bsdf(rng.key(7), cfg, cam, gbuf,
                                                 mats, env))
            else:
                imgs.append(render_with_bsdf(rng.key(7), cfg, cam, gbuf,
                                             mats, env))
    assert torch.equal(imgs[0], imgs[1])
    cfg = RenderConfig(spp=4, chunk=2, march_steps=6, shadow_steps=4,
                       compact_caps=(0.5, 0.25))
    (l0, p0), (l1, p1) = one_step(cfg, False), one_step(cfg, True)
    assert torch.equal(l0, l1)
    for k in p0:
        assert torch.equal(p0[k], p1[k]), k


def hand_counts(res, spp, chunk, caps, sky_adjoint):
    """(rng.values, glue.cat_bytes) of one trace_all and one step of the
    fused, compacted configuration at film jitter 0, max_depth 4, from
    the shapes alone (one group)."""
    n = res * res
    m0 = chunk * n
    chunks = spp // chunk

    def cap(frac):
        return max(min(-(-int(frac * m0) // 1024) * 1024, m0), 1024)
    rows = (m0, cap(caps[0]), cap(caps[1]))     # each bounce's rays
    values = chunks * 3 * 5 * n                 # u1 | u2 | u_nee a pixel
    per_trace = (n * 13 * 4                     # combo side table
                 + n * 8 * 4                    # the material table
                 + 2 * m0 * 5 * 4               # ug, compacted bounces
                 + sum(r * (5 * 4 + 13 * 2) for r in rows)  # aux, recb
                 + (rows[0] + rows[1]) * 6 * 4)             # pack_src
    per_shade = n * 8 * 4 + sum(r * 8 * 2 for r in rows)    # table, auxf
    sky = chunks * 4 * n * (4 + 3 * 4) if sky_adjoint else 0
    return values, chunks * per_trace, 2 * chunks * per_shade + sky


def test_counters_equal_the_hand_count():
    caps = (0.5, 0.25)
    cfg = RenderConfig(spp=4, chunk=2, march_steps=6, shadow_steps=4,
                       compact_caps=caps)
    phase, step, params, state = phase_case(cfg)
    recs = phase.trace_all(params, None, rng.key(9))
    step(params, state, None, recs)
    trace = P.recent("phase.trace_all")[-1]["counts"]
    stepc = P.recent("phase.step")[-1]["counts"]
    values, trace_bytes, step_bytes = hand_counts(RES, 4, 2, caps, True)
    assert trace["rng.values"] == values == 30720
    assert "rng.values" not in stepc
    assert trace["glue.cat_bytes"] == trace_bytes
    assert stepc["glue.cat_bytes"] == step_bytes


def test_hand_count_of_the_raw1024_step():
    values, trace_bytes, step_bytes = hand_counts(
        1024, 64, 8, (0.125, 0.0625), True)
    assert values / 1e6 == 125.82912
    assert (trace_bytes + step_bytes) / 2 ** 20 == 11912.0


def benchmark_labels():
    labels = set()
    for path in glob.glob(os.path.join(ROOT, "perfbench", "loops", "*.py")):
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in tree.body:
            if isinstance(node, ast.Assign) and any(
                    getattr(t, "id", None) == "LABELS" for t in node.targets):
                labels |= set(ast.literal_eval(node.value))
    return labels


def test_no_program_span_is_a_label_of_the_benchmark():
    labels = benchmark_labels()
    assert {"trace_all", "step", "readback", "pass", "render",
            "denoise"} <= labels
    program = {n for n in P._SPANS if not n.startswith("t.")}
    assert "phase.trace_all" in program and "forward.pass" in program
    assert not program & (labels | {"unit"})


def ev(name, id_, start, end, device=CPU, parent=None, annotation=False):
    return SimpleNamespace(
        name=name, id=id_, cpu_parent=parent, device_type=device,
        is_user_annotation=annotation,
        time_range=SimpleNamespace(start=start, end=end))


def launch(op, id_, at):
    """The runtime call inside ``op`` that launched kernel ``id_``."""
    return ev("cudaLaunchKernel", id_, at, at + 0.5, parent=op)


def test_by_ranges_on_a_synthetic_profile():
    for name in ("t.root", "t.stage_a", "t.stage_b"):
        P.span(name)
    root = ev("t.root", 1, 0.0, 100.0, annotation=True)
    a = ev("t.stage_a", 2, 10.0, 40.0, parent=root, annotation=True)
    b = ev("t.stage_b", 3, 50.0, 90.0, parent=root, annotation=True)
    op_a = ev("aten::cat", 4, 12.0, 14.0, parent=a)
    op_b = ev("aten::add", 100, 52.0, 53.0, parent=b)   # an id repeated
    # a launch of the autograd engine's thread: no span among its parents
    engine = ev("autograd::engine::evaluate_function", 6, 60.0, 70.0)
    op_bwd = ev("aten::mul", 7, 61.0, 62.0, parent=engine)
    op_root = ev("aten::zeros", 8, 95.0, 96.0, parent=root)
    calls = [launch(op_a, 100, 13.0), launch(op_b, 101, 52.2),
             launch(op_bwd, 102, 61.2), launch(op_root, 103, 95.2)]
    kernels = [ev("cat_kernel", 100, 20.0, 30.0, CUDA),
               ev("add_kernel", 101, 55.0, 58.0, CUDA),
               ev("mul_kernel", 102, 64.0, 66.0, CUDA),
               ev("fill_kernel", 103, 97.0, 98.0, CUDA),
               ev("t.stage_a", 104, 20.0, 30.0, CUDA, annotation=True)]
    ranges, idle = P.by_ranges([root, a, b, op_a, op_b, engine, op_bwd,
                                op_root] + calls + kernels)
    assert ranges["t.stage_a"] == dict(device_ms=0.010, ops=1,
                                       total_ms=0.010)
    assert ranges["t.stage_b"]["ops"] == 2
    assert ranges["t.stage_b"]["device_ms"] == pytest.approx(0.005)
    assert ranges["t.root"]["ops"] == 1
    assert ranges["t.root"]["device_ms"] == pytest.approx(0.001)
    assert ranges["t.root"]["total_ms"] == pytest.approx(0.016)
    # gaps by midpoint: 0–20 (10: a), 30–55 (42.5: root), 58–64 (61: b),
    # 66–97 (81.5: b), 98–100 (99: root)
    assert idle["t.stage_a"] == pytest.approx(0.020)
    assert idle["t.root"] == pytest.approx(0.025 + 0.002)
    assert idle["t.stage_b"] == pytest.approx(0.006 + 0.031)
    assert sum(idle.values()) + 0.016 == pytest.approx(0.100)


def test_syncs_by_range_on_a_synthetic_profile():
    for name in ("t.root", "t.stage_a", "t.stage_b"):
        P.span(name)
    root = ev("t.root", 1, 0.0, 100.0, annotation=True)
    a = ev("t.stage_a", 2, 10.0, 40.0, parent=root, annotation=True)
    b = ev("t.stage_b", 3, 50.0, 90.0, parent=root, annotation=True)
    sync = [ev("cudaStreamSynchronize", 10 + j, t, t + 1.0)
            for j, t in enumerate((12.0, 20.0, 60.0, 95.0, 120.0))]
    dev_sync = ev("cudaDeviceSynchronize", 20, 30.0, 31.0)
    other = [ev("cudaLaunchKernel", 21, 13.0, 13.5),
             ev("cudaStreamSynchronize", 22, 14.0, 15.0, CUDA)]
    assert P.syncs_by_range([root, a, b, dev_sync] + sync + other) == {
        "t.stage_a": 3, "t.stage_b": 1, "t.root": 1, P.OUTSIDE: 1}
    assert P.syncs_by_range([root, a, b] + other) == {}


def test_by_ranges_on_a_cpu_profile():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with P.span("t.cpu_root"):
            with P.span("t.cpu_inner"):
                torch.ones(64) + 1
    ranges, idle = P.by_ranges(prof.events())
    assert ranges == {}
    # no kernel: the whole span is idle, in its innermost span by midpoint
    assert set(idle) <= {"t.cpu_root", "t.cpu_inner"} and idle


def readers():
    from perfbench import files
    return {name: files.load("metrics", name) for name in (
        "phase.trace_host_ms.inverse", "rng.values_m.inverse",
        "glue.cat_mib.inverse", "trace.host_ms.relight",
        "shade.host_ms.relight", "rng.keys_host_ms.relight")}


@pytest.mark.parametrize("ctx", [{}, dict(unit="step", unit_ms=[]),
                                 dict(unit="pass", unit_ms=[])],
                         ids=["empty", "no steps", "no passes"])
def test_readers_return_none_on_an_empty_context(ctx):
    for name, mod in readers().items():
        assert mod.read(ctx) is None, name


def test_readers_read_the_windows_records():
    mods = readers()
    step, trace = P.span("phase.step"), P.span("phase.trace_all")
    for i in range(4):
        with trace:
            P.count("rng.values", 1_000_000 * (i + 1))
            P.count("glue.cat_bytes", 2 ** 20)
        with step:
            P.count("glue.cat_bytes", 2 ** 21)
    with profile(activities=[ProfilerActivity.CPU]):
        with trace:
            P.count("rng.values", 99)
    ctx = dict(unit="step", unit_ms=[1.0, 1.0, 1.0])
    # the last three unprofiled steps: 2, 3, 4 M values; 3 MiB each
    assert mods["rng.values_m.inverse"].read(ctx) == 3.0
    assert mods["glue.cat_mib.inverse"].read(ctx) == 3.0
    host = [r["host_ms"] for r in P.recent("phase.trace_all")
            if not r["profiled"]][-3:]
    assert mods["phase.trace_host_ms.inverse"].read(ctx) == sorted(host)[1]
    # another cell's unit reads nothing
    assert mods["trace.host_ms.relight"].read(ctx) is None


def test_phase_timer_times_spans_of_the_store():
    t = P.PhaseTimer()
    with t.phase("t.timer_a"):
        time.sleep(0.01)
    with t.phase("t.timer_a"):
        time.sleep(0.01)
    with P.span("t.timer_outer"):
        with t.phase("t.timer_b"):
            pass
        # a phase inside an open root is counted before the root closes
        assert t.counts == {"t.timer_a": 2, "t.timer_b": 1}
    assert t.totals["t.timer_a"] >= 0.02
    assert t.totals["t.timer_a"] * 1e3 == pytest.approx(
        P.totals()["t.timer_a"][1])
    rec = P.recent("t.timer_a")[-1]
    assert rec["spans"]["t.timer_a"]["calls"] == 1
    rep = t.report()
    assert "t.timer_a:" in rep and "2x" in rep
    # a later timer counts from its own first phase on
    t2 = P.PhaseTimer()
    with t2.phase("t.timer_a"):
        pass
    assert t2.counts == {"t.timer_a": 1}
