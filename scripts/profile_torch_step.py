#!/usr/bin/env python3
"""Where one unit of a benchmark cell spends its time, by the program's
spans: the operator's view of ``perfbench`` (PERF.md §5).

Run on a machine with one NVIDIA GPU, from the root of a checkout:

    python3 scripts/profile_torch_step.py --workload raw1024.inverse
    python3 scripts/profile_torch_step.py --workload cli512.relight

It builds the cell as ``perfbench/run.py`` does, with the ``Loop`` of its
traffic's ``perfbench/loops/<loop>.py``, whose set-up runs the traffic's
first units and so warms every shape. Then, one JSON line each:

* ``unit``: one unit without the profiler, its host ms, the spans the
  program closed in it, each span's calls and host ms (``by_span``,
  ``rng.keys`` among them) and the counters of the roots it closed
  (``counts``: ``rng.key_hashes``, ``rng.values``, ...);
* ``span_cost``: the host ns of one span with no profiler recording (a
  nest of ``--span-reps`` spans under a root), and that times the unit's
  spans as a share of the unit;
* five units under ``torch.profiler``: a first one, which warms the
  profiler up, then units with the program's ranges and without them, in
  the order with, without, without, with: the unit's host ms under the
  profiler (``wall_ms``), busy ms, device operations and
  ``utils/profiling.py::device_summary``'s ``ranges`` (device ms and
  operations by innermost span), ``idle_by_range`` (idle ms by the
  span the host was in) and ``syncs_by_range`` (the runtime calls that
  wait for the card, by the span they were made in). A
  unit "without" clears torch's Python-side profiler flag while it runs,
  so the spans open no range; the profiler records as before.

The card's name and power limit come first.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


@contextlib.contextmanager
def ranges_off():
    """The program's spans open no profiler range meanwhile."""
    import torch.autograd.profiler as aprof
    aprof._is_profiler_enabled = False
    try:
        yield
    finally:
        aprof._is_profiler_enabled = True


def records(profiling):
    """Every root record the program keeps, by id (held, so that no id
    is reused)."""
    return {id(r): r for n in profiling.totals() for r in profiling.recent(n)}


def unit_view(profiling, before, before_recs):
    """(by span: [calls, host ms], counters summed over the roots' new
    records) since ``before = profiling.totals()`` and ``before_recs =
    records(profiling)``."""
    by_span = {}
    for n, (c, ms) in profiling.totals().items():
        c0, ms0 = before.get(n, (0, 0.0))
        if c > c0:
            by_span[n] = [c - c0, ms - ms0]
    counts = {}
    for n in profiling.totals():
        for r in profiling.recent(n):
            if id(r) not in before_recs:
                for k, v in r["counts"].items():
                    counts[k] = counts.get(k, 0) + v
    return (dict(sorted(by_span.items(), key=lambda kv: -kv[1][1])),
            counts)


def span_cost_ns(profiling, reps):
    """Host ns of one span, with no profiler recording."""
    root, inner = profiling.span("t.cost_root"), profiling.span("t.cost")
    with root:
        t0 = time.perf_counter_ns()
        for _ in range(reps):
            with inner:
                pass
        return (time.perf_counter_ns() - t0) / reps


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True,
                    help="a cell of BENCHMARK.json")
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--span-reps", type=int, default=200_000)
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from materialist_tpu_torch.utils import profiling
    from perfbench import run
    if not torch.cuda.is_available():
        sys.exit("CUDA is not available")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    bench = run.load_json("BENCHMARK.json")
    cell = run.cell_of(bench, args.workload)
    conf = run.load_json("perfbench", "configs", f"{cell['config']}.json")
    traffic = run.load_json("perfbench", "traffic",
                            f"{cell['traffic']}.json")
    dev = torch.device("cuda")
    loop_mod = importlib.import_module(f"perfbench.loops.{traffic['loop']}")
    loop = loop_mod.Loop(conf, traffic, args.seed, dev, run.log)
    i = loop.next

    torch.cuda.synchronize()
    before, before_recs = profiling.totals(), records(profiling)
    t0 = time.perf_counter()
    loop.unit(i)
    torch.cuda.synchronize()
    unit_ms = (time.perf_counter() - t0) * 1e3
    by_span, counts = unit_view(profiling, before, before_recs)
    n_spans = sum(c for c, _ in by_span.values())
    print(json.dumps({"unit": loop.unit_name, "host_ms": unit_ms,
                      "spans": n_spans, "by_span": by_span,
                      "counts": counts}), flush=True)
    ns = span_cost_ns(profiling, args.span_reps)
    print(json.dumps({"span_cost": {
        "ns_per_span": ns, "spans_per_unit": n_spans,
        "share_of_unit": n_spans * ns / (unit_ms * 1e6)}}), flush=True)

    for k, with_ranges in enumerate((True, True, False, False, True)):
        i += 1
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            with contextlib.nullcontext() if with_ranges else ranges_off():
                loop.unit(i)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        s = profiling.device_summary(prof, wall_ms)
        ranges = dict(sorted(s["ranges"].items(),
                             key=lambda kv: -kv[1]["device_ms"]))
        idle = dict(sorted(s["idle_by_range"].items(),
                           key=lambda kv: -kv[1]))
        print(json.dumps({
            "profiled": k or "warm-up", "ranges_on": with_ranges,
            "wall_ms": wall_ms,
            "busy_ms": s["busy_ms"], "device_ops": s["device_ops"],
            "port_kernels_ms": s["port_kernels_ms"],
            "ranges_device_ms": sum(r["device_ms"] for n, r in ranges.items()
                                    if n != profiling.OUTSIDE),
            "idle_ms": sum(idle.values()), "ranges": ranges,
            "idle_by_range": idle,
            "syncs_by_range": profiling.syncs_by_range(prof.events()),
            "top": s["top"]}), flush=True)


if __name__ == "__main__":
    main()
