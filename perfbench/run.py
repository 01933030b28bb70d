"""Run one cell of the port's benchmark once, on the card of this machine.

    python3 perfbench/run.py --workload raw1024.inverse --seed 7 \\
        --seconds 51 --trace 0

The cell, its configuration (``perfbench/configs/<config>.json``), its
traffic (``perfbench/traffic/<traffic>.json``, whose ``loop`` names
``perfbench/loops/<loop>.py``), its metrics (``perfbench/metrics/
<name>.py``) and the limits of its check (``perfbench/limits/<cell>.json``)
are found by the names in ``BENCHMARK.json``. A run sets the cell up
(inputs, the program's objects, the traffic's first units, which warm
every shape), then drives the closed loop for ``--seconds``, then frees
the program's state and checks what the timed path produced against the
plain reference (``perfbench/reference``). With ``--trace 0`` it reports
the cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics:
the window's units then carry synchronised spans, and one more unit runs
under ``torch.profiler``. The last line of standard output is the
result, a JSON object; the numbers compared, each with its limit, are the
last lines of standard error and the result's last key.

Without a CUDA card, or with fewer cards than the cell asks for, it
exits with code 3 and prints no result. It never runs on the CPU.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:] = [ROOT] + [p for p in sys.path
                        if os.path.abspath(p or ".") not in (HERE, ROOT)]
# build and kernel caches at fixed paths inside the checkout
CACHE = os.path.join(ROOT, "perfbench", ".cache")
os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(CACHE, "torch_ext"))
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(CACHE, "triton"))
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")

import torch  # noqa: E402

from perfbench import files, profiling  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "materialist_tpu")


def log(msg: str) -> None:
    print(f"[perfbench] {msg}", file=sys.stderr, flush=True)


def load_json(*parts) -> dict:
    with open(os.path.join(ROOT, *parts)) as f:
        return json.load(f)


def cell_of(bench: dict, name: str) -> dict:
    for c in bench["workloads"]:
        if c["name"] == name:
            return c
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def metrics_of(bench: dict, section: str, cell: str) -> list:
    """The metrics of ``section`` that cell ``cell`` reports."""
    return [m for m in bench[section]
            if "workloads" not in m or cell in m["workloads"]]


def read_metric(name: str, ctx: dict):
    return files.load("metrics", name).read(ctx)


def foreign_modules() -> list:
    """Top-level names in ``sys.modules`` that the port may not load."""
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def window(loop, first: int, seconds: float, span=None):
    """The closed loop: units from ``first`` until ``seconds`` have passed
    (the unit under way finishes) and the unit that the check samples,
    ``loop.sampled``, is done. (per-unit ms, units, failed, window s, next
    unit)."""
    unit_ms, failed = [], 0
    i = first
    t_start = t_prev = time.perf_counter()
    while True:
        value = loop.unit(i, span)
        if not math.isfinite(value):
            failed += 1
        t = time.perf_counter()
        unit_ms.append((t - t_prev) * 1e3)
        t_prev = t
        i += 1
        if t - t_start >= seconds and i > loop.sampled:
            break
    return unit_ms, failed, t_prev - t_start, i


def run(args, device="cuda") -> dict:
    """Set up, run the window, check; returns the result object. The
    caller has made sure that ``device`` exists."""
    bench = load_json("BENCHMARK.json")
    cell = cell_of(bench, args.workload)
    conf = load_json("perfbench", "configs", f"{cell['config']}.json")
    traffic = load_json("perfbench", "traffic", f"{cell['traffic']}.json")
    limits = load_json("perfbench", "limits", f"{cell['name']}.json")
    if args.size is not None:
        conf = dict(conf, **args.size)
    dev = torch.device(device)
    loop_mod = importlib.import_module(f"perfbench.loops.{traffic['loop']}")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    loop = loop_mod.Loop(conf, traffic, args.seed, dev, log)
    profiling.sync(dev)
    setup_s = time.perf_counter() - T0
    log(f"set-up {setup_s:.3f} s")

    spans = profiling.Spans(dev) if args.trace else None
    with (loop.instrument(spans) if spans else contextlib.nullcontext()):
        unit_ms, failed, window_s, nxt = window(loop, loop.next, args.seconds,
                                                spans)
    attempted = len(unit_ms)
    log(f"window {window_s:.3f} s, {attempted} {loop.unit_name}s, "
        f"{failed} failed; per {loop.unit_name} ms: "
        + ", ".join(f"{t:.1f}" for t in unit_ms))
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    ctx = dict(unit=loop.unit_name, unit_ms=unit_ms, window_s=window_s,
               setup_s=setup_s, peak_bytes=peak, spans={}, profile=None)
    result_extra = {}
    if args.trace:
        ctx["spans"] = spans.ms
        prof = profiling.profile_unit(loop, nxt, loop_mod.LABELS, dev, log)
        ctx["profile"] = prof
        result_extra["busy_s"] = prof["busy_us"] / 1e6
        result_extra["window_s"] = prof["window_us"] / 1e6
    section = "per_layer" if args.trace else "end_to_end"
    metrics = {}
    for m in metrics_of(bench, section, cell["name"]):
        v = read_metric(m["name"], ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    loop.free()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks, _ = loop.check(limits, log)
    log(f"check {time.perf_counter() - t_check:.3f} s")
    correct = failed == 0 and all(
        c["limit"] is not None and c["value"] <= c["limit"]
        for c in checks.values())
    device_info = dict(platform="gpu" if dev.type == "cuda" else dev.type,
                       kind=(torch.cuda.get_device_name(dev)
                             if dev.type == "cuda" else "cpu"),
                       count=1, memory_peak_bytes=peak, **result_extra)
    out = dict(correct=correct, attempted=attempted, failed=failed,
               metrics=metrics, device=device_info)
    if args.trace:
        out["breakdown"] = profiling.breakdown(ctx["profile"])
    out["checks"] = checks
    return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python3 perfbench/run.py",
        description="One run of one cell of the port's benchmark.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    args.size = None
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    if not torch.cuda.is_available():
        log("no CUDA device: the benchmark runs only on the card")
        return 3
    bench = load_json("BENCHMARK.json")
    chips = cell_of(bench, args.workload)["chips"]
    if torch.cuda.device_count() < chips:
        log(f"{args.workload} needs {chips} cards, "
            f"{torch.cuda.device_count()} present")
        return 3
    out = run(args)
    found = foreign_modules()
    if found:
        log(f"the run loaded {found}; no result")
        return 4
    for name, c in out["checks"].items():
        log(f"check {name} = {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
