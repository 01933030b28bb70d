"""The benchmark's own tracing: synchronised spans around its calls into
the program, and one unit under ``torch.profiler``, reduced to kernel
intervals, device busy time, idle gaps labelled by the span the host was
in, and the program's launch counters over the same unit.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch


def sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


class Spans:
    """Named spans in ms, each between two synchronisations of the card;
    ``span(label)`` is a context manager."""

    def __init__(self, dev):
        self.dev = dev
        self.ms = defaultdict(list)

    @contextlib.contextmanager
    def __call__(self, label: str):
        sync(self.dev)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            sync(self.dev)
            self.ms[label].append((time.perf_counter() - t0) * 1e3)


@contextlib.contextmanager
def _labelled(label: str):
    with torch.profiler.record_function(label):
        yield


def _is_device(e) -> bool:
    return (e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False))


def _union(intervals):
    """Sorted disjoint union of (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def profile_unit(loop, first: int, labels, dev, log, attempts: int = 3):
    """Profile one unit of ``loop`` (the next ones when the profiler's
    count of the program's kernel launches disagrees with the launch
    counters, up to ``attempts`` units in all). Returns the reduction of
    the last one profiled."""
    from torch.profiler import ProfilerActivity, profile

    from materialist_tpu_torch.ops.kernels import _lib

    port_names = _lib.kernel_names()
    for attempt in range(attempts):
        i = first + attempt
        before = dict(_lib.LAUNCHES)
        before_shape = dict(_lib.LAUNCHES_BY_SHAPE)
        sync(dev)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with loop.instrument(_labelled):
                with _labelled("unit"):
                    loop.unit(i, _labelled)
                    sync(dev)
        launches = {k: v - before.get(k, 0) for k, v in _lib.LAUNCHES.items()
                    if v > before.get(k, 0)}
        by_shape = {k: v - before_shape.get(k, 0)
                    for k, v in _lib.LAUNCHES_BY_SHAPE.items()
                    if v > before_shape.get(k, 0)}
        red = reduce(prof, port_names, set(labels) | {"unit"})
        counted = sum(n * _lib.KERNELS_PER_LAUNCH.get(k, 1)
                      for k, n in launches.items())
        red.update(launches=launches, launches_by_shape=by_shape,
                   counted_launches=counted, unit_index=i)
        if red["port_launches_seen"] == counted:
            break
        log(f"profiled unit {i}: the profiler saw "
            f"{red['port_launches_seen']} launches of the program's kernels, "
            f"the counters {counted}"
            + ("; profiling the next unit" if attempt + 1 < attempts else ""))
    log(f"profiled unit {red['unit_index']}: window {red['window_us']:.0f} us,"
        f" busy {red['busy_us']:.0f} us, {red['device_ops']} device "
        f"operations, {red['port_launches_seen']} of the program's kernels")
    return red


def reduce(prof, port_names, labels) -> dict:
    """Kernel intervals, their union inside the "unit" span, idle gaps
    with the innermost label covering each, and sums by kernel."""
    events = list(prof.events())
    dev_ev = [e for e in events if _is_device(e)]
    spans = [(e.name, e.time_range.start, e.time_range.end) for e in events
             if not _is_device(e) and e.name in labels
             and e.device_type == torch.autograd.DeviceType.CPU]
    unit = [s for s in spans if s[0] == "unit"]
    if dev_ev:
        lo = min(e.time_range.start for e in dev_ev)
        hi = max(e.time_range.end for e in dev_ev)
    else:
        lo = hi = 0.0
    if unit:
        lo, hi = min(lo, unit[0][1]), max(hi, unit[0][2])
    kernels = [(e.name, e.time_range.start, e.time_range.end)
               for e in dev_ev]
    busy = _union([(s, e) for _, s, e in kernels])
    gaps = []
    at = lo
    for s, e in busy + [[hi, hi]]:
        if s > at:
            gaps.append((at, s))
        at = max(at, e)

    def label_of(t):
        inner = [sp for sp in spans if sp[1] <= t <= sp[2]]
        return min(inner, key=lambda sp: sp[2] - sp[1])[0] if inner \
            else "outside"

    port = [k for k in kernels if "at::" not in k[0]
            and any(n in k[0] for n in port_names)]
    by_name, port_by_name = defaultdict(float), defaultdict(float)
    for n, s, e in kernels:
        by_name[n] += e - s
    for n, s, e in port:
        port_by_name[n] += e - s
    return dict(
        window_us=hi - lo, busy_us=sum(e - s for s, e in busy),
        device_ops=len(kernels), port_launches_seen=len(port),
        port_us=sum(e - s for _, s, e in port),
        glue_us=sum(e - s for _, s, e in kernels) - sum(
            e - s for _, s, e in port),
        glue_ops=len(kernels) - len(port), by_name=dict(by_name),
        port_by_name=dict(port_by_name),
        gaps=sorted(((label_of(0.5 * (s + e)), e - s) for s, e in gaps),
                    key=lambda g: -g[1]))


def breakdown(red: dict) -> dict:
    """The ten device operations with the most time, and the profiled
    unit's idle time: first summed by the span the host was in ("all
    <span>"), then its longest single gaps, ten entries in all; seconds."""
    ops = sorted(red["by_name"].items(), key=lambda kv: -kv[1])[:10]
    by_label = defaultdict(float)
    for label, t in red["gaps"]:
        by_label[label] += t
    total = sorted(by_label.items(), key=lambda kv: -kv[1])[:5]
    gaps = [[f"all {n}", t / 1e6] for n, t in total]
    gaps += [[n, t / 1e6] for n, t in red["gaps"][:10 - len(gaps)]]
    return {"device_ops": [[n[:120], t / 1e6] for n, t in ops],
            "idle_gaps": gaps}
