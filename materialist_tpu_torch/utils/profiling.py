"""Profiling utilities (counterpart of ``materialist_tpu/utils/profiling.py``):
the program's spans and counters, a phase timer on them (it synchronizes
the card at both ends, so a phase's time is its device time), a JSON-lines
log, and the device-time summary of a ``torch.profiler`` profile, by kernel
and by the program's spans.

Spans and counters::

    _STAGE = span("trace.chunk")        # once, at import
    with _STAGE:                        # on the hot path
        ...
        count(RNG_VALUES, n)            # a host-known integer

A span costs two clock reads, a push and a pop and one dict update; it
never touches the device. While a ``torch.profiler`` session records, it
also opens ``torch.profiler.record_function(name)``, so the stages show in
the device trace beside the kernels they launched. A span opened with no
span open is a root: its closing makes a record (the root's host ms; for
every span name under it its calls, total and self host ms; the counters
added under it; whether a profiler recorded), kept in memory, the last
``RECENT`` of each root name (``recent``). ``totals`` sums calls and host
ms by name since start.

The open spans are one stack for the process: the program runs its spans
on one thread. The autograd engine's device thread counts into the root
of the caller, which waits in ``backward()`` meanwhile.
"""

from __future__ import annotations

import contextlib
import json
import time
from collections import deque
from time import perf_counter_ns
from typing import Optional

import torch
import torch.autograd.profiler as _aprof

RECENT = 512
CAT_BYTES = "glue.cat_bytes"
RNG_VALUES = "rng.values"
RNG_KEY_HASHES = "rng.key_hashes"
POSMLP_ROWS = "posmlp.rows"     # + "." + the PosMLP's output_type

_SPANS = {}      # name -> its span, made once
_STACK = []      # the open spans: [name, start ns, children's ns, range]
_OPEN = {}       # name -> [calls, total ns, self ns] under the open root
_COUNTS = {}     # counter -> sum under the open root
_RECORDS = {}    # root name -> deque of its last RECENT records
_TOTALS = {}     # name -> [calls, total ns] under the closed roots


class _Span:
    """A named span; ``span(name)`` makes it, ``with`` times it."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        rf = None
        if _aprof._is_profiler_enabled:
            rf = _aprof.record_function(self.name)
            rf.__enter__()
        _STACK.append([self.name, perf_counter_ns(), 0, rf])
        return self

    def __exit__(self, *exc):
        t1 = perf_counter_ns()
        name, t0, child, rf = _STACK.pop()
        if rf is not None:
            rf.__exit__(None, None, None)
        dt = t1 - t0
        st = _OPEN.get(name)
        if st is None:
            _OPEN[name] = [1, dt, dt - child]
        else:
            st[0] += 1
            st[1] += dt
            st[2] += dt - child
        if _STACK:
            _STACK[-1][2] += dt
        else:
            _close_root(name, dt, rf is not None)
        return False


def _close_root(name: str, dt: int, profiled: bool) -> None:
    """``profiled``: a profiler recorded when the root opened."""
    rec = {"root": name, "host_ms": dt / 1e6,
           "spans": {n: {"calls": c, "host_ms": t / 1e6, "self_ms": s / 1e6}
                     for n, (c, t, s) in _OPEN.items()},
           "counts": dict(_COUNTS),
           "profiled": profiled or _aprof._is_profiler_enabled}
    for n, (c, t, _) in _OPEN.items():
        tot = _TOTALS.setdefault(n, [0, 0])
        tot[0] += c
        tot[1] += t
    _OPEN.clear()
    _COUNTS.clear()
    q = _RECORDS.get(name)
    if q is None:
        q = _RECORDS[name] = deque(maxlen=RECENT)
    q.append(rec)


def span(name: str) -> _Span:
    """The span ``name``, one object per name: make it once, at import."""
    s = _SPANS.get(name)
    if s is None:
        s = _SPANS[name] = _Span(name)
    return s


class Numbered:
    """Spans ``<prefix>0``, ``<prefix>1``, ... by index (a bounce's):
    the first ``n`` are made at once, a later one on its first use."""

    __slots__ = ("prefix", "spans")

    def __init__(self, prefix: str, n: int = 3):
        self.prefix = prefix
        self.spans = tuple(span(f"{prefix}{i}") for i in range(n))

    def __getitem__(self, i: int) -> _Span:
        if i < len(self.spans):
            return self.spans[i]
        return span(f"{self.prefix}{i}")


def count(name: str, n: int) -> None:
    """Add ``n``, an integer the host knows, to counter ``name`` of the
    open root; nothing where no span is open."""
    if _STACK:
        _COUNTS[name] = _COUNTS.get(name, 0) + n


def cat(tensors, dim: int = 0) -> torch.Tensor:
    """``torch.cat``, its output's bytes added to ``glue.cat_bytes`` (the
    copy reads as many)."""
    out = torch.cat(tensors, dim)
    count(CAT_BYTES, out.numel() * out.element_size())
    return out


def recent(root: str) -> list:
    """The last ``RECENT`` records of root span ``root``, oldest first."""
    return list(_RECORDS.get(root, ()))


def totals() -> dict:
    """name → (calls, host ms) of every span closed since start."""
    out = {n: [c, t] for n, (c, t) in _TOTALS.items()}
    for n, (c, t, _) in _OPEN.items():
        tot = out.setdefault(n, [0, 0])
        tot[0] += c
        tot[1] += t
    return {n: (c, t / 1e6) for n, (c, t) in out.items()}


def _sync():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class PhaseTimer:
    """Wall-clock per named phase, each a span between two synchronizes
    of the card; ``totals`` (s) and ``counts`` are this timer's part of
    ``totals()``; print with report()."""

    def __init__(self):
        self._base = {}   # name -> (calls, host ms) before its first phase

    @contextlib.contextmanager
    def phase(self, name: str):
        if name not in self._base:
            self._base[name] = totals().get(name, (0, 0.0))
        _sync()
        with span(name):
            try:
                yield
            finally:
                _sync()

    def _since(self, i: int) -> dict:
        now = totals()
        return {n: now.get(n, (0, 0.0))[i] - b[i]
                for n, b in self._base.items()}

    @property
    def totals(self) -> dict:
        return {n: ms / 1e3 for n, ms in self._since(1).items()}

    @property
    def counts(self) -> dict:
        return self._since(0)

    def report(self) -> str:
        totals_s, counts = self.totals, self.counts
        lines = []
        for name in sorted(totals_s, key=totals_s.get, reverse=True):
            lines.append(f"{name}: {totals_s[name]:.2f}s "
                         f"({counts[name]}x, "
                         f"{totals_s[name] / counts[name] * 1e3:.1f}"
                         " ms avg)")
        return "\n".join(lines)


class JsonlLogger:
    """Append-only JSON-lines metrics log."""

    def __init__(self, path: Optional[str]):
        self.path = path
        self._fh = open(path, "a") if path else None

    def log(self, **kv):
        if self._fh is None:
            return
        kv.setdefault("t", round(time.time(), 3))
        self._fh.write(json.dumps(kv) + "\n")
        self._fh.flush()

    def close(self):
        if self._fh:
            self._fh.close()


def device_summary(prof, wall_ms: float) -> dict:
    """Device time of a stopped ``torch.profiler`` profile: the busy ms
    (the sum over every kernel), its share of ``wall_ms``, the device
    operations, the ms and launches of the port's own kernels (those of
    ``_lib.kernel_names``), the ten kernels that take the most device
    time, every ``aten`` operator whose own kernels ran, by their device
    time (``ops``), and by the program's spans (``by_ranges``):
    ``ranges`` and ``idle_by_range``."""
    from materialist_tpu_torch.ops.kernels import _lib
    names = _lib.kernel_names()
    ev = [e for e in prof.key_averages() if e.device_type.name == "CUDA"
          and not getattr(e, "is_user_annotation", False)]
    busy_ms = sum(e.device_time_total for e in ev) / 1e3
    ours = [e for e in ev if "at::" not in e.key
            and any(k in e.key for k in names)]
    top = sorted(ev, key=lambda e: -e.device_time_total)[:10]
    ops = sorted((e for e in prof.key_averages()
                  if e.key.startswith("aten::")
                  and e.self_device_time_total > 0),
                 key=lambda e: -e.self_device_time_total)
    ranges, idle = by_ranges(prof.events())
    return dict(wall_ms=wall_ms, busy_ms=busy_ms, busy_share=busy_ms
                / wall_ms, device_ops=sum(e.count for e in ev),
                port_kernels_ms=sum(e.device_time_total for e in ours) / 1e3,
                port_kernel_launches=sum(e.count for e in ours),
                top=[(e.key[:60], e.count, e.device_time_total / 1e3)
                     for e in top],
                ops=[(e.key, e.count, e.self_device_time_total / 1e3)
                     for e in ops],
                ranges=ranges, idle_by_range=idle)


OUTSIDE = "outside"


def _chains_at(intervals, times) -> list:
    """For each of ``times``, the names of the ``intervals`` (start, end,
    name) that hold it, innermost first. The intervals nest, as one
    thread's spans do."""
    intervals = sorted(intervals, key=lambda iv: (iv[0], -iv[1]))
    order = sorted(range(len(times)), key=times.__getitem__)
    out = [()] * len(times)
    stack, i = [], 0
    for q in order:
        t = times[q]
        while i < len(intervals) and intervals[i][0] <= t:
            while stack and stack[-1][1] < intervals[i][0]:
                stack.pop()
            stack.append(intervals[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out[q] = tuple(iv[2] for iv in reversed(stack))
    return out


def by_ranges(events) -> tuple:
    """(``ranges``, ``idle_by_range``) of a profile's events, by the
    program's spans (their ``record_function`` ranges).

    ``ranges``: span name → device ms and operations of the kernels whose
    innermost span it is (``device_ms``, ``ops``), and of every kernel
    inside it (``total_ms``). A kernel's spans are those that enclose the
    runtime call that launched it (the profiler's launch correlation: the
    kernel's id is its ``cu*`` call's; then ``cpu_parent``); a launch of
    the autograd engine's own thread, with no span among its parents,
    takes the spans the program's thread had open at the launch's host
    time. ``outside``: kernels in no span, or whose launch the profile
    lacks.

    ``idle_by_range``: span name → ms of the gaps between the union of
    the kernels' intervals, from the first kernel or span to the last,
    each gap given to the innermost span the host was in at its
    midpoint."""
    cpu, kernels = [], []
    for e in events:
        if e.device_type.name == "CPU":
            cpu.append(e)
        elif e.device_type.name == "CUDA" and not getattr(
                e, "is_user_annotation", False):
            kernels.append(e)
    spans = [(e.time_range.start, e.time_range.end, e.name) for e in cpu
             if e.name in _SPANS]
    # the runtime calls: their ids are the launch correlation's, which
    # other operations' ids may repeat
    launcher = {e.id: e for e in cpu if e.name.startswith("cu")}
    chains, by_time = [()] * len(kernels), []
    for j, k in enumerate(kernels):
        op = launcher.get(k.id)
        chain = []
        e = op
        while e is not None:
            if e.name in _SPANS:
                chain.append(e.name)
            e = e.cpu_parent
        if chain:
            chains[j] = tuple(chain)
        elif op is not None:
            by_time.append((j, op.time_range.start))
    for (j, _), chain in zip(by_time, _chains_at(spans,
                                                 [t for _, t in by_time])):
        chains[j] = chain
    ranges = {}
    for k, chain in zip(kernels, chains):
        ms = (k.time_range.end - k.time_range.start) / 1e3
        chain = chain or (OUTSIDE,)
        for name in set(chain):
            r = ranges.setdefault(name, dict(device_ms=0.0, ops=0,
                                             total_ms=0.0))
            r["total_ms"] += ms
        r = ranges[chain[0]]
        r["device_ms"] += ms
        r["ops"] += 1

    busy = []
    for s, e in sorted((k.time_range.start, k.time_range.end)
                       for k in kernels):
        if busy and s <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], e)
        else:
            busy.append([s, e])
    ends = [iv[0] for iv in spans] + [iv[1] for iv in spans] + [
        t for iv in busy for t in iv]
    gaps = []
    if ends:
        at, hi = min(ends), max(ends)
        for s, e in busy + [[hi, hi]]:
            if s > at:
                gaps.append((at, s))
            at = max(at, e)
    idle = {}
    for (s, e), chain in zip(gaps, _chains_at(
            spans, [0.5 * (s + e) for s, e in gaps])):
        name = chain[0] if chain else OUTSIDE
        idle[name] = idle.get(name, 0.0) + (e - s) / 1e3
    return ranges, idle


SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize")


def syncs_by_range(events) -> dict:
    """Span name → the runtime calls of a profile's events that wait for
    the card (``SYNCS``) whose innermost open span it is (``outside``:
    none open)."""
    cpu = [e for e in events if e.device_type.name == "CPU"]
    spans = [(e.time_range.start, e.time_range.end, e.name) for e in cpu
             if e.name in _SPANS]
    out = {}
    for chain in _chains_at(spans, [e.time_range.start for e in cpu
                                    if e.name in SYNCS]):
        name = chain[0] if chain else OUTSIDE
        out[name] = out.get(name, 0) + 1
    return out


def gather_sector_bytes(idx, k: int, sector: int = 32) -> int:
    """The least bytes device memory moves for the row gather
    ``out[q] = table[idx[q]]`` from a float32 table (N, k) whose base lies
    on a sector boundary: each distinct ``sector``-byte sector of the
    table that a fetched row touches, read once however many queries
    share it, plus the index and the output, each moved once. The card
    reads device memory in 32-byte sectors, so a row that straddles a
    boundary costs two, and rows fetched one in several cost a sector
    each."""
    flat = idx.reshape(-1)
    m = flat.numel()
    if m == 0:
        return 0
    row_b = 4 * k
    rows = torch.unique(flat.long())
    first = rows * row_b // sector
    last = (rows * row_b + row_b - 1) // sector
    span = int((last - first).max()) + 1
    secs = first[:, None] + torch.arange(span, device=rows.device)
    # row by row the sectors never fall, so equal ones are neighbours
    secs = secs[secs <= last[:, None]]
    n_sec = int(torch.unique_consecutive(secs).numel())
    return n_sec * sector + m * (flat.element_size() + row_b)
