"""Profiling utilities (counterpart of ``materialist_tpu/utils/profiling.py``):
a phase timer that aggregates wall-clock per optimization phase (it
synchronizes the card at both ends, so a phase's time is its device
time), a JSON-lines log, and the device-time summary of a
``torch.profiler`` profile."""

from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict
from typing import Optional

import torch


def _sync():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class PhaseTimer:
    """Accumulates wall-clock per named phase; print with report()."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        _sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            _sync()
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            lines.append(f"{name}: {self.totals[name]:.2f}s "
                         f"({self.counts[name]}x, "
                         f"{self.totals[name] / self.counts[name] * 1e3:.1f}"
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
    time, and every ``aten`` operator whose own kernels ran, by their
    device time (``ops``)."""
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
    return dict(wall_ms=wall_ms, busy_ms=busy_ms, busy_share=busy_ms
                / wall_ms, device_ops=sum(e.count for e in ev),
                port_kernels_ms=sum(e.device_time_total for e in ours) / 1e3,
                port_kernel_launches=sum(e.count for e in ours),
                top=[(e.key[:60], e.count, e.device_time_total / 1e3)
                     for e in top],
                ops=[(e.key, e.count, e.self_device_time_total / 1e3)
                     for e in ops])
