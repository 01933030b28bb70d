"""Profiling utilities (counterpart of ``materialist_tpu/utils/profiling.py``):
a phase timer that aggregates wall-clock per optimization phase (it
synchronizes the card at both ends, so a phase's time is its device
time) and a JSON-lines log."""

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
