"""What the readers of the program's own spans and counters share. The
program keeps a record of each root span it closes
(``materialist_tpu_torch/utils/profiling.py``: ``recent``); a reader takes
those made while no profiler recorded, the last as many as the window
had units, which are the window's. A program without the store gives
nothing to read."""

from __future__ import annotations

import statistics


def window_records(ctx, unit, root):
    """The window's records of root span ``root``, oldest first, or None
    where the cell's unit is not ``unit`` or nothing was recorded."""
    n = len(ctx.get("unit_ms") or ())
    if ctx.get("unit") != unit or n == 0:
        return None
    try:
        from materialist_tpu_torch.utils.profiling import recent
    except ImportError:
        return None
    recs = [r for r in recent(root) if not r["profiled"]][-n:]
    return recs or None


def median(values):
    return statistics.median(values) if values else None


def counted_per_unit(ctx, unit, roots, counter):
    """Median over the window's units of ``counter`` summed over the
    records of ``roots`` (one each a unit), or None."""
    per_root = [window_records(ctx, unit, r) for r in roots]
    if any(recs is None for recs in per_root):
        return None
    n = min(len(recs) for recs in per_root)
    return median([sum(recs[len(recs) - n + i]["counts"].get(counter, 0)
                       for recs in per_root) for i in range(n)])


def span_ms_per_unit(ctx, unit, root, name):
    """Median over the window's units of the total host ms of span
    ``name`` under root ``root``, or None."""
    recs = window_records(ctx, unit, root)
    if recs is None:
        return None
    return median([r["spans"].get(name, {}).get("host_ms", 0.0)
                   for r in recs])
