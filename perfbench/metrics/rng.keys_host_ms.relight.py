"""``rng.keys_host_ms.relight``: host ms a relight pass spends hashing
keys on the host (the program's ``rng.keys`` spans, ``split`` and
``fold_in``, under ``forward.pass``), median over the window's passes."""

from perfbench.metrics._program import span_ms_per_unit


def read(ctx):
    return span_ms_per_unit(ctx, "pass", "forward.pass", "rng.keys")
