"""``render.denoise_ms.relight``: mean synchronised span of the pass's
à-trous denoise call (``render/forward.py`` → ``render/denoise.py``) in
the traced window."""

from perfbench.metrics._common import span_ms


def read(ctx):
    return span_ms(ctx, "denoise")
