"""``kernels_roofline.inverse``: the program's kernels' share of their
roofline in the profiled step, in % (``_common.roofline_share``)."""

from perfbench.metrics._common import profiled, roofline_share


def read(ctx):
    if not profiled(ctx, "step", "port_us"):
        return None
    return roofline_share(ctx["profile"])
