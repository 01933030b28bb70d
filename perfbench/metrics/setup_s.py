"""``setup_s``: process start to the window's start (imports, the card,
the kernel build, inputs, the program's objects, the warm-up units)."""


def read(ctx):
    return ctx["setup_s"]
