"""``device.peak_gib.finetune``: the card's peak allocated memory over
set-up and the window, in GiB."""


def read(ctx):
    if ctx["unit"] != "step" or not ctx["peak_bytes"]:
        return None
    return ctx["peak_bytes"] / 2 ** 30
