"""The model operations of one MaterialNet fine-tuning step, counted from
the configuration's widths and the batch's shape (never by hooking the
program). Dense layers 2·M·K·N, attention 4·B·N²·C (QKᵀ and PV), a
convolution 2·C_in·k²·C_out·H_out·W_out·B, a transposed one 2·C_in·k²·C_out
·H_in·W_in·B; elementwise work (norms, GELU, softmax, the resizes, the
losses, the optimiser) is left out, and so are the resizes' matrix
backwards, which compute an interpolation, not the model.

A step is the forward of the encoder and of both heads; LPIPS-alex on
the predicted and the target albedo; the weight gradients of the trained
layers (the depth head's ``scratch.output_conv2`` and the material head's
``scratch``); and the input gradients on the way from the loss back to
the first trained layer: every convolution of the material head's
``scratch`` but the four ``layer{i}_rn`` (whose inputs come from frozen
layers), the depth head's last convolution, and LPIPS's five
convolutions on the predicted albedo. A layer's weight or input gradient
costs what its forward does."""

from __future__ import annotations

PATCH = 14
# LPIPS-alex's convolutions: (C_out, kernel, stride, padding), a 3x3
# max-pool of stride 2 before the second and the third
ALEX = ((64, 11, 4, 2), (192, 5, 1, 2), (384, 3, 1, 1), (256, 3, 1, 1),
        (256, 3, 1, 1))


def _out(n, k, s, p):
    return (n + 2 * p - k) // s + 1


def _conv(cin, cout, k, hw):
    return 2 * cin * k * k * cout * hw[0] * hw[1]


def encoder_flops(conf, h, w):
    """One image's encoder forward: the patch embedding and every block
    (all of them run, whatever layers the heads read)."""
    c, gh, gw = conf["embed_dim"], h // PATCH, w // PATCH
    n = gh * gw + 1
    mlp = int(c * conf["mlp_ratio"])
    block = 2 * n * c * (3 * c + c + 2 * mlp) + 4 * n * n * c
    return _conv(3, c, PATCH, (gh, gw)) + conf["enc_depth"] * block


def head_layers(conf, h, w, out_ch):
    """One image's DPT head as (name, forward operations), the names
    those of the state dict under the head."""
    c, f, oc = conf["embed_dim"], conf["features"], conf["out_channels"]
    gh, gw = h // PATCH, w // PATCH
    sizes = [(4 * gh, 4 * gw), (2 * gh, 2 * gw), (gh, gw),
             (_out(gh, 3, 2, 1), _out(gw, 3, 2, 1))]
    layers = []
    for i in range(4):
        layers.append((f"projects.{i}", _conv(c, oc[i], 1, (gh, gw))))
    layers.append(("resize_layers.0", _conv(oc[0], oc[0], 4, (gh, gw))))
    layers.append(("resize_layers.1", _conv(oc[1], oc[1], 2, (gh, gw))))
    layers.append(("resize_layers.3", _conv(oc[3], oc[3], 3, sizes[3])))
    for i in range(4):
        layers.append((f"scratch.layer{i + 1}_rn",
                       _conv(oc[i], f, 3, sizes[i])))
    # refinenet i works at sizes[i - 1] and writes at the next size up
    out_at = {4: sizes[2], 3: sizes[1], 2: sizes[0],
              1: (2 * sizes[0][0], 2 * sizes[0][1])}
    for i in (4, 3, 2, 1):
        units = (2,) if i == 4 else (1, 2)
        for u in units:
            for k in (1, 2):
                layers.append((f"scratch.refinenet{i}.resConfUnit{u}.conv{k}",
                               _conv(f, f, 3, sizes[i - 1])))
        layers.append((f"scratch.refinenet{i}.out_conv",
                       _conv(f, f, 1, out_at[i])))
    layers.append(("scratch.output_conv1", _conv(f, f // 2, 3, out_at[1])))
    layers.append(("scratch.output_conv2.0", _conv(f // 2, 32, 3, (h, w))))
    layers.append(("scratch.output_conv2.2", _conv(32, out_ch, 1, (h, w))))
    return layers


def lpips_layers(h, w):
    """One image's LPIPS-alex trunk as forward operations, layer by
    layer."""
    cin, hw, out = 3, (h, w), []
    for k, (cout, ker, s, p) in enumerate(ALEX):
        if k in (1, 2):
            hw = (_out(hw[0], 3, 2, 0), _out(hw[1], 3, 2, 0))
        hw = (_out(hw[0], ker, s, p), _out(hw[1], ker, s, p))
        out.append(_conv(cin, cout, ker, hw))
        cin = cout
    return out


def forward_flops(conf, images, h, w):
    """The net's forward on ``images`` images of h × w: {"encoder",
    "depth_head", "material_head"}."""
    return {"encoder": images * encoder_flops(conf, h, w),
            "depth_head": images * sum(
                f for _, f in head_layers(conf, h, w, 1)),
            "material_head": images * sum(
                f for _, f in head_layers(conf, h, w, 8))}


def step_flops(conf, images, h, w):
    """The parts of one fine-tuning step on ``images`` images of h × w, and
    their sum under "total"."""
    out = forward_flops(conf, images, h, w)
    lp = sum(lpips_layers(h, w))
    out["lpips"] = 2 * images * lp
    depth = dict(head_layers(conf, h, w, 1))
    material = head_layers(conf, h, w, 8)
    trained = [f for n, f in material if n.startswith("scratch.")]
    trained += [depth["scratch.output_conv2.0"],
                depth["scratch.output_conv2.2"]]
    out["weight_grad"] = images * sum(trained)
    out["input_grad"] = images * (
        sum(f for n, f in material if n.startswith("scratch.")
            and "_rn" not in n)
        + depth["scratch.output_conv2.2"] + lp)
    out["total"] = sum(out.values())
    return out
