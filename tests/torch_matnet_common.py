"""Shared set-up of the MaterialNet parity tests (test_torch_matnet.py and
the training tests): seeded Flax parameters without a Flax ``init``, a
tiny MaterialNet and seeded training batches."""

import jax
import numpy as np

from materialist_tpu_torch.models.train import to_nchw

# the training tests' MaterialNet: 4 encoder layers, each a level of the
# heads (fewer cannot give the heads four distinct levels)
TINY_TRAIN = dict(features=16, out_channels=(8, 16, 32, 64),
                  layer_idx=(0, 1, 2, 3), embed_dim=48, enc_depth=4,
                  num_heads=2)


def seeded_params(module, seed, *args):
    """Parameters for ``module.init(key, *args)``'s tree, made from a
    seed with numpy (the shapes come from ``jax.eval_shape``, so no init
    runs): kernels N(0, 1/fan_in), LayerNorm scales and LayerScale gammas
    1 + N(0, 0.05²), everything else N(0, 0.05²). No bias is 0 and no
    scale 1, so a transposed or misplaced leaf shows."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0),
                                                *args))["params"]

    def fill(path, s):
        name = path[-1].key
        if name == "kernel":
            return rng.normal(0, 1 / np.sqrt(np.prod(s.shape[:-1])),
                              s.shape).astype(np.float32)
        base = 1.0 if name in ("scale", "gamma") else 0.0
        return (base + rng.normal(0, 0.05, s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def lift_output_biases(params):
    """Lift the heads' last biases (depth by 1, material by 0.3) so that
    no predicted map sits at its ReLU or at the depth loss's clamp, where
    a last-bit difference between the packages flips a gradient."""
    params["depth_head"]["output_conv2_2"]["bias"] += 1.0
    params["material_head"]["output_conv2_2"]["bias"] += 0.3
    return params


def seeded_batch(seed, b=2, hw=(28, 42)):
    """An NHWC batch: image, albedo, roughness, metallic in [0, 1], unit
    normals, depth in 0.5–5 with its first rows (30) outside the valid
    range."""
    r = np.random.default_rng(seed)
    n = r.standard_normal((b,) + hw + (3,))
    depth = r.uniform(0.5, 5.0, (b,) + hw + (1,))
    depth[:, :3] = 30.0
    return {k: v.astype(np.float32) for k, v in (
        ("im", r.uniform(size=(b,) + hw + (3,))),
        ("albedo", r.uniform(size=(b,) + hw + (3,))),
        ("roughness", r.uniform(size=(b,) + hw + (1,))),
        ("metallic", r.uniform(size=(b,) + hw + (1,))),
        ("normal", n / np.linalg.norm(n, axis=-1, keepdims=True)),
        ("depth", depth))}


def nchw(batch):
    """An NHWC numpy batch as NCHW CPU tensors."""
    return to_nchw(batch, "cpu")
