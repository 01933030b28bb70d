"""Seeded scene directories for the forward-path tests (numpy and the
port's own readers and writers only, so that the tests of the card can
use them too): the layout the CLIs read, ``<root>/<name>/depthPred.exr``
and ``best_results/{albedo,roughness,metallic,normal}.exr, envmap.hdr,
mask.png, bg.png``, and the insertion meshes ``oi.ply`` (a sphere) and
``oi2.ply`` (a quad)."""

import os

import numpy as np

from materialist_tpu_torch.camera import Camera
from materialist_tpu_torch.geometry.ply import write_ply
from materialist_tpu_torch.io import exr as exr_io
from materialist_tpu_torch.io import image as image_io
from materialist_tpu_torch.render.scene import make_gbuffer
from materialist_tpu_torch.utils.seeded import quad_mesh, sphere_mesh


def write_scene(dst, depth, albedo, rough, metal, env, bg=None, mask=None,
                normal=None):
    """Write one scene dir. ``normal`` defaults to the geometric normals
    of the flipped depth map (what an optimization with mesh normals
    leaves in best_results)."""
    br = os.path.join(dst, "best_results")
    os.makedirs(br, exist_ok=True)
    res = depth.shape[0]
    exr_io.write(os.path.join(dst, "depthPred.exr"),
                 depth[..., None].astype(np.float32))
    if normal is None:
        normal = make_gbuffer(depth, Camera(res, res), flip_depth=True,
                              device="cpu").normal_geo.numpy()
    for name, x in (("albedo", albedo), ("roughness", rough),
                    ("metallic", metal), ("normal", normal)):
        exr_io.write(os.path.join(br, f"{name}.exr"), x.astype(np.float32))
    image_io.write(os.path.join(br, "envmap.hdr"), env.astype(np.float32))
    if bg is not None:
        image_io.write(os.path.join(br, "bg.png"), bg)
    if mask is not None:
        image_io.write(os.path.join(br, "mask.png"),
                       np.repeat(mask.astype(np.float32)[..., None], 3, -1),
                       linear_input=False)
    return dst


def seeded_scene_dir(root, name, res=32, seed=0):
    """A bumpy seeded scene with a rectangular mask, a background image,
    a sphere (oi.ply) and a quad (oi2.ply) in front of the heightfield."""
    r = np.random.default_rng(seed)
    depth = (2.0 + 0.3 * r.uniform(size=(res, res))).astype(np.float32)
    depth[res // 5: res // 2, res // 4: 2 * res // 3] += 0.5   # nearer box
    mask = np.zeros((res, res), bool)
    mask[res // 4: 3 * res // 4, res // 3: 2 * res // 3] = True
    dst = write_scene(
        os.path.join(str(root), name), depth,
        r.uniform(0.2, 0.9, (res, res, 3)), r.uniform(0.2, 0.9, (res, res, 1)),
        r.uniform(0.0, 0.5, (res, res, 1)),
        (r.uniform(size=(16, 32, 3)) + 0.1) * 2,
        bg=r.uniform(0.05, 0.9, (res, res, 3)).astype(np.float32), mask=mask)
    write_ply(os.path.join(dst, "oi.ply"),
              *sphere_mesh([0.1, 0.05, -1.5], 0.2))
    write_ply(os.path.join(dst, "oi2.ply"),
              *quad_mesh([-0.4, -0.35, -1.9], [0.3, 0.0, 0.1],
                         [0.0, 0.25, 0.1]))
    return dst


def trans_golden_scene_dir(root, name="transfix", res=64):
    """The 64x64 fixture of the transparency-edit golden
    (tests/golden/trans_edit_64.png): a sloped plane, a centre-square mask
    and a red-dominant ramp background."""
    yy = np.linspace(0, 1, res, dtype=np.float32)[:, None]
    xx = np.linspace(0, 1, res, dtype=np.float32)[None, :]
    depth = np.broadcast_to(2.0 + 0.8 * yy, (res, res)).astype(np.float32)
    bg = np.stack([np.broadcast_to(0.4 + 0.6 * xx, (res, res)),
                   np.broadcast_to(0.1 + 0.2 * yy, (res, res)),
                   np.full((res, res), 0.15, np.float32)], -1)
    mask = np.zeros((res, res), bool)
    mask[16:48, 16:48] = True
    return write_scene(
        os.path.join(str(root), name), depth,
        np.full((res, res, 3), 0.45, np.float32),
        np.full((res, res, 1), 0.6, np.float32),
        np.full((res, res, 1), 0.1, np.float32),
        np.full((16, 32, 3), 0.5, np.float32), bg=bg, mask=mask)
