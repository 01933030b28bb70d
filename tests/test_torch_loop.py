"""The port's loop and package boundaries on the CPU: ``optimize`` writes
the best_results layout (as tests/test_cli_contract.py checks for the JAX
package), the inverse CLI's predict branch hands ``optimize`` what the JAX
CLI's does, the entry points refuse to run without CUDA unless asked for
the CPU, and no module of the port (nor chip_smoke.py) imports JAX, Flax,
optax or the JAX package."""

import ast
import os
import pathlib

import numpy as np
import pytest
import torch

from materialist_tpu_torch.camera import Camera
from materialist_tpu_torch.opt.step import make_phase_step as tmake
from materialist_tpu_torch.render.shader import RenderConfig
from torch_step_common import CFG, RES, make_scene

torch.set_num_threads(2)
REPO = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "materialist_tpu")


@pytest.fixture(scope="module")
def scene():
    return make_scene()


def test_optimize_cpu_layout(scene, tmp_path):
    from materialist_tpu_torch.opt.loop import InverseOptions, optimize
    sc = scene
    mat = {"albedo": sc["alb"], "roughness": sc["rough"],
           "metallic": sc["met"], "normal": sc["nrm"], "gt_image": sc["gt"]}
    opts = InverseOptions(num_epochs=2, spp=4, chunk=2, march_steps=6,
                          shadow_steps=4, frame_every=0, max_loops=2,
                          snapshot_every=0)
    best = optimize(sc["gt_buf"], Camera(RES, RES), dict(mat),
                    str(tmp_path), opts, device="cpu")
    assert np.isfinite(best["loss"])
    br = tmp_path / "best_results"
    for name in ("albedo.exr", "roughness.exr", "metallic.exr",
                 "normal.exr", "rendered_img.exr", "envmap.hdr"):
        assert (br / name).exists(), name
    assert (tmp_path / "final_envmap.hdr").exists()
    assert os.path.getsize(tmp_path / "metrics.jsonl") > 0


def test_entry_points_refuse_cpu_without_request(scene, tmp_path,
                                                 monkeypatch):
    from materialist_tpu_torch.opt.loop import InverseOptions, optimize
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmake(RenderConfig(**CFG), Camera(RES, RES), scene["gt_buf"],
              lambda p, e: e, lambda m, i, e: (i.sum(), None))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        optimize(scene["gt_buf"], Camera(RES, RES), {}, str(tmp_path),
                 InverseOptions())
    from materialist_tpu_torch.cli import inverse
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        inverse.main(["--img_inverse_path", "x.exr", "--save_name",
                      str(tmp_path), "--opt_src", "skip", "--opt_order",
                      "skip"])
    from materialist_tpu_torch.models.matnet import MatNetInference
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MatNetInference()


def test_predict_branch_matches_jax(tmp_path, monkeypatch):
    """``--opt_src a --opt_order rm a`` on the in-repo photo and
    checkpoint, through both packages' ``inverse_image`` (the port on the
    CPU) with ``optimize`` replaced by a recorder: the same prediction
    files, the same config.json but for its timestamp and input path,
    and the same clipped maps and options handed to ``optimize``."""
    import dataclasses
    import json

    from materialist_tpu.cli import inverse as jinv
    from materialist_tpu_torch.cli import inverse as tinv
    from materialist_tpu_torch.io import exr as exr_io

    photo = REPO / "output_imgs" / "runs" / "photo_e2e" / "gt_image.exr"
    weights = str(REPO / "runs" / "matnet_r5" / "matnet_scratch.npz")
    seen = {}

    def recorder(tag):
        def optimize(gbuf, cam, mat, output_dir, opts, **kw):
            seen[tag] = ({k: np.asarray(v) for k, v in mat.items()},
                         dataclasses.asdict(opts))
            return {}
        return optimize

    monkeypatch.setattr(tinv, "optimize", recorder("port"))
    monkeypatch.setattr(jinv, "optimize", recorder("jax"))
    out = {}
    for tag in ("port", "jax"):
        root = tmp_path / tag
        root.mkdir()
        img = root / "gt_image.exr"
        img.write_bytes(photo.read_bytes())
        if tag == "port":
            tinv.main(["--img_inverse_path", str(img), "--save_name",
                       "photo", "--save_path", str(root), "--opt_src", "a",
                       "--opt_order", "rm", "a", "--opt_env_from", "2",
                       "--weights", weights, "--device", "cpu"])
        else:
            jinv.inverse_image(str(img), "photo", "a", ["rm", "a"],
                               opt_env_from=2, save_path=str(root),
                               weights_path=weights)
        out[tag] = root / "photo"

    names = ("albedoPred.exr", "normalPred.exr", "roughnessPred.png",
             "metallicPred.png", "depthPred.exr", "gt_image.exr",
             "gt_image.png", "config.json", "photo.ply")
    for name in names:
        assert (out["port"] / name).exists(), name
    for name in ("albedoPred.exr", "normalPred.exr", "depthPred.exr"):
        a = exr_io.read(str(out["port"] / name))
        b = exr_io.read(str(out["jax"] / name))
        assert a.shape == b.shape and float(np.abs(a - b).max()) <= 1e-3

    def config(tag):
        with open(out[tag] / "config.json") as f:
            c = json.load(f)
        return {k: v for k, v in c.items()
                if k not in ("timestamp", "img_path")}
    assert config("port") == config("jax")

    (mat_t, opts_t), (mat_j, opts_j) = seen["port"], seen["jax"]
    assert opts_t == {k: v for k, v in opts_j.items() if k in opts_t}
    for k in ("albedo", "roughness", "metallic", "normal", "gt_image"):
        assert mat_t[k].shape == mat_j[k].shape, k
        assert float(np.abs(mat_t[k] - mat_j[k]).max()) <= 1e-3, k
    assert mat_t["roughness"].min() >= 0.07
    assert 0 <= mat_t["albedo"].min() and mat_t["albedo"].max() <= 1


@pytest.mark.parametrize("kind", ["absolute", "nested"])
def test_mesh_ply_path_matches_jax(tmp_path, monkeypatch, kind):
    """The resume branch of both packages' inverse CLI writes the depth
    mesh to ``os.path.join(output_dir, f"{save_name}.ply")``: beside the
    output dir for an absolute ``--save_name /abs/OUT``, under
    ``output_dir/a/`` for a nested ``a/b``; a mesh already there is kept."""
    from materialist_tpu.cli import inverse as jinv
    from materialist_tpu_torch.cli import inverse as tinv
    from materialist_tpu_torch.io import exr as exr_io
    from torch_scene_dirs import write_scene

    r = np.random.default_rng(0)
    res = 512
    depth = (2.0 + 0.3 * r.uniform(size=(res, res))).astype(np.float32)
    maps = (r.uniform(0.2, 0.9, (res, res, 3)), r.uniform(0.2, 0.9,
                                                          (res, res, 1)),
            r.uniform(0.0, 0.5, (res, res, 1)),
            r.uniform(0.1, 2.0, (16, 32, 3)))
    monkeypatch.setattr(tinv, "optimize", lambda *a, **k: {})
    monkeypatch.setattr(jinv, "optimize", lambda *a, **k: {})
    written = {}
    for tag in ("port", "jax"):
        root = tmp_path / tag
        if kind == "absolute":
            save_name, save_path = str(root / "OUT"), None
            out_dir = root / "OUT"
        else:
            save_name, save_path = "a/b", str(root)
            out_dir = root / "a" / "b"
            (out_dir / "a").mkdir(parents=True)
        write_scene(str(out_dir), depth, *maps)
        img = str(out_dir / "gt_image.exr")
        exr_io.write(img, r.uniform(size=(res, res, 3)).astype(np.float32))
        if tag == "port":
            port_args = ["--img_inverse_path", img, "--save_name", save_name,
                         "--opt_src", "skip", "--opt_order", "skip",
                         "--device", "cpu"] + (
                             ["--save_path", save_path] if save_path else [])
            tinv.main(port_args)
        else:
            jinv.inverse_image(img, save_name, "skip", ["skip"],
                               save_path=save_path)
        written[tag] = sorted(str(p.relative_to(root))
                              for p in root.rglob("*.ply"))
    want = ["OUT.ply"] if kind == "absolute" else ["a/b/a/b.ply"]
    assert written["port"] == written["jax"] == want
    mesh = tmp_path / "port" / want[0]
    stamp = mesh.stat().st_mtime_ns
    tinv.main(port_args)
    assert mesh.stat().st_mtime_ns == stamp


@pytest.mark.parametrize("kw", [{"compact_caps": (0.5,)},
                                {"march_impl": "mip"},
                                {"march_impl": "exact"}],
                         ids=["compact_caps", "march_impl_mip",
                              "march_impl_exact"])
def test_ported_options_build(scene, kw):
    ph = tmake(RenderConfig(**CFG, **kw), Camera(RES, RES), scene["gt_buf"],
               lambda p, e: e, lambda m, i, e: (i.sum(), None), device="cpu")
    assert ph.cfg.compact_caps == kw.get("compact_caps", ())
    assert ph.cfg.march_impl == kw.get("march_impl", "fused")


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax():
    pkg = REPO / "materialist_tpu_torch"
    # build/ holds generated output, not the package's sources
    files = sorted(f for f in pkg.rglob("*.py")
                   if "build" not in f.relative_to(pkg).parts)
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 30
    bad = [(str(f.relative_to(REPO)), m) for f in files
           for m in _imports(f)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"forbidden imports: {bad}"
