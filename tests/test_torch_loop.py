"""The port's loop and package boundaries on the CPU: ``optimize`` writes
the best_results layout (as tests/test_cli_contract.py checks for the JAX
package), the entry points refuse to run without CUDA unless asked for
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


def test_unported_options_raise(scene, tmp_path):
    from materialist_tpu_torch.cli import inverse
    fixture = REPO / "output_imgs" / "runs" / "photo_e2e" / "gt_image.exr"
    with pytest.raises(NotImplementedError, match="MaterialNet"):
        inverse.main(["--img_inverse_path", str(fixture), "--save_name",
                      str(tmp_path), "--opt_src", "a", "--device", "cpu"])


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
