"""Whole-step parity with wavefront compaction: the env and the "rm"
phase step of torch_step_common.py (32², 4 spp, chunk 2, march steps 6/4,
film jitter 0.5) at max_depth 4 with ``compact_caps=(0.5, 0.25)`` in both
packages, and the loop's handling of ``InverseOptions.compact`` on the
CPU. Bounds in torch_step_common.py: the uncompacted step tests' own, and
the loss within 1e-4 relative (measured: 0 and 6.5e-7)."""

import pytest
import torch

from materialist_tpu_torch.camera import Camera
from torch_step_common import (RES, env_phase_case, make_scene,
                               material_phase_case)

torch.set_num_threads(2)
CAPS = dict(max_depth=4, compact_caps=(0.5, 0.25))


@pytest.fixture(scope="module")
def scene():
    return make_scene()


def test_env_phase_step_compacted(scene):
    loss_t, loss_j = env_phase_case(scene, **CAPS)
    assert abs(loss_t - loss_j) <= 1e-4 * abs(loss_j)


def test_material_phase_step_compacted(scene):
    loss_t, loss_j = material_phase_case(scene, **CAPS)
    assert abs(loss_t - loss_j) <= 1e-4 * abs(loss_j)


@pytest.mark.parametrize("caps", [None, (0.5, 0.25)],
                         ids=["cpu_default_off", "caps_passed_in"])
def test_optimize_compaction_on_cpu(scene, tmp_path, capsys, caps):
    """On the CPU ``compact=True`` probes nothing and leaves compaction
    off; caps passed in are used, reported and tracked."""
    from materialist_tpu_torch.opt.loop import InverseOptions, optimize
    sc = scene
    mat = {"albedo": sc["alb"], "roughness": sc["rough"],
           "metallic": sc["met"], "normal": sc["nrm"], "gt_image": sc["gt"]}
    opts = InverseOptions(num_epochs=1, spp=4, chunk=2, march_steps=6,
                          shadow_steps=4, frame_every=0, max_loops=2,
                          snapshot_every=0)
    assert opts.compact
    best = optimize(sc["gt_buf"], Camera(RES, RES), mat, str(tmp_path),
                    opts, device="cpu", compact_caps=caps)
    out = capsys.readouterr().out
    if caps is None:
        assert best["compact_caps"] == () and best["cap_util"] == {}
        assert "compaction caps" not in out
    else:
        assert best["compact_caps"] == caps
        assert f"wavefront compaction caps: {caps}" in out
        assert "cap_util[b1=" in out
        assert sorted(best["cap_util"]) == [1, 2]
        assert all(0.0 < u < 0.999 for u in best["cap_util"].values())
    assert torch.isfinite(best["rendered_img"]).all()
