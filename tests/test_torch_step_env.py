"""Whole-slice parity, envmap phase: one step of make_phase_step in both
packages from the same converted envmap PosMLP, the same keys and the same
32² scene (4 spp, chunk 2, max_depth 3, march steps 6/4, film jitter 0.5);
the JAX package takes its fused shade in Pallas interpret mode. The
envmap gradient is read through a zero offset added to the map. Set-up
and bounds in torch_step_common.py."""

import pytest
import torch

from torch_step_common import env_phase_case, make_scene

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def scene():
    return make_scene()


def test_env_phase_step(scene):
    env_phase_case(scene)
