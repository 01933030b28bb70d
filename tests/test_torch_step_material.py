"""Whole-slice parity, "rm" material phase: one step of make_phase_step
in both packages from the same converted material PosMLP, the same keys
and the same 32² scene (4 spp, chunk 2, max_depth 3, march steps 6/4,
film jitter 0.5); the JAX package takes its fused shade in Pallas
interpret mode. Map gradients are read through zero offsets added to the
maps. Bounds in torch_step_common.py.

The net's head is perturbed only slightly, so roughness stays >= 0.13.
At the 0.07 floor the GGX denominator of a half-vector built from bf16/f16
records (NoH a hair above 1) cancels to ~0 in both packages
(brdf.py:68, shadebounce.py:82), and the gradient there is rounding
noise that neither package reproduces in the other."""

import pytest
import torch

from torch_step_common import make_scene, material_phase_case

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def scene():
    return make_scene()


def test_material_phase_step(scene):
    material_phase_case(scene)
