"""Each fault a cell can have, planted in the program underneath a run
that otherwise runs as the benchmark's (CPU, tiny film): the run's check
must come out not correct. The faults: a step that leaves its state
unchanged, half of the samples left out with the mean over the rest, an
answer altered where it is produced (a film row of each chunk's image
doubled), and for the relight passes a stale image."""

from __future__ import annotations

import pytest
import torch

from perfbench.tests.test_perfbench_run_cpu import run_cell


def _half_chunks(monkeypatch, module):
    orig = module.n_chunks_of
    monkeypatch.setattr(module, "n_chunks_of",
                        lambda cfg: max(orig(cfg) // 2, 1))


def _altered(monkeypatch, module, name):
    orig = getattr(module, name)

    def wrapped(*a, **k):
        img = orig(*a, **k)
        return torch.cat([img[:1] * 2.0, img[1:]])
    monkeypatch.setattr(module, name, wrapped)


def fault_unchanged_step(monkeypatch):
    from materialist_tpu_torch.opt import schedules
    monkeypatch.setattr(schedules.Adam, "step",
                        lambda self, params, grads, state: True)


def fault_half_step(monkeypatch):
    from materialist_tpu_torch.opt import step
    _half_chunks(monkeypatch, step)


def fault_altered_step(monkeypatch):
    from materialist_tpu_torch.opt import step
    _altered(monkeypatch, step, "_shade_chunk")


def fault_half_pass(monkeypatch):
    from materialist_tpu_torch.render import shader
    _half_chunks(monkeypatch, shader)


def fault_altered_pass(monkeypatch):
    from materialist_tpu_torch.render import forward
    _altered(monkeypatch, forward, "render_with_bsdf")


def fault_stale_pass(monkeypatch):
    from materialist_tpu_torch.render import forward
    orig = forward.render_averaged
    first = []

    def stale(*a, **k):
        if not first:
            first.append(orig(*a, **k))
        return first[0]
    monkeypatch.setattr(forward, "render_averaged", stale)


CASES = [("raw1024.inverse", f)
         for f in (fault_unchanged_step, fault_half_step, fault_altered_step)]
CASES += [("cli512.relight", f) for f in (fault_half_pass, fault_altered_pass,
                                          fault_stale_pass)]


@pytest.mark.parametrize("cell,fault", CASES,
                         ids=[f"{c}-{f.__name__}" for c, f in CASES])
def test_fault_fails_the_check(monkeypatch, cell, fault):
    fault(monkeypatch)
    out = run_cell(cell, seconds=0.5)
    assert out["correct"] is False, out["checks"]
