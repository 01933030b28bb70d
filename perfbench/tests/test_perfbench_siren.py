"""The cell ``siren512.inverse`` as the other cells are tested
(``test_perfbench_run_cpu.py``, ``test_perfbench_faults.py``,
``test_perfbench_control.py``): one CPU run at the tiny film, plain and
traced, with its result's schema and a passing check; each fault of an
inverse step planted underneath failing the check; and on the card the
control failing it."""

from __future__ import annotations

import pytest

from perfbench.tests import test_perfbench_control as control
from perfbench.tests import test_perfbench_faults as faults
from perfbench.tests import test_perfbench_run_cpu as run_cpu

CELL = "siren512.inverse"
FAULTS = (faults.fault_unchanged_step, faults.fault_half_step,
          faults.fault_altered_step)


def test_result_schema_and_check():
    run_cpu.test_result_schema_and_check(CELL)


def test_traced_run_reports_spans_and_breakdown():
    run_cpu.test_traced_run_reports_spans_and_breakdown(CELL)


@pytest.mark.parametrize("fault", FAULTS, ids=lambda f: f.__name__)
def test_fault_fails_the_check(monkeypatch, fault):
    faults.test_fault_fails_the_check(monkeypatch, CELL, fault)


@pytest.mark.cuda
def test_control_fails_the_check():
    control.test_control_fails_the_check(CELL)
