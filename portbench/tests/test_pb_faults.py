"""The check catches what it is there for, at tiny size on the CPU with the
cells' own limits: the control (the plain reference in float8 in the
system's place) and each fault that a cell can have, planted in the
system under test (``portbench/faults.py``), with the harness's look for a
GPU skipped and the rest of a run driven as it is on the card."""

import time

import pytest
import torch

from portbench import check, faults, spec
from portbench.run import execute
from tiny import tiny_cell

CPU = torch.device("cpu")
SEED = 2 ** 31 + 5
CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_control_fails(name):
    cell = tiny_cell(name)
    session = spec.driver(cell["driver"]).Session(cell, SEED, CPU)
    session.setup()
    if cell["driver"] == "predict":
        session.window(0.5)
    session.release()
    ref = session.reference()
    assert not check.passed(check.judge(session.control(ref),
                                        cell["limits"]))


@pytest.mark.parametrize("name,fault", [
    (w, f) for w in CELLS
    for f in faults.BY_DRIVER[spec.cell(w)["driver"]]])
def test_planted_fault_fails(name, fault):
    cell = tiny_cell(name)
    with faults.FAULTS[fault]():
        result = execute(cell, SEED, 1.5, False, CPU, time.time())
    assert result["correct"] is False, result["check"]


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_passes(name):
    """The same run with nothing planted is correct: the faults are what
    the check sees."""
    result = execute(tiny_cell(name), SEED, 1.5, False, CPU, time.time())
    assert result["correct"] is True, result["check"]
