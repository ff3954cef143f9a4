"""The check that decides ``correct``: the control (the plain reference at
the next precision below, in the program's place) and each planted fault
of the timed path come out not correct, at toy sizes on the CPU."""

import pytest

from conftest import CELLS, toy_cell
from portbench import control
from portbench.lib import harness


@pytest.mark.parametrize("cell", CELLS)
def test_control_reads_above_the_limits(cell):
    cfg, traffic = toy_cell(cell)
    reading = control.control_reading(cell, 11, "cpu", cfg, traffic)
    assert reading["leaves_differing"] > 0 and reading["bytes_differing"] > 0


@pytest.mark.parametrize("fault", sorted(control.FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_timed_path_is_not_correct(cell, fault):
    cfg, traffic = toy_cell(cell)
    with control.FAULTS[fault]():
        out = harness.run_cell(cell, 13, 0.3, False, device="cpu", config=cfg, traffic=traffic)
    assert harness.result_line(out, 1, "cpu")["correct"] is False


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    cfg, traffic = toy_cell(cell)
    out = harness.run_cell(cell, 13, 0.3, False, device="cpu", config=cfg, traffic=traffic)
    assert harness.result_line(out, 1, "cpu")["correct"] is True
