"""The cells at toy sizes on the card (skipped without one): the same
loops and check as on the CPU, with CUDA tensors, the port's kernels and
a device trace."""

import pytest

from conftest import CELLS, toy_cell
from portbench.lib import harness

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch


@pytest.mark.parametrize("cell", CELLS)
def test_toy_cell_on_the_card(cell, cuda):
    cfg, traffic = toy_cell(cell)
    out = harness.run_cell(cell, 2**31 + 23, 1.0, True, device="cuda", config=cfg, traffic=traffic)
    line = harness.result_line(out, 1, cuda.cuda.get_device_name(0))
    assert line["correct"] is True
    assert line["device"]["busy_s"] > 0
    assert out["metrics"]
