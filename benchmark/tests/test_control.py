"""The control at a size a test run holds: the plain reference one
precision below the configuration's, in the program's place, read as a
run reads the program, must fail the cell's limits on every seed."""

import pytest
import torch

import control
from conftest import REPO, TRAIN_CELLS


@pytest.mark.parametrize("cell", TRAIN_CELLS)
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_the_control_is_not_correct(checkout, cell, seed):
    torch.set_num_threads(2)
    got = control.readings(cell, seed, torch.device("cpu"),
                           spec_root=checkout,
                           here=f"{checkout}/benchmark")
    assert got["passes_limits"] is False, got


def test_the_chip_cells_controls_compute_one_precision_down():
    import core

    sp = core.spec(REPO)
    for c in sp["configs"]:
        cfg = core.config(c["name"])
        assert (cfg["compute_dtype"], cfg["control"]) == ("bfloat16", "fp8")
