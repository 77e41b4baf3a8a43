"""A run whose timed path is broken underneath must come out not correct:
each fault a cell can have, with the harness's look for a card skipped
(``--device cpu``) and everything else of a run driven as it is."""

import pytest

from conftest import run_cell

FAULTS = [(cell, fault) for cell in ("tiny-r", "tiny-v")
          for fault in ("unchanged", "half_batch", "altered", "altered_gt")]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_a_fault_makes_the_run_not_correct(checkout, cell, fault):
    rc, res, err = run_cell(checkout, cell, seed=2024, seconds=1.0,
                            fault=fault)
    assert rc == 0, err[-3000:]
    assert res["correct"] is False, res["checks"]
