"""A ``--trace 1`` run reads the program's own spans: each tiny cell's
result line carries the five metrics of ``benchmark/program_spans.py``'s
readers, each finite, and the host's busy share within [0, 100]."""

import math

import pytest

from conftest import TRAIN_CELLS, run_cell

SPAN_METRICS = ("enqueue_ms.train", "score_ms.train", "batch_wait_ms.train",
                "stage_ms.train", "host_busy.train")


@pytest.mark.parametrize("cell", TRAIN_CELLS)
def test_a_traced_run_reports_the_program_span_metrics(checkout, cell):
    rc, res, err = run_cell(checkout, cell, seed=3_000_000_019, seconds=1.0,
                            trace=1)
    assert rc == 0, err[-3000:]
    metrics = res["metrics"]
    for name in SPAN_METRICS:
        assert name in metrics, (name, sorted(metrics))
        assert math.isfinite(metrics[name]["value"]), (name, metrics[name])
        assert metrics[name]["value"] >= 0, (name, metrics[name])
    assert 0 <= metrics["host_busy.train"]["value"] <= 100
    assert metrics["enqueue_ms.train"]["unit"] == "ms"
