"""The plain reference against the port, on the CPU at tiny sizes and in
float32: a whole run of each tiny cell (the program's timed path, then the
reference following its first steps) must come out
correct under limits a thousand times tighter than the chip cells'."""

import pytest

from conftest import run_cell


@pytest.mark.parametrize("cell", ["tiny-r", "tiny-v"])
def test_the_port_matches_the_reference_at_f32(checkout, cell):
    rc, res, err = run_cell(checkout, cell, seed=2**31 + 12345, seconds=1.5)
    assert rc == 0, err[-3000:]
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    for c in res["checks"].values():
        assert c["value"] <= c["limit"]
    assert "setup_s" in res["metrics"]


def test_a_traced_run_reports_the_per_layer_metrics_it_can_read(checkout):
    import core

    rc, res, err = run_cell(checkout, "tiny-r", seed=77, seconds=1.5,
                            trace=1)
    assert rc == 0, err[-3000:]
    assert res["correct"] is True
    sp = core.spec(checkout)
    assert set(res["metrics"]) <= {
        m["name"] for m in core.cell_metrics(sp, "tiny-r", "per_layer")}
    assert "busy_s" in res["device"] and "window_s" in res["device"]
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def test_without_a_card_a_run_prints_no_result(checkout):
    rc, res, err = run_cell(checkout, "tiny-r", seed=3, device="cuda")
    assert rc != 0 and res is None


def test_beside_only_the_benchmark_a_run_prints_no_result(tmp_path):
    # a checkout of BENCHMARK.json and benchmark/ alone: no program
    import os
    import shutil
    import subprocess
    import sys

    from conftest import BENCH, REPO
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "r152-train-1536", "--seed", "1", "--seconds", "1",
                        "--device", "cpu"], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert not p.stdout.strip()
