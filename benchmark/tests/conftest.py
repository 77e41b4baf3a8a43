"""Shared pieces of the benchmark's CPU tests: a temporary checkout of the
benchmark with the tiny test cells of ``fixtures/`` added as new files,
and a runner of one cell on the CPU in a child process."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH)
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")
sys.path.insert(0, BENCH)

#: the tiny cells, which report the chip cells' training metrics
TRAIN_CELLS = ("tiny-r", "tiny-v")


def make_checkout(root: str) -> str:
    """``BENCHMARK.json`` and ``benchmark/`` copied under ``root``, the
    tiny cells added: their files copied in beside the others, their
    entries appended to the spec."""
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), root)
    shutil.copytree(BENCH, os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    for sub in ("configs", "traffic", "limits"):
        for f in os.listdir(os.path.join(FIXTURES, sub)):
            shutil.copy(os.path.join(FIXTURES, sub, f),
                        os.path.join(root, "benchmark", sub, f))
    with open(os.path.join(FIXTURES, "cells.json")) as f:
        cells = json.load(f)
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        sp = json.load(f)
    for m in sp["end_to_end"] + sp["per_layer"]:
        if "workloads" in m:
            m["workloads"] += list(TRAIN_CELLS)
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        sp[key] += cells.get(key, [])
    with open(path, "w") as f:
        json.dump(sp, f, indent=1)
    return root


@pytest.fixture(scope="session")
def checkout(tmp_path_factory) -> str:
    return make_checkout(str(tmp_path_factory.mktemp("checkout")))


def run_cell(root: str, cell: str, seed: int, seconds: float = 1.0,
             trace: int = 0, fault: str | None = None,
             device: str = "cpu"):
    """Run one cell from the checkout at ``root`` → (exit code, the last
    line of standard output parsed, or None, and standard error)."""
    cmd = [sys.executable, "benchmark/run.py", "--workload", cell,
           "--seed", str(seed), "--seconds", str(seconds), "--trace",
           str(trace), "--device", device]
    if fault:
        cmd += ["--fault", fault]
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "2"}
    p = subprocess.run(cmd, cwd=root, env=env, capture_output=True,
                       text=True, timeout=600)
    lines = p.stdout.strip().splitlines()
    last = None
    if lines:
        try:
            last = json.loads(lines[-1])
        except ValueError:
            last = None
    return p.returncode, last, p.stderr
