"""Shared pieces of the benchmark's CPU tests: the tiny test cells of
``fixtures/``, each a file of its own (``fixtures/cells/<cell>.json``:
its configuration's entry and its workload's, the files they name beside
it in ``fixtures/configs``, ``traffic`` and ``limits``), a temporary
checkout of the benchmark with those cells added as new files, and a
runner of one cell on the CPU in a child process."""

from __future__ import annotations

import glob
import json
import os
import shutil
import subprocess
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH)
sys.path.insert(0, BENCH)


def cells(bench: str = BENCH) -> list:
    """The tiny cells' files of the benchmark at ``bench``, by name."""
    out = []
    for path in sorted(glob.glob(os.path.join(bench, "tests", "fixtures",
                                              "cells", "*.json"))):
        with open(path) as f:
            out.append(json.load(f))
    return out


def train_cells(bench: str = BENCH) -> tuple:
    """The tiny cells whose traffic is ``train_epoch``: they report the
    chip cells' training metrics."""
    out = []
    for c in cells(bench):
        with open(os.path.join(bench, "tests", "fixtures", "traffic",
                               c["workload"]["traffic"] + ".json")) as f:
            if json.load(f)["kind"] == "train_epoch":
                out.append(c["workload"]["name"])
    return tuple(out)


#: the tiny cells, which report the chip cells' training metrics
TRAIN_CELLS = train_cells()


def make_checkout(root: str, bench: str = BENCH) -> str:
    """``BENCHMARK.json`` and the benchmark at ``bench`` copied under
    ``root``, its tiny cells added: their files copied in beside the
    others, their entries appended to the spec."""
    fixtures = os.path.join(bench, "tests", "fixtures")
    os.makedirs(root, exist_ok=True)
    shutil.copy(os.path.join(os.path.dirname(bench), "BENCHMARK.json"), root)
    shutil.copytree(bench, os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    for sub in ("configs", "traffic", "limits"):
        for f in os.listdir(os.path.join(fixtures, sub)):
            shutil.copy(os.path.join(fixtures, sub, f),
                        os.path.join(root, "benchmark", sub, f))
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        sp = json.load(f)
    for m in sp["end_to_end"] + sp["per_layer"]:
        if "workloads" in m:
            m["workloads"] += list(train_cells(bench))
    for c in cells(bench):
        if c["config"]["name"] not in {x["name"] for x in sp["configs"]}:
            sp["configs"].append(c["config"])
        sp["workloads"].append(c["workload"])
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


def copy_bench(root: str) -> str:
    """``BENCHMARK.json`` and the whole benchmark, its tests with it,
    copied under ``root`` → the copy's benchmark directory."""
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), root)
    shutil.copytree(BENCH, os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    return os.path.join(root, "benchmark")


def add_backbone_cell(bench: str, kind: str, cell: str,
                      source: str | None) -> None:
    """The files a new backbone kind brings to the benchmark at ``bench``,
    and nothing else: its reference file (``source``'s text; None: none),
    and a tiny cell of it on ``tiny-vit``'s sizes, ``tiny-train``'s
    traffic and ``tiny-v``'s limits (its fixture configuration, limits
    and cell)."""
    fixtures = os.path.join(bench, "tests", "fixtures")
    if source is not None:
        with open(os.path.join(bench, "reference", "backbones",
                               kind + ".py"), "w") as f:
            f.write(source)
    with open(os.path.join(fixtures, "configs", "tiny-vit.json")) as f:
        cfg = json.load(f)
    name = "tiny-" + kind
    cfg["name"] = name
    cfg["backbone"]["kind"] = kind
    with open(os.path.join(fixtures, "configs", name + ".json"), "w") as f:
        json.dump(cfg, f)
    shutil.copy(os.path.join(fixtures, "limits", "tiny-v.json"),
                os.path.join(fixtures, "limits", cell + ".json"))
    with open(os.path.join(fixtures, "cells", cell + ".json"), "w") as f:
        json.dump({"config": {"name": name, "source": "the CPU tests",
                              "file": f"benchmark/configs/{name}.json",
                              "reduced": [], "why": "the CPU tests"},
                   "workload": {"name": cell, "config": name,
                                "traffic": "tiny-train", "chips": 1,
                                "why": f"the CPU tests: backbone {kind}"}},
                  f)
