"""The port's CLI as a world of two processes on the CPU: two
``python -m situation_recognition_tpu_torch.cli --distributed --platform
cpu --coordinator 127.0.0.1:<port> --num_processes 2 --process_id <r>``
subprocesses (gloo) train one epoch and evaluate on the golden transcripts'
dataset (``imSitu/overfitting.json``, 5 images, global batch 6: one
wrapped batch, 3 rows a rank).  Rank 0's stdout is the single-process
CLI's at the same batch, line for line; rank 1 prints nothing; one
checkpoint is written, and it resumes on one process.  Under torchrun
(``python -m torch.distributed.run --nproc_per_node 2``, ``env://``) a
world of two evaluates dev as one process does."""

import contextlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from situation_recognition_tpu_torch.cli import main
from tests.torch_dist_worker import free_port

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    root = tmp_path_factory.mktemp("dist_cli")
    ds = root / "imSitu"
    ds.mkdir()
    with open(os.path.join(_REPO, "imSitu", "overfitting.json")) as f:
        ann = json.load(f)
    for name in ("train.json", "dev.json", "test.json"):
        with open(ds / name, "w") as f:
            json.dump(ann, f)
    imgs = root / "resized_256"
    imgs.mkdir()
    rng = np.random.default_rng(0)
    for name in ann:
        low = rng.integers(0, 255, (8, 8, 3), dtype=np.uint8)
        arr = np.asarray(Image.fromarray(low).resize((256, 256),
                                                     Image.BILINEAR))
        Image.fromarray(arr).save(imgs / name, quality=95)
    return root


def _argv(root, folder, *extra):
    return ["--platform", "cpu", "--backbone", "mini", "--image_size", "64",
            "--batch_size", "6", "--num_workers", "2", "--epochs", "1",
            "--dataset_folder", str(root / "imSitu"),
            "--imgset_dir", str(root / "resized_256"),
            "--saving_folder", str(root / folder), *extra]


@pytest.fixture(scope="module")
def runs(workdir):
    port = free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=_REPO)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "situation_recognition_tpu_torch.cli",
         *_argv(workdir, "world", "--distributed", "--coordinator",
                f"127.0.0.1:{port}", "--num_processes", "2",
                "--process_id", str(r))],
        cwd=str(workdir), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{out}\n{err[-4000:]}"
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        single = io.StringIO()
        with contextlib.redirect_stdout(single):
            main(_argv(workdir, "single"))
    finally:
        torch.set_num_threads(n)
    return {"rank0": outs[0][0], "rank1": outs[1][0],
            "stderr": outs[0][1], "single": single.getvalue()}


def test_rank0_prints_the_single_process_transcript(runs):
    assert runs["rank0"].splitlines() == runs["single"].splitlines()
    assert "val losses" in runs["rank0"]


def test_rank1_prints_nothing(runs):
    assert runs["rank1"] == ""


def test_one_checkpoint_and_it_resumes_on_one_process(workdir, runs):
    folder = workdir / "world"
    assert sorted(os.listdir(folder)) == ["encoder", "sr"] or sorted(
        os.listdir(folder)) == ["encoder", "sr", "sr.png"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(_argv(workdir, "world", "--evaluate_dev", "--resume_model",
                   "sr"))
    assert "Resume training from: sr" in out.getvalue()


def test_torchrun_world_evaluates_as_one_process(workdir):
    """torchrun's environment (``env://``) in place of the explicit
    flags: a world of two evaluates dev as one process does."""
    port = free_port()
    env = dict(os.environ, PYTHONPATH=_REPO)
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
                "LOCAL_RANK"):
        env.pop(var, None)
    done = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node",
         "2", "--master_addr", "127.0.0.1", "--master_port", str(port),
         "-m", "situation_recognition_tpu_torch.cli",
         *_argv(workdir, "torchrun", "--distributed", "--evaluate_dev")],
        cwd=str(workdir), env=env, capture_output=True, text=True,
        timeout=240)
    assert done.returncode == 0, done.stderr[-4000:]
    single = io.StringIO()
    with contextlib.redirect_stdout(single):
        main(_argv(workdir, "torchrun_single", "--evaluate_dev"))
    assert done.stdout.splitlines() == single.getvalue().splitlines()
    assert "val losses" in done.stdout
