"""The port's CLI (``python -m situation_recognition_tpu_torch.cli``) on
the CPU: train, resume, ``--evaluate_dev`` and ``--evaluate_test`` print
the reference's transcripts line for line (``tests/golden/*.txt``, numbers
masked: the weights are seeded differently); ``--evaluate_dev`` of a
checkpoint exported from a JAX trainer prints the JAX trainer's metrics on
those weights (equal, losses within 0.01); ``--grad_accum`` rounds the
batch and steps once per group; ``--cache_device`` budgets against the
probed memory or ``SRTPU_HBM_BYTES``; every ResNet backbone evaluates; the flags
of several processes are refused by name without a world; ``--platform auto``
needs a card; and a SIGTERM drill in a subprocess exits 0 and resumes."""

import contextlib
import io
import json
import os
import re
import signal
import subprocess
import sys
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from situation_recognition_tpu_torch.cli import main

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(_REPO, "tests", "golden")
NUMBER = re.compile(r"-?\d+\.\d+|\d+")


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One torch thread while this module runs: the suite runs several
    worker processes per core, and their thread pools spin against each
    other (these small steps ran 20x slower under load with the default
    pool)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """train/dev/test = ``imSitu/overfitting.json`` and 256² synthetic
    JPEGs named as its keys (the golden transcripts' dataset)."""
    root = tmp_path_factory.mktemp("torch_cli")
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
            "--batch_size", "5",
            "--num_workers", "2", "--dataset_folder", str(root / "imSitu"),
            "--imgset_dir", str(root / "resized_256"),
            "--saving_folder", str(root / folder), *extra]


def _run(argv) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return out.getvalue()


@pytest.fixture(scope="module")
def transcripts(workdir):
    out = {"train": _run(_argv(workdir, "ck", "--epochs", "1"))}
    out["resume"] = _run(_argv(workdir, "ck", "--epochs", "2",
                               "--resume_model", "sr"))
    # the goldens evaluate the seeded weights, as the reference does
    # without --resume_model
    for mode in ("evaluate_dev", "evaluate_test"):
        out[mode] = _run(_argv(workdir, "ck", "--" + mode))
    out["evaluate_resumed"] = _run(_argv(workdir, "ck", "--evaluate_dev",
                                         "--resume_model", "sr"))
    return out


def _masked(text):
    return [NUMBER.sub("#", line) for line in text.splitlines()]


@pytest.mark.parametrize("mode", ["train", "resume", "evaluate_dev",
                                  "evaluate_test"])
def test_transcript_matches_golden_format(transcripts, mode):
    with open(os.path.join(GOLDEN, mode + ".txt")) as f:
        want = f.read()
    assert _masked(transcripts[mode]) == _masked(want)


def test_resume_continues_the_histories(workdir, transcripts):
    from situation_recognition_tpu_torch.utils.checkpoint import (
        load_checkpoint)

    ck = load_checkpoint(str(workdir / "ck" / "sr"))
    assert ck["epoch"] == 2 and len(ck["avg_scores"]) == 2
    assert ck["step_count"] == ck["opt_steps"] == 2
    assert os.path.exists(str(workdir / "ck" / "encoder"))
    # the resumed weights' dev eval prints the checkpoint's last val line
    lines = transcripts["evaluate_resumed"].splitlines()
    assert lines[:3] == ["Loading encoder file", "Resume training from: sr",
                         "=> evaluating model with dev-set..."]
    resume = transcripts["resume"].splitlines()
    assert lines[3:] == resume[resume.index("-" * 50) + 1:]


def test_evaluate_dev_of_a_jax_export_prints_jax_metrics(workdir, capsys):
    """A JAX mini trainer after one step, exported in the reference's
    torch layout: the port's ``--evaluate_dev`` prints the same eight
    metrics as the JAX ``Trainer.evaluate(logging=True)`` on those weights
    and the same dev loader, and losses within 0.01."""
    import jax
    from flax import serialization

    from situation_recognition_tpu.data import dataset as jds
    from situation_recognition_tpu.data.encoder import ImsituEncoder
    from situation_recognition_tpu.train import Trainer, TrainerConfig
    from situation_recognition_tpu.utils.checkpoint import HISTORY_KEYS
    from situation_recognition_tpu.utils.torch_export import (
        export_reference_checkpoint)

    with open(workdir / "imSitu" / "train.json") as f:
        ann = json.load(f)
    enc = ImsituEncoder(ann, verbose=False)
    jtr = Trainer(enc, TrainerConfig(hidden=64, batch_size=8,
                                     backbone="mini", ggnn_impl="masked",
                                     image_size=64,
                                     compute_dtype=jnp.float32))
    imgs = str(workdir / "resized_256")
    train = jds.ImsituLoader(jds.ImsituDataset(imgs, ann, enc, train=True),
                             8, shuffle=True)
    jtr.train_epoch(train, 0)
    dev = jds.ImsituLoader(jds.ImsituDataset(imgs, ann, enc, train=False),
                           8, shuffle=False, num_workers=2)
    capsys.readouterr()
    jtr.evaluate(dev, logging=True)
    want = capsys.readouterr().out

    ck = {"epoch": 1, **{k: [] for k in HISTORY_KEYS},
          **serialization.to_state_dict(jax.tree.map(
              np.asarray, jtr.model_state_dict()))}
    ref = export_reference_checkpoint(ck)
    folder = workdir / "jx"
    folder.mkdir()

    def to_torch(x):
        if isinstance(x, dict):
            return {k: to_torch(v) for k, v in x.items()}
        if isinstance(x, np.ndarray):
            return torch.from_numpy(np.array(x, copy=True))
        return x

    torch.save(to_torch(ref), str(folder / "jax.pth"))
    got = _run(_argv(workdir, "jx", "--evaluate_dev", "--resume_model",
                     "jax.pth", "--batch_size", "8"))
    got_lines = got.splitlines()
    at = got_lines.index("Resume training from: jax.pth")
    assert got_lines[at + 1] == "=> evaluating model with dev-set..."
    got_lines = got_lines[at + 2:]
    want_lines = want.splitlines()
    assert got_lines[1:] == want_lines[1:]            # the eight metrics
    g = [float(x) for x in NUMBER.findall(got_lines[0])]
    w = [float(x) for x in NUMBER.findall(want_lines[0])]
    np.testing.assert_allclose(g, w, atol=0.01)


@pytest.mark.parametrize("flags,item", [
    (["--model_axis", "2"], "needs --distributed"),
    (["--distributed"], "torchrun"),
    (["--coordinator", "localhost:1234"], "needs --distributed"),
    (["--num_processes", "2"], "needs --distributed"),
    (["--process_id", "0"], "needs --distributed"),
])
def test_unported_flags_are_refused_by_name(flags, item, capsys,
                                            monkeypatch):
    """The multi-process flags, ported, refuse a use without a world by
    name: alone, each is a usage error that names it and what it needs
    (``--distributed`` without torchrun's environment or the explicit
    world flags)."""
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(SystemExit) as info:
        main(["--platform", "cpu", *flags])
    assert info.value.code == 2
    err = capsys.readouterr().err
    assert flags[0] in err and item in err


def test_grad_accum_rounds_the_batch_and_steps_per_group(workdir,
                                                         monkeypatch,
                                                         capsys):
    """``--grad_accum 2 --batch_size 3``: the batch rounds up to 4 (the
    JAX CLI's stderr line), loaders and steps run at microbatch 2, so the
    5 images make 3 microbatches: a group and a part group, 2 optimizer
    steps.  ``--save_steps 1`` snapshots at the group's end only, and the
    transcript has the golden's form."""
    from situation_recognition_tpu_torch import train
    from situation_recognition_tpu_torch.utils.checkpoint import (
        load_checkpoint)

    mids = []
    real = train.AsyncSaver.save

    def save(self, path, state, *args, **kwargs):
        if "mid" in state:
            mids.append(state["mid"]["batch_in_epoch"])
        return real(self, path, state, *args, **kwargs)

    monkeypatch.setattr(train.AsyncSaver, "save", save)
    argv = _argv(workdir, "accum", "--epochs", "1", "--save_steps", "1",
                 "--grad_accum", "2")
    argv[argv.index("--batch_size") + 1] = "3"
    got = _run(argv)
    assert ("[srtorch] batch_size rounded up to 4 (divisible by data axis "
            "1 x grad_accum 2)") in capsys.readouterr().err
    with open(os.path.join(GOLDEN, "train.txt")) as f:
        assert _masked(got) == _masked(f.read())
    assert mids == [2]
    ck = load_checkpoint(str(workdir / "accum" / "sr"))
    assert (ck["step_count"], ck["opt_steps"], ck["epoch"]) == (3, 2, 1)


@pytest.mark.parametrize("backbone", ["resnet18", "resnet34", "resnet50",
                                      "resnet101"])
def test_resnet_backbones_evaluate_dev(workdir, backbone):
    """Each ResNet at its published width and depth (random weights from
    the seed) evaluates the dev split through the CLI, in the golden's
    form."""
    argv = _argv(workdir, "bb_" + backbone, "--evaluate_dev")
    argv[argv.index("mini")] = backbone
    got = _run(argv)
    with open(os.path.join(GOLDEN, "evaluate_dev.txt")) as f:
        want = f.read()
    # (from the mode's line: a first run builds the encoder and prints its
    # statistics, where the golden loads it)
    mode = "=> evaluating model with dev-set..."
    assert mode in got
    assert _masked(got[got.index(mode):]) == _masked(want[want.index(mode):])


def test_usage_checks(capsys):
    for flags in (["--cache_device", "--cache_decoded"],
                  ["--backbone_lr", "0.1"], ["--remat_backbone"],
                  ["--lr_schedule", "cosine"], ["--total_steps", "5"]):
        with pytest.raises(SystemExit):
            main(["--platform", "cpu", *flags])
    assert "--backbone_lr needs --train_backbone" in capsys.readouterr().err


@pytest.mark.parametrize("preproc, window", [("window", 256),
                                             ("exact", 224)])
def test_cache_device_budget_takes_the_splits_windows(
        workdir, monkeypatch, capsys, preproc, window):
    """``--cache_device`` asks for its reserve at the split's window side,
    caches the dev split when its windows fit beside the reserve and
    streams it when they do not (5 rows < the batch: no prefix), and the
    metrics are the same either way."""
    from situation_recognition_tpu_torch import cli

    asked = []

    def reserve(encoder, cfg, device, window, train):
        asked.append((window, train))
        return 1000

    monkeypatch.setattr(cli, "_working_reserve", reserve)
    argv = _argv(workdir, "cached_" + preproc, "--evaluate_dev",
                 "--preproc", preproc, *(["--image_size", "224"]
                                         if preproc == "exact" else []))
    plain = _run(argv)
    capsys.readouterr()
    row = window * window * 3
    for rows, streamed in ((5, False), (4, True)):
        monkeypatch.setattr(cli, "_device_free_bytes",
                            lambda device, rows=rows: 1000 + rows * row)
        got = _run(argv + ["--cache_device"])
        err = capsys.readouterr().err
        assert ("dev split" in err and "streaming it" in err) == streamed
        # (the first run wrote the encoder, the others load it)
        assert got.split("=> evaluating")[1] == plain.split(
            "=> evaluating")[1]
    assert asked == [(window, False)] * 2


def test_hbm_bytes_switch_decides_the_cache(workdir, monkeypatch, capsys):
    """``SRTPU_HBM_BYTES`` (the JAX CLI's switch) replaces the probed free
    memory that ``--cache_device`` budgets against: the same dev split is
    cached at one value and streamed at one row's bytes less."""
    from situation_recognition_tpu_torch import cli

    monkeypatch.setattr(cli, "_working_reserve",
                        lambda encoder, cfg, device, window, train: 1000)
    argv = _argv(workdir, "hbm_switch", "--evaluate_dev", "--cache_device")
    row = 256 * 256 * 3
    for rows, streamed in ((5, False), (4, True)):
        monkeypatch.setenv("SRTPU_HBM_BYTES", str(1000 + rows * row))
        assert cli._device_free_bytes(torch.device("cpu")) == \
            1000 + rows * row
        _run(argv)
        err = capsys.readouterr().err
        assert ("dev split" in err and "streaming it" in err) == streamed
    monkeypatch.delenv("SRTPU_HBM_BYTES")
    assert cli._device_free_bytes(torch.device("cpu")) != 1000 + 4 * row


def test_platform_auto_needs_a_card(workdir, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = _argv(workdir, "nocard")
    argv[argv.index("cpu")] = "auto"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv)


def test_sigterm_drill_exits_clean_and_resumes(workdir):
    """A training subprocess takes SIGTERM after its first mid-epoch
    checkpoint: it exits 0 and says so on stderr; the relaunch resumes."""
    env = dict(os.environ, PYTHONPATH=_REPO, OMP_NUM_THREADS="1")
    argv = [sys.executable, "-m", "situation_recognition_tpu_torch.cli",
            *_argv(workdir, "drill", "--epochs", "500", "--batch_size", "2",
                   "--save_steps", "1")]
    proc = subprocess.Popen(argv, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    ck = workdir / "drill" / "sr"
    try:
        deadline = time.monotonic() + 120
        while not ck.exists() and time.monotonic() < deadline \
                and proc.poll() is None:
            time.sleep(0.05)
        assert ck.exists(), proc.communicate(timeout=30)
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err
    assert "[srtorch] SIGTERM: saved resumable checkpoint" in err
    from situation_recognition_tpu_torch.utils.checkpoint import (
        load_checkpoint)

    state = load_checkpoint(str(ck))
    resumed = subprocess.run(
        argv[:argv.index("500")] + [str(state["epoch"] + 1)]
        + argv[argv.index("500") + 1:] + ["--resume_model", "sr"],
        env=env, capture_output=True, text=True, timeout=120)
    assert resumed.returncode == 0, resumed.stderr
    assert "Resume training from: sr" in resumed.stdout
    assert load_checkpoint(str(ck))["epoch"] == state["epoch"] + 1
