"""The JAX package's run-time switches, read by the port where JAX reads
them and with its defaults, on the CPU: ``SRTPU_PIPELINE_DEPTH`` (0, 1 and
3 steps in flight give the default's losses and scores exactly),
``SRTPU_STEP_TRACE=1`` (JAX's ``[trace]`` lines for the first 16 train
steps consumed), ``SRTPU_PROFILE_DIR`` (a ``torch.profiler`` trace of
``fit``'s first epoch in that directory) and ``SRTPU_HBM_CHUNK_BYTES`` (the
window upload's chunk rows, the windows unchanged).  ``SRTPU_HBM_BYTES``
is held in ``tests/test_torch_cli.py``."""

import json
import os
import re

import numpy as np
import pytest
import torch

from situation_recognition_tpu_torch import train as train_mod
from situation_recognition_tpu_torch.data.encoder import ImsituEncoder
from situation_recognition_tpu_torch.train import Trainer, TrainerConfig

B = 2
TRACE = re.compile(r"^\[trace\] b(\d+): loss_block=\d+ms topk_fetch=\d+ms "
                   r"lap=\d+ms$")


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batches(enc, count, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        out.append({
            "images": rng.integers(0, 256, (B, 256, 256, 3), dtype=np.uint8),
            "flip": rng.random(B) < 0.5,
            "verbs": rng.integers(0, enc.get_num_verbs(), B),
            "labels": rng.integers(0, enc.get_num_labels(),
                                   (B, 3, enc.max_role_count))})
    return out


def _trainer(enc):
    return Trainer(enc, TrainerConfig(
        hidden=32, batch_size=B, backbone="mini", image_size=32,
        compute_dtype=torch.float32, dropout_rate=0.0), device="cpu")


def _results(trainer, batches):
    top1, top5, losses = trainer.train_epoch(batches, 0)
    e1, e5, val, _ = trainer.evaluate(batches)
    return (top1.get_average_results_both(), top5.get_average_results_both(),
            losses, e1.get_average_results_both(),
            e5.get_average_results_both(), val)


def test_pipeline_depth_changes_no_number(monkeypatch):
    enc = ImsituEncoder.synthetic_full(0)
    batches = _batches(enc, 5)
    monkeypatch.delenv("SRTPU_PIPELINE_DEPTH", raising=False)
    assert train_mod.pipeline_depth() == train_mod.PIPELINE_DEPTH == 2
    want = _results(_trainer(enc), batches)
    for depth in (0, 1, 3):
        monkeypatch.setenv("SRTPU_PIPELINE_DEPTH", str(depth))
        assert train_mod.pipeline_depth() == depth
        assert Trainer.batches_on_device() == train_mod._upload_depth() + 2 \
            + depth
        assert _results(_trainer(enc), batches) == want, depth
    monkeypatch.setenv("SRTPU_PIPELINE_DEPTH", "-3")
    assert train_mod.pipeline_depth() == 0


def test_step_trace_prints_jax_lines_for_16_steps(monkeypatch, capsys):
    from situation_recognition_tpu_torch.utils.logging import StepTimer

    enc = ImsituEncoder.synthetic_full(0)
    tr = _trainer(enc)
    batches = _batches(enc, 18, seed=1)
    monkeypatch.setenv("SRTPU_STEP_TRACE", "1")
    capsys.readouterr()
    tr.train_epoch(batches, 0, timer=StepTimer())
    lines = [x for x in capsys.readouterr().err.splitlines()
             if x.startswith("[trace]")]
    assert [int(TRACE.match(x).group(1)) for x in lines] == list(range(16))
    monkeypatch.delenv("SRTPU_STEP_TRACE")
    tr.train_epoch(batches[:3], 1, timer=StepTimer())
    assert "[trace]" not in capsys.readouterr().err


def test_profile_dir_receives_a_trace_of_fit(monkeypatch, tmp_path):
    enc = ImsituEncoder.synthetic_full(0)
    tr = _trainer(enc)
    prof = tmp_path / "prof"
    monkeypatch.setenv("SRTPU_PROFILE_DIR", str(prof))
    batches = _batches(enc, 2, seed=2)
    tr.config.epochs = 2
    tr.fit(batches, batches, "sr", str(tmp_path), plot=False, save=False)
    files = os.listdir(prof)
    # the first epoch of this fit, as JAX traces it
    assert len(files) == 1 and files[0].startswith("trace_")
    with open(prof / files[0]) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any(n.startswith("aten::") for n in names)


def test_profile_trace_is_a_no_op_without_a_directory(tmp_path):
    from situation_recognition_tpu_torch.utils.logging import profile_trace

    with profile_trace(None):
        torch.ones(2).sum()
    with profile_trace(str(tmp_path / "p")):
        torch.ones(2).sum()
    assert len(os.listdir(tmp_path / "p")) == 1


def test_hbm_chunk_bytes_sets_the_chunk_rows(monkeypatch):
    rng = np.random.default_rng(3)
    host = rng.integers(0, 256, (7, 16, 16, 3), dtype=np.uint8)
    row = host[0].nbytes
    monkeypatch.delenv("SRTPU_HBM_CHUNK_BYTES", raising=False)
    assert train_mod.chunk_rows(row) == (256 << 20) // row
    seen = []
    copy = torch.Tensor.copy_

    def count(dst, src, *a, **kw):
        seen.append(src.shape[0])
        return copy(dst, src, *a, **kw)

    for chunk, want, rows in ((3 * row, 3, [3, 3, 1]),
                              (row - 1, 1, [1] * 7), (100 * row, 100, [7])):
        monkeypatch.setenv("SRTPU_HBM_CHUNK_BYTES", str(chunk))
        assert train_mod.chunk_rows(row) == want
        seen.clear()
        monkeypatch.setattr(torch.Tensor, "copy_", count)
        got = train_mod.upload_windows(host, torch.device("cpu"))
        monkeypatch.setattr(torch.Tensor, "copy_", copy)
        assert seen == rows
        assert torch.equal(got, torch.from_numpy(host))
