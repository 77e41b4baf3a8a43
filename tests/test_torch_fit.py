"""The port's epoch loop (``Trainer.fit``, ``train_epoch``, ``evaluate``)
on the CPU at f32, mini backbone at 64², batch 8, mirroring the JAX package's
``tests/test_train.py``: stdout and checkpoint of one epoch, mid-epoch and
epoch-boundary resumes equal to the uninterrupted run bit for bit (the
dropout stream continues: dropout 0.5), preemption in training and in the
dev eval, ``keep_best`` and ``metrics_jsonl``, the writer's errors, and a
loader error that reaches the consumer past a full upload queue."""

import json
import os
import re
import signal
import threading
import time

import pytest
import torch

from situation_recognition_tpu_torch.data.encoder import ImsituEncoder
from situation_recognition_tpu_torch.train import (
    AsyncSaver, Preempted, Trainer, TrainerConfig)
from situation_recognition_tpu_torch.utils.checkpoint import (
    load_checkpoint)
from tests.test_torch_train import B, _batch

ENC = ImsituEncoder.synthetic_full(0)


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


def _trainer(**kw):
    cfg = dict(hidden=64, batch_size=B, backbone="mini", lr=0.002,
               dropout_rate=0.5, ggnn_impl="masked",
               compute_dtype=torch.float32, epochs=1, image_size=64)
    cfg.update(kw)
    return Trainer(ENC, TrainerConfig(**cfg), device="cpu")


class EpochLoader:
    """Batches drawn per (seed, epoch) — the last one short — with the
    loader interface the loop uses (``set_epoch``, ``start_batch``);
    ``hook(i)`` runs before batch i is handed out."""

    def __init__(self, seed, sizes=(B, B, 5), hook=None):
        self.seed, self.sizes, self.hook = seed, sizes, hook
        self.epoch = 0
        self.start_batch = 0

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __iter__(self):
        start, self.start_batch = self.start_batch, 0
        for i, n in enumerate(self.sizes):
            if i < start:
                continue
            if self.hook is not None:
                self.hook(i)
            yield _batch(ENC, n, seed=1000 * self.seed + 10 * self.epoch + i)


def _state(trainer):
    return trainer.model_state_dict()


def _assert_state_equal(a, b):
    ma, mb = a["model_state_dict"], b["model_state_dict"]
    assert list(ma) == list(mb)
    for k in ma:
        assert torch.equal(ma[k], mb[k]), k
    sa, sb = a["optimizer_state_dict"]["state"], \
        b["optimizer_state_dict"]["state"]
    assert list(sa) == list(sb)
    for i in sa:
        for k in sa[i]:
            assert torch.equal(sa[i][k], sb[i][k]), (i, k)
    assert (a["step_count"], a["opt_steps"]) == (b["step_count"],
                                                  b["opt_steps"])


def _sigterm(loader_step):
    """A hook that calls the SIGTERM handler ``fit`` installed (as the
    signal would) before batch ``loader_step``."""
    def hook(i):
        if i == loader_step:
            handler = signal.getsignal(signal.SIGTERM)
            assert callable(handler), "fit installed no SIGTERM handler"
            handler(signal.SIGTERM, None)
    return hook


def test_fit_one_epoch_stdout_and_checkpoint(tmp_path, capsys):
    tr = _trainer()
    tr.fit(EpochLoader(1), EpochLoader(2, sizes=(B, 3)), "sr",
           str(tmp_path), plot=False)
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "Epoch-0, lr: 0.0020"
    assert lines[1].startswith("training losses = [v: ")
    assert lines[2].startswith("1-verb: ")
    assert lines[3].startswith("5-verb: ")
    assert lines[4].startswith("gt-value: ") and ", mean = " in lines[4]
    assert lines[5] == "-" * 50
    assert lines[6].startswith("val losses = [v: ")
    assert lines[9].startswith("gt-value: ")
    ck = load_checkpoint(str(tmp_path / "sr"))
    assert ck["epoch"] == 1 and ck["step_count"] == 3 == ck["opt_steps"]
    assert len(ck["avg_scores"]) == len(ck["val_avg_scores"]) == 1
    assert "mid" not in ck
    _assert_state_equal(ck, _state(tr))


def test_mid_epoch_resume_equals_uninterrupted(tmp_path):
    whole = _trainer()
    w1, w5, wloss = whole.train_epoch(EpochLoader(3), 0)

    saved = {}
    stop = threading.Event()
    cut = _trainer()

    def callback(mid):
        # snapshots after batches 1 and 2; the stop flagged at the first
        # is taken at the next step boundary
        saved.update(_state(cut), mid=mid)
        stop.set()

    with pytest.raises(Preempted) as info:
        cut.train_epoch(EpochLoader(3), 0, save_every=1,
                        save_callback=callback, preempt=stop)
    assert info.value.saved and info.value.batch_in_epoch == 2
    assert saved["mid"]["batch_in_epoch"] == 2

    resumed = _trainer()          # the seed keys the dropout streams
    resumed.load_model_state(saved)
    r1, r5, rloss = resumed.train_epoch(EpochLoader(3), 0,
                                        mid_state=saved["mid"])
    assert rloss == wloss
    assert r1.get_average_results_both() == w1.get_average_results_both()
    assert r5.get_average_results_both() == w5.get_average_results_both()
    _assert_state_equal(_state(resumed), _state(whole))


def test_epoch_boundary_resume_continues_dropout_stream():
    whole = _trainer()
    for e in range(2):
        whole.train_epoch(EpochLoader(4), e)
    first = _trainer()
    first.train_epoch(EpochLoader(4), 0)
    state = _state(first)
    resumed = _trainer()
    resumed.load_model_state(state)
    resumed.train_epoch(EpochLoader(4), 1)
    _assert_state_equal(_state(resumed), _state(whole))
    # without the saved step count the dropout masks would replay epoch 0's
    replay = _trainer()
    replay.load_model_state(dict(state, step_count=0))
    replay.train_epoch(EpochLoader(4), 1)
    a = _state(replay)["model_state_dict"]["ggsnn.W_p.weight"]
    assert not torch.equal(a, _state(whole)["model_state_dict"][
        "ggsnn.W_p.weight"])


def test_sigterm_in_training_snapshots_and_resumes(tmp_path, capsys):
    before = signal.getsignal(signal.SIGTERM)
    tr = _trainer(epochs=2)
    tr.fit(EpochLoader(5, hook=_sigterm(2)), EpochLoader(6, sizes=(4,)),
           "sr", str(tmp_path), plot=False, handle_sigterm=True)
    # the uploader runs ahead of the steps, so the stop lands at the step
    # boundary after the hook, whichever that is
    m = re.search(r"\[srtorch\] SIGTERM: saved resumable checkpoint at "
                  r"epoch 0 batch (\d)", capsys.readouterr().err)
    assert m and 1 <= int(m.group(1)) <= 3
    assert signal.getsignal(signal.SIGTERM) is before
    ck = load_checkpoint(str(tmp_path / "sr"))
    assert ck["epoch"] == 0
    assert ck["mid"]["batch_in_epoch"] == int(m.group(1))
    whole = _trainer(epochs=2)
    whole.fit(EpochLoader(5), EpochLoader(6, sizes=(4,)), "whole",
              str(tmp_path), plot=False)
    resumed = _trainer(epochs=2)
    resumed.fit(EpochLoader(5), EpochLoader(6, sizes=(4,)), "sr",
                str(tmp_path), checkpoint=ck, plot=False)
    a = load_checkpoint(str(tmp_path / "sr"))
    b = load_checkpoint(str(tmp_path / "whole"))
    _assert_state_equal(a, b)
    for k in ("avg_scores", "verb_losses", "val_avg_scores"):
        assert a[k] == b[k], k


def test_sigterm_in_dev_eval_writes_the_epoch_and_catches_up(tmp_path,
                                                              capsys):
    tr = _trainer(epochs=2)
    tr.fit(EpochLoader(7), EpochLoader(8, sizes=(4, 4), hook=_sigterm(1)),
           "sr", str(tmp_path), plot=False, handle_sigterm=True)
    err = capsys.readouterr().err
    assert "[srtorch] SIGTERM: saved resumable checkpoint at epoch 0" in err
    ck = load_checkpoint(str(tmp_path / "sr"))
    assert ck["epoch"] == 1 and "mid" not in ck
    assert len(ck["avg_scores"]) == 1 and ck["val_avg_scores"] == []
    stop = threading.Event()
    stop.set()
    with pytest.raises(Preempted):
        tr.evaluate(EpochLoader(8, sizes=(4, 4)), preempt=stop)
    resumed = _trainer(epochs=2)
    resumed.fit(EpochLoader(7), EpochLoader(8, sizes=(4, 4)), "sr",
                str(tmp_path), checkpoint=ck, plot=False)
    captured = capsys.readouterr()
    assert "completing the interrupted dev eval of epoch 0" in captured.err
    assert "Epoch-1, lr: 0.0020" in captured.out
    ck = load_checkpoint(str(tmp_path / "sr"))
    assert ck["epoch"] == 2
    assert len(ck["avg_scores"]) == len(ck["val_avg_scores"]) == 2


@pytest.mark.parametrize("async_save", [False, True])
def test_keep_best_and_metrics_jsonl(tmp_path, async_save):
    metrics = str(tmp_path / "m.jsonl")
    tr = _trainer(epochs=2)
    tr.fit(EpochLoader(9), EpochLoader(10, sizes=(4,)), "sr",
           str(tmp_path), plot=False, keep_best=True, metrics_jsonl=metrics,
           async_save=async_save)
    recs = [json.loads(line) for line in open(metrics)]
    assert [r["epoch"] for r in recs] == [0, 1]
    for r in recs:
        assert set(r) >= {"train_losses", "train_top1", "train_top5",
                          "train_mean", "val_losses", "val_mean",
                          "img_per_sec", "ms_per_step", "lr"}
    ck = load_checkpoint(str(tmp_path / "sr"))
    best = load_checkpoint(str(tmp_path / "sr_best"))
    vals = ck["val_avg_scores"]
    # ">=": the last epoch that reached the best mean
    last = max(i for i, v in enumerate(vals) if v == max(vals))
    assert best["val_avg_scores"] == vals[:last + 1]
    # a resume whose history holds a better val mean writes no _best
    os.remove(str(tmp_path / "sr_best"))
    ck["val_avg_scores"] = [100.0, 100.0]
    tr2 = _trainer(epochs=3)
    tr2.load_model_state(ck)
    tr2.fit(EpochLoader(9), EpochLoader(10, sizes=(4,)), "sr",
            str(tmp_path), checkpoint={k: v for k, v in ck.items()
                                       if k != "model_state_dict"},
            plot=False, keep_best=True, async_save=async_save)
    assert not os.path.exists(str(tmp_path / "sr_best"))
    assert load_checkpoint(str(tmp_path / "sr"))["epoch"] == 3


def test_plot_writes_the_curve(tmp_path):
    pytest.importorskip("matplotlib")
    tr = _trainer()
    tr.fit(EpochLoader(11, sizes=(4,)), EpochLoader(12, sizes=(4,)), "sr",
           str(tmp_path))
    assert os.path.getsize(str(tmp_path / "sr.png")) > 0


def test_async_saver_reraises(tmp_path):
    saver = AsyncSaver()
    saver.save(str(tmp_path / "missing" / "dir" / "ck"), {"epoch": 0})
    with pytest.raises(OSError):
        saver.join()
    saver.join()                       # the error is raised once
    saver.save(str(tmp_path / "ok"), {"epoch": 1}, background=False)
    assert load_checkpoint(str(tmp_path / "ok"))["epoch"] == 1


@pytest.mark.parametrize("depth", ["1", "3"])
def test_loader_error_reaches_consumer_past_a_full_queue(monkeypatch, depth):
    """The loader fails while the upload queue is full and the consumer is
    busy: the error still reaches the consumer, after the good batches."""
    monkeypatch.setenv("SRTPU_UPLOAD_DEPTH", depth)
    tr = _trainer()

    def broken():
        for i in range(int(depth) + 2):
            yield _batch(ENC, 4, seed=i)
        raise RuntimeError("decode failed")

    got = []
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="decode failed"):
        for args, batch, n in tr._device_batches(broken()):
            time.sleep(0.2)        # the uploader fills the queue meanwhile
            got.append(n)
    assert got == [4] * (int(depth) + 2)
    assert time.perf_counter() - t0 < 30
    with pytest.raises(RuntimeError, match="decode failed"):
        tr.train_epoch(broken(), 0)
