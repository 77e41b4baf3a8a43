"""The port's span recorder (``utils/trace.py``) and the spans of the
training loop, on the CPU's mini trainer: nothing recorded and no clock
read without a profiler; under a CPU ``torch.profiler`` every span of the
step loop and the uploader, nested and sharing their batch's index, the
main thread's on the profiler's clock; the cap; ``recording()``; and
``profile_trace``'s file carrying the uploader's spans beside the main
thread's.  The pinned slots' wait exists on the card only (marked
``cuda``)."""

import json
import os
import sys
import time

import numpy as np
import pytest
import torch

from situation_recognition_tpu_torch import train as train_mod
from situation_recognition_tpu_torch.data.encoder import ImsituEncoder
from situation_recognition_tpu_torch.train import Trainer, TrainerConfig
from situation_recognition_tpu_torch.utils import trace
from situation_recognition_tpu_torch.utils.logging import profile_trace

B = 2
STEP = ("train.fwd_bwd", "train.apply", "train.readback", "train.fetch",
        "train.score")
UPLOAD = ("upload.next", "upload.stage", "upload.put_wait")
CPU = [torch.profiler.ProfilerActivity.CPU]


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh_recorder():
    trace.reset()
    yield
    trace.reset()


def _batches(enc, count, seed=0):
    rng = np.random.default_rng(seed)
    return [{"images": rng.integers(0, 256, (B, 256, 256, 3),
                                    dtype=np.uint8),
             "flip": rng.random(B) < 0.5,
             "verbs": rng.integers(0, enc.get_num_verbs(), B),
             "labels": rng.integers(0, enc.get_num_labels(),
                                    (B, 3, enc.max_role_count))}
            for _ in range(count)]


@pytest.fixture(scope="module")
def setup():
    enc = ImsituEncoder.synthetic_full(0)
    tr = Trainer(enc, TrainerConfig(
        hidden=32, batch_size=B, backbone="mini", image_size=32,
        compute_dtype=torch.float32, dropout_rate=0.0), device="cpu")
    return tr, _batches(enc, 5)


def _profiled_epoch(tr, batches):
    with torch.profiler.profile(activities=CPU) as prof:
        tr.train_epoch(batches, 0)
    return prof, trace.spans()


def test_an_unprofiled_epoch_records_nothing_and_reads_no_clock(
        setup, monkeypatch):
    tr, batches = setup
    calls = []
    time_ns = time.time_ns

    def counted():
        if sys._getframe(1).f_globals.get("__name__") == trace.__name__:
            calls.append(1)
        return time_ns()

    monkeypatch.setattr(time, "time_ns", counted)
    tr.train_epoch(batches, 0)
    tr.evaluate(batches)
    assert calls == []
    assert trace.spans() == [] and trace.dropped() == 0
    assert trace.span("train.step", 3) is trace.OFF
    with trace.span("train.step") as s:
        assert s is None


def test_a_profiled_epoch_records_every_span_nested_by_batch(setup):
    tr, batches = setup
    _, spans = _profiled_epoch(tr, batches)
    names = {s.name for s in spans}
    # upload.slot_wait waits on a pinned slot's CUDA event: the card's
    assert names == {"train.step", "train.batch_wait", *STEP, *UPLOAD}
    main = [s for s in spans if s.name.startswith("train.")]
    assert {s.thread for s in main} == {"MainThread"}
    assert {s.thread for s in spans if s.name.startswith("upload.")} == \
        {"srtorch-uploader"}
    steps = [s for s in spans if s.name == "train.step"]
    assert [s.batch for s in steps] == list(range(len(batches)))
    depth = train_mod.pipeline_depth()
    for s in main:
        if s.name in ("train.fwd_bwd", "train.apply"):
            assert s.parent.name == "train.step"
            assert s.batch == s.parent.batch
        elif s.name in STEP:
            # the last steps in flight are read back after the loop
            if s.batch < len(batches) - depth:
                assert s.parent.name == "train.step"
                assert s.parent.batch == s.batch + depth
            else:
                assert s.parent is None
        else:
            assert s.parent is None, s
        if s.parent is not None:
            assert s.parent.start <= s.start <= s.end <= s.parent.end
    for b in range(len(batches)):
        stage = [s for s in spans if s.name == "upload.stage"
                 and s.batch == b]
        fwd_bwd = [s for s in spans if s.name == "train.fwd_bwd"
                   and s.batch == b]
        assert len(stage) == len(fwd_bwd) == 1, b
        # staged before the step that trains on it
        assert stage[0].end <= fwd_bwd[0].start


def test_the_main_threads_spans_lie_on_the_profilers_clock(setup):
    tr, batches = setup
    prof, spans = _profiled_epoch(tr, batches)
    start_ns = prof.profiler.kineto_results.trace_start_ns()
    events = {}
    for ev in prof.events():
        events.setdefault(ev.name, []).append(ev.time_range)
    assert not any(n.startswith("upload.") for n in events)
    for name in ("train.step", "train.batch_wait", *STEP):
        ours = [s for s in spans if s.name == name]
        theirs = events[name]
        assert len(ours) == len(theirs), name
        for s, r in zip(ours, theirs):
            assert abs((s.start - start_ns) / 1e3 - r.start) < 1000, name
            assert abs((s.end - start_ns) / 1e3 - r.end) < 1000, name


def test_evaluate_records_no_span_under_a_profiler(setup):
    tr, batches = setup
    with torch.profiler.profile(activities=CPU):
        tr.evaluate(batches)
    assert trace.spans() == []


def test_recording_turns_spans_on_and_nests():
    assert trace.span("x") is trace.OFF
    with trace.recording():
        with trace.recording():
            with trace.span("a", 7) as a:
                with trace.span("b") as b:
                    pass
        with trace.span("c"):
            pass
    assert trace.span("x") is trace.OFF
    assert [s.name for s in trace.spans()] == ["b", "a", "c"]
    assert b.parent is a and b.batch == 7 and a.parent is None
    with trace.recording():
        outlives = trace.span("outlives")
        outlives.__enter__()
    # decided when entered: kept though it ends with recording off
    outlives.__exit__(None, None, None)
    assert trace.spans()[-1] is outlives
    assert a.start <= b.start <= b.end <= a.end
    assert a.seconds >= b.seconds >= 0


def test_the_cap_counts_what_it_drops():
    rec = trace.Recorder(cap=3)
    with rec.recording():
        for i in range(5):
            with rec.span("s", i) as s:
                pass
            assert s is not None and s.batch == i
    assert [s.batch for s in rec.spans()] == [0, 1, 2]
    assert rec.dropped() == 2
    rec.reset()
    assert rec.spans() == [] and rec.dropped() == 0


def test_profile_trace_writes_the_uploaders_spans_beside_the_main_threads(
        setup, tmp_path):
    tr, batches = setup
    with trace.recording():
        with trace.span("before profile_trace"):
            pass
    with profile_trace(str(tmp_path)):
        tr.train_epoch(batches, 0)
    (name,) = os.listdir(tmp_path)
    with open(tmp_path / name) as f:
        events = json.load(f)["traceEvents"]
    by_name = {}
    for e in events:
        if e.get("ph") == "X":
            by_name.setdefault(e["name"], []).append(e)
    assert "before profile_trace" not in by_name
    stage, fwd_bwd = by_name["upload.stage"], by_name["train.fwd_bwd"]
    assert len(stage) == len(fwd_bwd) == len(batches)
    uploader = {e["tid"] for e in stage}
    assert uploader.isdisjoint({e["tid"] for e in fwd_bwd})
    assert {e["args"]["batch"] for e in stage} == set(range(len(batches)))
    rows = {e["tid"]: e["args"]["name"] for e in events
            if e.get("ph") == "M" and e.get("name") == "thread_name"}
    assert {rows[t] for t in uploader} == {"srtorch-uploader"}
    # on the file's time base: each batch staged before its step
    for b in range(len(batches)):
        s = next(e for e in stage if e["args"]["batch"] == b)
        f = sorted(fwd_bwd, key=lambda e: e["ts"])[b]
        assert s["ts"] + s["dur"] <= f["ts"] + 1.0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_the_pinned_slots_wait_is_a_span_on_the_card(cuda_device):
    enc = ImsituEncoder.synthetic_full(0)
    tr = Trainer(enc, TrainerConfig(
        hidden=64, batch_size=B, backbone="mini", image_size=32,
        compute_dtype=torch.float32, dropout_rate=0.0), device=cuda_device)
    batches = _batches(enc, 8)
    with torch.profiler.profile(activities=CPU):
        tr.train_epoch(batches, 0)
    spans = trace.spans()
    waits = [s for s in spans if s.name == "upload.slot_wait"]
    # a slot is waited on from its second use: the pool holds depth + 2
    assert waits and all(s.parent.name == "upload.stage" for s in waits)
    assert all(s.batch == s.parent.batch for s in waits)
    assert {s.name for s in spans} >= {"train.step", *STEP, *UPLOAD}
