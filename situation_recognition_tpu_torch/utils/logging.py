"""The reference's metric formatting, step timing and the profiler hook.

Port of ``situation_recognition_tpu/utils/logging.py``: ``format_dict``
(the reference's stdout format), ``StepTimer`` and ``profile_trace``, the
counterpart of ``jax_profile_trace`` on ``torch.profiler``, which also
carries the port's spans (``utils/trace.py``) of every thread.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, Iterator, Optional


def format_dict(d: Dict[str, float], s: str, p: str) -> str:
    """'<p><key>: <s.format(v*100)>' joined by ', ' (reference format)."""
    return ", ".join(p + str(k) + ": " + s.format(v * 100)
                     for k, v in d.items())


class StepTimer:
    """Images/s and step time of a loop, skipping ``warmup_steps`` steps
    (the first launches build and tune kernels)."""

    def __init__(self, warmup_steps: int = 2):
        self.warmup_steps = warmup_steps
        self.reset()

    def reset(self) -> None:
        self._steps = 0
        self._images = 0
        self._time = 0.0
        self._last: Optional[float] = None

    def lap(self, num_images: int) -> float:
        """Interval timing for pipelined loops: each call records the time
        since the previous ``lap`` as one step of ``num_images``.  The
        first lap after ``reset`` only arms the clock, and
        ``warmup_steps`` more are skipped."""
        now = time.perf_counter()
        if self._last is None:
            self._last = now
            self._steps += 1
            return 0.0
        dt = now - self._last
        self._last = now
        self._steps += 1
        if self._steps > self.warmup_steps:
            self._images += num_images
            self._time += dt
        return dt

    @property
    def images_per_sec(self) -> float:
        return self._images / self._time if self._time > 0 else 0.0

    @property
    def mean_step_time(self) -> float:
        n = self._steps - self.warmup_steps
        return self._time / n if n > 0 else 0.0


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]) -> Iterator[None]:
    """A ``torch.profiler`` trace of the region into ``log_dir`` (``None``:
    no-op): the host's operators and, with a card, its kernels and copies,
    written on exit as a Chrome trace ``trace_<pid>_<ns>.json``
    (``chrome://tracing``, Perfetto).  The JAX package's
    ``jax_profile_trace``, which ``SRTPU_PROFILE_DIR`` turns on around
    ``fit``'s first epoch of training.

    The port's spans (``utils/trace.py``) record while the profiler does:
    the main thread's appear as the profiler's own ranges, and the spans of
    threads the profiler did not see (the uploader's) are added to the file
    as rows of their own, on its time base, so that staging shows beside
    the kernels."""
    if log_dir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    from situation_recognition_tpu_torch.utils import trace

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    trace.reset()
    with profile(activities=activities) as prof:
        yield
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    _add_thread_spans(path, trace.spans())


def _add_thread_spans(path: str, spans) -> None:
    """Write ``spans`` of the threads the Chrome trace at ``path`` has no
    event of into it, one row (``tid``) a thread named after it, on the
    trace's time base (``baseTimeNanoseconds``; absolute µs without it)."""
    with open(path) as f:
        doc = json.load(f)
    events = doc["traceEvents"]
    seen = {e.get("tid") for e in events if e.get("ph") == "X"}
    base = doc.get("baseTimeNanoseconds", 0)
    pid = os.getpid()
    added, named = 0, set()
    for s in spans:
        if s.tid in seen:
            continue
        if s.tid not in named:
            named.add(s.tid)
            events.append({"ph": "M", "name": "thread_name", "pid": pid,
                           "tid": s.tid, "args": {"name": s.thread}})
        events.append({"ph": "X", "cat": "span", "name": s.name,
                       "pid": pid, "tid": s.tid,
                       "ts": (s.start - base) / 1e3,
                       "dur": (s.end - s.start) / 1e3,
                       "args": {"batch": s.batch}})
        added += 1
    if added:
        with open(path, "w") as f:
            json.dump(doc, f)
