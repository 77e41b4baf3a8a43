"""Spans of the port's own host code: the training loop's steps, its waits
on the device and on data, scoring, and the uploader thread's work.

``span(name, batch=None)`` is a context manager that records one span
while a ``torch.profiler`` session records in this process, or inside
``recording()``; otherwise it reads that flag and returns a shared no-op
context, reading no clock and allocating nothing.  Whether a span is
recorded is decided when it is entered.  A recorded span keeps its name,
its thread's name and native id, its start and end on ``time.time_ns()``
(the profiler's host clock: Unix-epoch ns), its parent (the enclosing
recorded span on the same thread) and ``batch``, the batch's index in the
epoch (by default its parent's), which the uploader's spans and the
step's spans of one batch share.  ``with span(...) as s`` binds the
``Span`` (``None`` when nothing is recorded).

Spans stay in memory, at most ``CAP`` (the rest counted in ``dropped()``);
``spans()`` reads them and ``reset()`` clears them.  While a profiler
records, a span is also a range of the profiler's own on the thread that
enters it (a function-scope range, which puts no interval on the device's
rows of the trace), so that its host events name what the main thread was
doing; the profiler does not see the threads Python starts, and
``utils/logging.profile_trace`` writes their spans into its trace.

The spans of ``train.py``: ``train.step`` (one iteration of
``train_epoch``'s loop, parent of ``train.fwd_bwd`` (``accum_step``, parent
of ``backbone.forward``, the backbone's call in ``Trainer._features`` in
a train step, on every backbone kind: the host's issue of its forward),
``train.apply`` (``apply_step``), ``train.readback`` (the losses read back:
the host waiting on the device), ``train.fetch`` (the top-k read back) and
``train.score``), ``train.batch_wait`` (the step loop waiting for the next
batch and taking it over from the uploader), and on the uploader thread
``upload.next`` (the loader making the next host batch), ``upload.stage``
(padding, pinned copies, the window cache's gather, the event; its child
``upload.slot_wait``, a pinned slot's last copies) and ``upload.put_wait``
(the queue full).
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Iterator, List, Optional

import torch
from torch.autograd import profiler as _profiler

#: spans kept in memory at most
CAP = 65_536
#: the profiler's function-scope range (a user-scope ``record_function``
#: would also lay its interval over the device's rows of the trace)
_RANGE = getattr(torch._C._profiler, "_RecordFunctionFast", None)


class _Off:
    """The shared context of a span that is not recorded."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc) -> bool:
        return False


OFF = _Off()


class Span:
    """One recorded span (see the module docstring)."""

    __slots__ = ("name", "batch", "thread", "tid", "start", "end", "parent",
                 "_recorder", "_range")

    def __init__(self, recorder: "Recorder", name: str,
                 batch: Optional[int]):
        self.name, self.batch, self._recorder = name, batch, recorder
        self.start = self.end = None
        self.parent: Optional[Span] = None
        self._range = None

    @property
    def seconds(self) -> float:
        return (self.end - self.start) / 1e9

    def __enter__(self) -> "Span":
        stack = self._recorder._stack()
        self.parent = stack[-1] if stack else None
        if self.batch is None and self.parent is not None:
            self.batch = self.parent.batch
        stack.append(self)
        self.thread = threading.current_thread().name
        self.tid = threading.get_native_id()
        if _profiler._is_profiler_enabled and _RANGE is not None:
            self._range = _RANGE(self.name)
            self._range.__enter__()
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end = time.time_ns()
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        self._recorder._stack().pop()
        self._recorder._keep(self)
        return False


class Recorder:
    """Spans in memory, up to ``cap``; recording while a profiler records
    or a ``recording()`` context is open."""

    def __init__(self, cap: int = CAP):
        self.cap = cap
        self._lock = threading.Lock()
        self._local = threading.local()
        self._on = 0
        self._spans: List[Span] = []
        self._dropped = 0

    def span(self, name: str, batch: Optional[int] = None):
        if not (self._on or _profiler._is_profiler_enabled):
            return OFF
        return Span(self, name, batch)

    @contextlib.contextmanager
    def recording(self) -> Iterator[None]:
        with self._lock:
            self._on += 1
        try:
            yield
        finally:
            with self._lock:
                self._on -= 1

    def spans(self) -> List[Span]:
        with self._lock:
            return list(self._spans)

    def dropped(self) -> int:
        return self._dropped

    def reset(self) -> None:
        with self._lock:
            self._spans = []
            self._dropped = 0

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _keep(self, s: Span) -> None:
        with self._lock:
            if len(self._spans) < self.cap:
                self._spans.append(s)
            else:
                self._dropped += 1


#: the process's recorder, which the port's spans go to
RECORDER = Recorder()
span = RECORDER.span
recording = RECORDER.recording
spans = RECORDER.spans
dropped = RECORDER.dropped
reset = RECORDER.reset
