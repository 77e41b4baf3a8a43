"""The program's own spans of a ``--trace 1`` run's profiled sub-window.

The port records its spans (``situation_recognition_tpu_torch/utils/
trace.py``) while a profiler records, so after the run those it holds
began inside the sub-window: the step loop's ``train.*`` on the main
thread and the uploader's ``upload.*``.  The readers take those that also
ended inside it.  The sub-window opens with the first of them (the
profiler starts on the step call, and the step's ``train.fwd_bwd`` opens
within µs) and lasts ``window_s`` (``devtrace.reduce``), up to the
synchronise before the profiler stops; a span still open then, such as
the uploader staging a batch beyond the window, is stretched by the
synchronise and the profiler's processing.  A program without the
recorder, or a run that recorded nothing, reads as no spans, and every
reader then returns None.
"""

from __future__ import annotations

from statistics import fmean


def recorded(ctx) -> list:
    """The spans of the sub-window, or [] where the program has no
    recorder or the run no trace."""
    red = ctx.trace
    if not red or red["window_s"] <= 0:
        return []
    try:
        from situation_recognition_tpu_torch.utils import trace
    except ImportError:
        return []
    spans = trace.spans()
    if not spans:
        return []
    end = min(s.start for s in spans) + red["window_s"] * 1e9
    return [s for s in spans if s.end <= end]


def seconds(spans, name: str, self_time: bool = False) -> list:
    """The durations (s) of the spans called ``name``; with ``self_time``
    less the time of their child spans."""
    out = {id(s): (s.end - s.start) / 1e9 for s in spans if s.name == name}
    if self_time:
        for s in spans:
            if s.parent is not None and id(s.parent) in out:
                out[id(s.parent)] -= (s.end - s.start) / 1e9
    return list(out.values())


def mean_ms(ctx, name: str, self_time: bool = False) -> float | None:
    """The mean duration of span ``name`` in the sub-window, in ms."""
    got = seconds(recorded(ctx), name, self_time)
    return 1e3 * fmean(got) if got else None
