"""How near the host is to setting the pace: the main thread's time in the
program's spans ``train.fwd_bwd``, ``train.apply``, ``train.fetch`` and
``train.score`` summed over the profiled sub-window, over the
sub-window's wall time (``devtrace.reduce``'s ``window_s``), in %."""

import program_spans

NAMES = ("train.fwd_bwd", "train.apply", "train.fetch", "train.score")


def read(ctx):
    spans = program_spans.recorded(ctx)
    if not any(s.name == "train.fwd_bwd" for s in spans):
        return None
    busy = sum(sum(program_spans.seconds(spans, n)) for n in NAMES)
    return 100.0 * busy / ctx.trace["window_s"]
