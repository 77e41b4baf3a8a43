"""The host's time to issue a train step: the mean of the program's span
``train.fwd_bwd`` (``Trainer.accum_step``) plus the mean of ``train.apply``
(``apply_step``: the clip, the rate and Adamax) over the profiled
sub-window, in ms.  While the card keeps up with the launches this is
Python and launch overhead; once its launch queue is full the launches
block, and it reads the device's pace."""

import program_spans


def read(ctx):
    fwd_bwd = program_spans.mean_ms(ctx, "train.fwd_bwd")
    apply = program_spans.mean_ms(ctx, "train.apply")
    if fwd_bwd is None or apply is None:
        return None
    return fwd_bwd + apply
