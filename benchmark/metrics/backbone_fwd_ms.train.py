"""The host's time to issue the backbone's forward: the mean of the
program's span ``backbone.forward`` (the backbone's call in
``Trainer._features``, inside ``train.fwd_bwd``) over the profiled
sub-window, in ms.  None where the program records no such span."""

import program_spans


def read(ctx):
    return program_spans.mean_ms(ctx, "backbone.forward")
