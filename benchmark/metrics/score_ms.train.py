"""The host's scoring of a step two steps back: the mean of the program's
span ``train.score`` (``Trainer._score`` on the fetched top-k) over the
profiled sub-window, in ms."""

import program_spans


def read(ctx):
    return program_spans.mean_ms(ctx, "train.score")
