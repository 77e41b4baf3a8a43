"""The uploader's staging of a batch: the mean self time of the program's
span ``upload.stage`` (padding, the pinned copies, the window cache's
gather on the side stream, the event), less its child
``upload.slot_wait``, over the profiled sub-window, in ms."""

import program_spans


def read(ctx):
    return program_spans.mean_ms(ctx, "upload.stage", self_time=True)
