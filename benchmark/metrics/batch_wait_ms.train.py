"""The step loop's wait for its next batch: the mean of the program's span
``train.batch_wait`` (in ``Trainer._device_batches``, the consumer's take
from the uploader's queue and the batch's hand-over to the step's stream,
where the uploader's Python may hold the interpreter) over the profiled
sub-window, in ms."""

import program_spans


def read(ctx):
    return program_spans.mean_ms(ctx, "train.batch_wait")
