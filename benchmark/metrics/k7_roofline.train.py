"""K7's share of its roofline in a fine-tuning step: the least time of the
attention core's forward (``work.attention_work`` at the cell's batch,
tokens, heads and head width) over the device time of one launch of
``attn_kernel`` in the profiled sub-window, in %."""

import devtrace
import work


def read(ctx):
    red, c, b = ctx.trace, ctx.counters, ctx.config["backbone"]
    if not red or not ctx.peaks or b["kind"] != "vit":
        return None
    sec, n = devtrace.kernel_time(red, ("attn_kernel",))
    if not n:
        return None
    tokens = (ctx.config["image"]["crop"] // b["patch"]) ** 2 + 1
    flops, nbytes = work.attention_work(c["batch"], tokens, b["heads"],
                                        b["width"] // b["heads"], False)
    least, _ = work.least_ms(flops, nbytes, *ctx.peaks)
    return 100.0 * least / (sec / n * 1e3)
