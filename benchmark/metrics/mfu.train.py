"""The whole train step's share of the card's dense bf16 peak: the FLOPs
of a step (``work.step_flops``, counted on the plain reference at the
cell's shapes) times the steps of the window, over the window's seconds
and the peak, in %.  The card's power limit is in the result's
``device``."""

import work


def read(ctx):
    c = ctx.counters
    if not ctx.peaks or not c.get("steps"):
        return None
    flops = work.step_flops(ctx.config, c["batch"])
    return 100.0 * flops * c["steps"] / c["window_s"] / ctx.peaks[0]
