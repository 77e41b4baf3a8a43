"""The Swin window-attention backward's share of its roofline in a
fine-tuning step: the least time of a step's launches
(``window_work.step_least_ms``: every block at its shape) over the device
time a step of ``swin_wattn_bwd_kernel`` and ``swin_wattn_dbias_kernel``
in the profiled sub-window, a step being ``window_work.launches_a_step``
launches of ``swin_wattn_bwd_kernel``, in %.  None on a configuration
whose backbone kind is not ``swin``."""

import devtrace
import window_work


def read(ctx):
    red, c, cfg = ctx.trace, ctx.counters, ctx.config
    if not red or not ctx.peaks or cfg["backbone"]["kind"] != "swin":
        return None
    sec, _ = devtrace.kernel_time(red, ("swin_wattn_bwd_kernel",
                                        "swin_wattn_dbias_kernel"))
    _, n = devtrace.kernel_time(red, ("swin_wattn_bwd_kernel",))
    if not n:
        return None
    steps = n / window_work.launches_a_step(cfg, True)
    least = window_work.step_least_ms(cfg, c["batch"], *ctx.peaks, True)
    return 100.0 * least / (sec / steps * 1e3)
