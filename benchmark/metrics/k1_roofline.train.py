"""K1's share of its roofline in a train step: the least time of the
folded GGNN propagate of the gt-verb branch (``work.k1_work`` at the
cell's batch · roles nodes, the head's width and the window's role
graphs) over the device time of one launch of its kernels in the
profiled sub-window, in %.  A launch is ``ggnn_steps`` aggregation
kernels and their GEMMs."""

import devtrace
import work

KERNELS = ("ggnn_agg_kernel", "ggnn_gemm_kernel")


def read(ctx):
    red, c, h = ctx.trace, ctx.counters, ctx.config["head"]
    if not red or not ctx.peaks:
        return None
    sec = sum(s for name, (s, _) in red["kernels"].items()
              if any(k in name for k in KERNELS) and "Bwd" not in name)
    _, aggs = devtrace.kernel_time(red, ("ggnn_agg_kernel",))
    launches = aggs / h["ggnn_steps"]
    if not sec or not launches:
        return None
    flops, nbytes = work.k1_work(c["k1_rows"], h["hidden"], h["ggnn_steps"],
                                 c["k1_edges"])
    least, _ = work.least_ms(flops, nbytes, *ctx.peaks)
    return 100.0 * least / (sec / launches * 1e3)
