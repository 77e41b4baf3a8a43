"""The share of the device's busy time in elementwise kernels (batch
norm, activations, adds, reductions: ``devtrace.category``) over the
profiled sub-window of a training window, in %."""

import devtrace


def read(ctx):
    return devtrace.category_share(ctx.trace, "elementwise")
