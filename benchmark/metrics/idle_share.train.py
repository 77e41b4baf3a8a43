"""The device's idle share in a training window: 1 - busy / wall over the
profiled sub-window, busy being the union of the device's kernel and copy
intervals (``devtrace.reduce``), in %."""

import devtrace


def read(ctx):
    return devtrace.idle_share(ctx.trace)
