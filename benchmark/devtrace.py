"""The reduction of a ``torch.profiler`` session over a sub-window of a run:
the union of the device's busy intervals, each kernel's device time and
count, time by category, the top device operations and the longest idle
gaps by what the host was doing.

``category`` and the union of intervals are copies of the arithmetic of
the program's ``tools/profile_step.py`` (``category``,
``device_busy_ms``), so that the yardstick does not move with it.
"""

from __future__ import annotations

#: the hand kernels by a substring of their CUDA kernel names
HAND_KERNELS = (
    ("K3 ggnn_folded_bwd", ("ggnn_bwd_", "BwdArgs")),
    ("K1/K2 ggnn_folded", ("ggnn_agg_kernel", "ggnn_gemm_kernel")),
    ("K8 vit_attention_bwd", ("dq_kernel", "dkv_kernel")),
    ("K5/K7 vit_attention", ("attn_kernel",)),
    ("K4/K6 vit_block", ("layernorm_kernel", "gemm_kernel")),
)


def category(name: str) -> str:
    """A device kernel's category."""
    for label, keys in HAND_KERNELS:
        if any(k in name for k in keys):
            return label
    n = name.lower()
    if any(k in n for k in ("nccl", "allreduce", "all_reduce", "c10d")):
        return "collective"
    if "memcpy" in n or "memset" in n:
        return "copy"
    if any(k in n for k in ("conv", "cudnn", "fprop", "dgrad", "wgrad",
                            "implicit_gemm", "winograd")):
        return "convolution"
    if any(k in n for k in ("gemm", "cutlass", "mm", "matmul", "linear",
                            "sm90_xmma", "cublas", "nvjet")):
        return "gemm"
    if any(k in n for k in ("elementwise", "reduce", "norm", "softmax",
                            "vectorized", "aten::")):
        return "elementwise"
    return "other"


def union(spans) -> float:
    """Seconds covered by the union of (start, end) spans in µs."""
    busy, end = 0.0, None
    for s, e in sorted(spans):
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy / 1e6


def reduce(prof, window_s: float) -> dict:
    """A finished profiler session → ``busy_s``, ``window_s``, ``kernels``
    ({name: [device seconds, count]}), ``categories`` ({name: seconds})
    and ``breakdown`` (the 10 longest device operations by name, and the
    10 longest idle gaps by the innermost host operation around each)."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    dev, host = [], []
    for ev in prof.events():
        span = (ev.time_range.start, ev.time_range.end)
        if ev.device_type == cuda:
            dev.append((span, ev.name))
        elif span[1] > span[0]:
            host.append((span, ev.name))
    kernels: dict = {}
    for (s, e), name in dev:
        k = kernels.setdefault(name, [0.0, 0])
        k[0] += (e - s) / 1e6
        k[1] += 1
    cats: dict = {}
    for name, (sec, _) in kernels.items():
        c = category(name)
        cats[c] = cats.get(c, 0.0) + sec
    spans = sorted(s for s, _ in dev)
    gaps = []
    end = None
    for s, e in spans:
        if end is not None and s > end:
            gaps.append((end, s))
        end = e if end is None else max(end, e)
    host.sort(key=lambda h: h[0][1] - h[0][0])
    idle = []
    for g0, g1 in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
        mid = (g0 + g1) / 2
        what = next((n for (s, e), n in host if s <= mid <= e), "none")
        idle.append([what, (g1 - g0) / 1e6])
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:10]
    return {"busy_s": union(spans), "window_s": window_s,
            "kernels": kernels, "categories": cats,
            "breakdown": {"device_ops": [[n, v[0]] for n, v in top],
                          "idle_gaps": idle}}


def kernel_time(red: dict, keys) -> tuple:
    """(device seconds, count) of the kernels whose names hold one of
    ``keys``."""
    sec, n = 0.0, 0
    for name, (s, c) in red["kernels"].items():
        if any(k in name for k in keys):
            sec += s
            n += c
    return sec, n


def idle_share(red) -> float | None:
    """The device's idle share of the traced sub-window, in %."""
    if not red or red["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - red["busy_s"] / red["window_s"])


def category_share(red, name: str) -> float | None:
    """A category's device time over the device's busy time, in %."""
    if not red or red["busy_s"] <= 0 or name not in red["categories"]:
        return None
    return 100.0 * red["categories"][name] / red["busy_s"]
