"""The bias + GELU pair's share of its roofline in a fine-tuning step: the
least time of a step's MLP activations (``gelu_work``: bytes over the
card's bandwidth) over the device time of the ``gelu_rows_`` kernels in
the profiled sub-window a step, in %.  A step is one
``gelu_rows_bwd_kernel`` launch a GELU of the forward.  None where no such
kernel ran (a program that composes its GELU from torch ops), or for a
backbone kind whose MLPs the program does not send through the pair."""

import functools
import json

import devtrace
import work

KERNELS = ("gelu_rows_",)
STEP_KERNEL = "gelu_rows_bwd_kernel"
_ITEM_BYTES = {"bfloat16": 2, "float32": 4}
#: the backbone kinds whose blocks' fc1 bias and GELU the program sends
#: through the pair (every GELU of their reference is a block's)
ROUTED = ("vit", "swin")


@functools.lru_cache(maxsize=None)
def _gelu_work(cfg_json: str, batch: int) -> tuple:
    import torch
    import torch.nn.functional as F
    from torch.overrides import TorchFunctionMode

    import seeded
    from reference import backbones
    from reference.nets import Precision

    cfg = json.loads(cfg_json)
    meta = torch.device("meta")
    bb = {n: torch.empty(s, device=meta, dtype=torch.long
                         if k == "count" else torch.float32)
          for n, s, (k, _) in seeded.backbone_leaves(cfg)}
    seen = []

    class Count(TorchFunctionMode):
        """Each GELU of the forward: its input's values."""

        def __torch_function__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if func is F.gelu:
                seen.append(args[0].numel())
            return func(*args, **kwargs)

    crop = cfg["image"]["crop"]
    x = torch.empty((batch, crop, crop, 3), device=meta)
    with torch.no_grad(), Count():
        backbones.of(cfg).features(cfg, bb, x, Precision("f32"))
    item = _ITEM_BYTES[cfg["compute_dtype"]]
    forwards = 2 if cfg["backbone"].get("remat", False) else 1
    n = sum(seen)
    return n * (forwards * 2 * item + 3 * item), len(seen)


def gelu_work(cfg: dict, batch: int) -> tuple:
    """(bytes, GELUs) of a train step's MLP activations through the pair
    for ``cfg`` at ``batch`` rows, counted on the plain reference's
    backbone on meta tensors (no arithmetic runs): each forward reads h
    (the fc1 product) and writes y once in the compute type, twice for a
    block under remat; each backward reads h and dy and writes dh once.
    The bias is not counted."""
    return _gelu_work(json.dumps(cfg, sort_keys=True), batch)


def steps(launches: int, gelus: int) -> float:
    """Steps in the sub-window: one backward launch a GELU of the
    forward."""
    return launches / gelus


def read(ctx):
    red, cfg = ctx.trace, ctx.config
    if not red or not ctx.peaks or cfg["backbone"]["kind"] not in ROUTED:
        return None
    sec, _ = devtrace.kernel_time(red, KERNELS)
    _, backwards = devtrace.kernel_time(red, (STEP_KERNEL,))
    if not sec or not backwards:
        return None
    nbytes, gelus = gelu_work(cfg, ctx.counters["batch"])
    if not gelus:
        return None
    least, _ = work.least_ms(0, nbytes, *ctx.peaks)
    return 100.0 * least / (sec / steps(backwards, gelus) * 1e3)
