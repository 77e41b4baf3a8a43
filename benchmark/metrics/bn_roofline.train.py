"""Train-mode BN's share of its roofline in a train step of a ResNet cell:
the least time of the backbone's BN layers with the residual adds and
ReLUs that follow them (``bn_work``: bytes over the card's bandwidth) over
the device time of the ``batchnorm_`` kernels in the profiled sub-window
a step, in %.  A step is one ``batchnorm_apply_kernel`` launch a BN layer.
None where no such kernel ran (a program that runs torch's BN)."""

import functools
import json

import devtrace
import work

KERNELS = ("batchnorm_",)
STEP_KERNEL = "batchnorm_apply_kernel"
_ITEM_BYTES = {"bfloat16": 2, "float32": 4}


@functools.lru_cache(maxsize=None)
def _bn_work(cfg_json: str, batch: int) -> tuple:
    import torch
    from torch.overrides import TorchFunctionMode

    import seeded
    from reference.backbones import resnet
    from reference.nets import Precision

    cfg = json.loads(cfg_json)
    meta = torch.device("meta")
    bb = {n: torch.empty(s, device=meta, dtype=torch.long
                         if k == "count" else torch.float32)
          for n, s, (k, _) in seeded.backbone_leaves(cfg)}
    crop = cfg["image"]["crop"]
    seen = {"layers": 0, "bn": 0, "residual": 0}

    class Count(TorchFunctionMode):
        """A train-mode BN takes its input's variance; a block's residual
        add is the one sum of two 4-D tensors of one shape."""

        def __torch_function__(self, func, types, args=(), kwargs=None):
            name = getattr(func, "__name__", "")
            if name == "var":
                seen["layers"] += 1
                seen["bn"] += args[0].numel()
            elif name in ("add", "__add__") and len(args) == 2 \
                    and all(isinstance(a, torch.Tensor) and a.dim() == 4
                            for a in args) \
                    and args[0].shape == args[1].shape:
                seen["residual"] += args[0].numel()
            return func(*args, **(kwargs or {}))

    x = torch.empty((batch, crop, crop, 3), device=meta)
    with Count():
        resnet.forward(bb, x, cfg["backbone"]["stage_sizes"],
                       Precision("f32"), bn="train")
    item = _ITEM_BYTES[cfg["compute_dtype"]]
    return item * (3 * seen["bn"] + seen["residual"]), seen["layers"]


def bn_work(cfg: dict, batch: int) -> tuple:
    """(bytes, BN layers) of a train step's BN of ``cfg`` at ``batch``
    rows, counted on the plain reference's ResNet on meta tensors (no
    arithmetic runs): every BN input read twice (its statistics, its
    normalisation), every BN output written once and each block's residual
    read once, in the compute type.  The ReLUs and adds move no bytes of
    their own: the least traffic fuses them into the normalisation."""
    return _bn_work(json.dumps(cfg, sort_keys=True), batch)


def read(ctx):
    red, cfg = ctx.trace, ctx.config
    if not red or not ctx.peaks or cfg["backbone"]["kind"] != "resnet":
        return None
    sec, _ = devtrace.kernel_time(red, KERNELS)
    _, applies = devtrace.kernel_time(red, (STEP_KERNEL,))
    if not sec or not applies:
        return None
    nbytes, layers = bn_work(cfg, ctx.counters["batch"])
    least, _ = work.least_ms(0, nbytes, *ctx.peaks)
    return 100.0 * least / (sec / (applies / layers) * 1e3)
