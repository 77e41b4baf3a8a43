"""The LayerNorm pair's share of its roofline in a fine-tuning step: the
least time of a step's LayerNorms that the program sends through the pair
(``ln_work``: bytes over the card's bandwidth) over the device time of the
``ln_rows_`` kernels in the profiled sub-window a step, in %.  A step is
one ``ln_rows_bwd_kernel`` launch a LayerNorm of the forward.  None where
no such kernel ran (a program that composes its LayerNorms from torch
ops), or for a backbone kind with no LayerNorm through the pair."""

import functools
import json

import devtrace
import work

KERNELS = ("ln_rows_",)
STEP_KERNEL = "ln_rows_bwd_kernel"
_ITEM_BYTES = {"bfloat16": 2, "float32": 4}
#: by backbone kind, the LayerNorms (their scale's name in the reference's
#: state dict, less ``.weight``) that the program sends through the pair:
#: the names that start with ``routed``; of those, the blocks' (recomputed
#: under remat) hold ``block``, and ``f32_out`` names the norms whose
#: output the program keeps in f32 (the Swin's final norm, averaged over
#: the tokens).  ViT's final LayerNorm, on the CLS rows, stays composed.
ROUTED = {
    "vit": {"routed": "encoder.layers.", "block": "encoder_layer_",
            "f32_out": ()},
    "swin": {"routed": "", "block": ".blocks.", "f32_out": ("norm",)},
}


@functools.lru_cache(maxsize=None)
def _ln_work(cfg_json: str, batch: int) -> tuple:
    import torch
    import torch.nn.functional as F
    from torch.overrides import TorchFunctionMode

    import seeded
    from reference import backbones
    from reference.nets import Precision

    cfg = json.loads(cfg_json)
    rule = ROUTED[cfg["backbone"]["kind"]]
    meta = torch.device("meta")
    bb = {n: torch.empty(s, device=meta, dtype=torch.long
                         if k == "count" else torch.float32)
          for n, s, (k, _) in seeded.backbone_leaves(cfg)}
    names = {id(t): n[:-len(".weight")] for n, t in bb.items()
             if n.endswith(".weight")}
    seen = []

    class Count(TorchFunctionMode):
        """Each LayerNorm of the forward: its scale's name, its rows'
        values."""

        def __torch_function__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if func is F.layer_norm:
                weight = args[2] if len(args) > 2 else kwargs.get("weight")
                seen.append((names[id(weight)], args[0].numel()))
            return func(*args, **kwargs)

    crop = cfg["image"]["crop"]
    x = torch.empty((batch, crop, crop, 3), device=meta)
    with torch.no_grad(), Count():
        backbones.of(cfg).features(cfg, bb, x, Precision("f32"))
    item = _ITEM_BYTES[cfg["compute_dtype"]]
    remat = cfg["backbone"].get("remat", False)
    nbytes, norms = 0, 0
    for name, n in seen:
        if not name.startswith(rule["routed"]):
            continue
        norms += 1
        out = 4 if name in rule["f32_out"] else item
        forwards = 2 if remat and rule["block"] in name else 1
        nbytes += n * (forwards * (item + out) + item + out + item)
    return nbytes, norms


def ln_work(cfg: dict, batch: int) -> tuple:
    """(bytes, LayerNorms) of a train step's LayerNorms through the pair
    for ``cfg`` at ``batch`` rows, counted on the plain reference's
    backbone on meta tensors (no arithmetic runs): each forward reads its
    input and writes its output once, in their types (the compute type;
    f32 where ``ROUTED`` keeps the output in f32), twice for a block under
    remat; each backward reads the input and the output's gradient and
    writes the input's gradient once.  γ, β and the row statistics are not
    counted."""
    return _ln_work(json.dumps(cfg, sort_keys=True), batch)


def steps(launches: int, norms: int) -> float:
    """Steps in the sub-window: one backward launch a LayerNorm of the
    forward."""
    return launches / norms


def read(ctx):
    red, cfg = ctx.trace, ctx.config
    if not red or not ctx.peaks or cfg["backbone"]["kind"] not in ROUTED:
        return None
    sec, _ = devtrace.kernel_time(red, KERNELS)
    _, backwards = devtrace.kernel_time(red, (STEP_KERNEL,))
    if not sec or not backwards:
        return None
    nbytes, norms = ln_work(cfg, ctx.counters["batch"])
    least, _ = work.least_ms(0, nbytes, *ctx.peaks)
    return 100.0 * least / (sec / steps(backwards, norms) * 1e3)
