"""The benchmark's own counts of work: a train step's FLOPs, and the
operations and bytes of the hand kernels whose roofline shares it reads.

A kernel's least time is the larger of its operations over the card's
bf16 peak and its bytes over the HBM bandwidth.  Each input byte counts
read once and each output byte written once, whatever the kernel reads
again; where the work depends on the data (the role graphs' edges), the
count is what the given inputs need.
"""

from __future__ import annotations

import functools


def least_ms(flops: float, nbytes: float, peak_flops: float,
             peak_bytes: float) -> tuple:
    """(least time in ms, the term that sets it)."""
    t_ops = flops / peak_flops * 1e3
    t_bytes = nbytes / peak_bytes * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def k1_work(m: int, d: int, steps: int, edges: float) -> tuple:
    """(operations, bytes) of one folded GGNN propagate (K1) of ``m``
    nodes of width ``d``: per step the gate products (2·m·d·3d + 2·m·d·2d)
    and the candidate product (2·m·d·d), and the adjacency sum over the
    role graphs' ``edges`` nonzeros; h, the mask, the folded weights and
    biases read once, h written once (bf16 h, f32 mask and biases)."""
    flops = steps * (12 * m * d * d + 2 * edges * d)
    nbytes = m * d * 2 + m * 4 + 6 * d * d * 2 + 3 * d * 4 + m * d * 2
    return flops, nbytes


def attention_work(batch: int, tokens: int, heads: int, dh: int,
                   backward: bool) -> tuple:
    """(operations, bytes) of the attention core over a (batch·tokens,
    heads·dh) bf16 stream.  Forward (K7): S = Q·Kᵀ and P·V, 4·B·h·N²·dh;
    q, k, v read and the context written.  Backward (K8): S again, dV,
    dP, dQ and dK, 10·B·h·N²·dh; q, k, v, the context and its cotangent
    read, dq, dk and dv written."""
    per = batch * heads * tokens * tokens * dh
    stream = batch * tokens * heads * dh * 2
    if backward:
        return 10 * per, 8 * stream
    return 4 * per, 4 * stream


@functools.lru_cache(maxsize=None)
def _step_flops(cfg_json: str, batch: int) -> int:
    import json

    import torch
    from torch.utils.flop_counter import FlopCounterMode

    import seeded
    from reference import nets
    from reference import train as ref_train

    cfg = json.loads(cfg_json)
    h = cfg["head"]
    meta = torch.device("meta")

    def empty(leaves, grad):
        return {n: torch.empty(s, device=meta, dtype=torch.long
                               if k == "count" else torch.float32)
                .requires_grad_(grad and k != "count")
                for n, s, (k, _) in leaves}

    ft = cfg["backbone"]["train"]
    bb = empty(seeded.backbone_leaves(cfg), ft)
    head = empty(seeded.head_leaves(h), True)
    w = cfg["image"]["window"]
    images = torch.empty((batch, w, w, 3), dtype=torch.uint8, device=meta)
    flip = torch.empty((batch,), dtype=torch.bool, device=meta)
    verbs = torch.empty((batch,), dtype=torch.long, device=meta)
    labels = torch.empty((batch, 3, h["max_roles"]), dtype=torch.long,
                         device=meta)
    role_ids = torch.empty((h["num_verbs"], h["max_roles"]),
                           dtype=torch.long, device=meta)
    counts = torch.empty((h["num_verbs"],), dtype=torch.long, device=meta)
    p = nets.Precision("f32")
    cfg = {**cfg, "backbone": {**cfg["backbone"], "remat": False}}
    counter = FlopCounterMode(display=False)
    with counter:
        with torch.set_grad_enabled(ft):
            feats = ref_train.features(cfg, bb, images, flip, p)
        vl = nets.verb_logits(head, feats, h["ggnn_steps"], p)
        nl = nets.noun_logits(head, feats, torch.argmax(vl, 1), role_ids,
                              counts, h["ggnn_steps"], p)
        loss = nets.verb_loss(vl, verbs) + nets.nouns_loss(
            nl, labels, h["num_labels"])
        params = [v for v in list(head.values()) + list(bb.values())
                  if v.requires_grad]
        torch.autograd.grad(loss, params)
        with torch.no_grad():
            nets.noun_logits(head, feats.detach(), verbs, role_ids, counts,
                             h["ggnn_steps"], p)
    return int(counter.get_total_flops())


def step_flops(cfg: dict, batch: int) -> int:
    """FLOPs of one train step of ``cfg`` at ``batch`` rows, counted by
    ``FlopCounterMode`` over the plain reference on meta tensors (no
    arithmetic runs): the device transform and the backbone forward, the
    verb and predicted-verb noun branches and their backward (the
    backbone's too when it is fine-tuned), and the gt-verb noun branch.
    A recomputation for memory (remat) is not work and is not counted."""
    import json

    return _step_flops(json.dumps(cfg, sort_keys=True), batch)
