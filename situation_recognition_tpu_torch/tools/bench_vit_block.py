"""The ViT encoder block's attention-core variants, timed on the card:

    python -m situation_recognition_tpu_torch.tools.bench_vit_block \\
        [--batch 256] [--blocks 4] [--width l14|b16] [--iters 20]

The counterpart of the JAX package's ``tools/bench_vit_block.py``: a
``--blocks``-block forward stack at a ViT shape (L/14: B=256, N=257,
D=1024, 16 heads, bf16) for each of

* ``plain``          — ``ops/vit.reference_block``, the plain PyTorch block;
* ``block:softmax``  — K4 → K5 → K6 a block, the f32-softmax core;
* ``block:exp2``     — the same with the exp2 core (scale·log2 e folded
                       into q, the denominator into the context rows);
* ``stream:exp2``    — K4 → K7 → K6 on one token stream (the served path).

One JSON line per variant: ms a block (CUDA events over ``--iters``
calls after two warm ones) and the CLS rows' max |difference| from the
plain stack.  ``tools/vit_gemm_variants.py`` times the GEMMs alone.
``--device cpu`` runs the twins (a check of the tool, not a measurement).
"""

from __future__ import annotations

import argparse
import json

WIDTHS = {"l14": dict(n=257, d=1024), "b16": dict(n=197, d=768)}


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--blocks", type=int, default=4)
    ap.add_argument("--width", choices=sorted(WIDTHS), default="l14")
    ap.add_argument("--tokens", type=int, default=None,
                    help="override the width's token count")
    ap.add_argument("--dim", type=int, default=None,
                    help="override the width (a multiple of 64)")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    import torch

    from situation_recognition_tpu_torch.device import resolve_device
    from situation_recognition_tpu_torch.ops.vit import reference_cls_stack
    from situation_recognition_tpu_torch.ops.vit_kernel import (
        encoder_block, encoder_cls_stack)
    from situation_recognition_tpu_torch.tools.common import elapsed_ms
    from situation_recognition_tpu_torch.tools.perf_guard import vit_blocks

    device = resolve_device(args.device)
    n = args.tokens or WIDTHS[args.width]["n"]
    d = args.dim or WIDTHS[args.width]["d"]
    heads = d // 64
    bw = vit_blocks(device, d, args.blocks)
    x = (torch.randn((args.batch, n, d), generator=torch.Generator()
                     .manual_seed(1)) * 0.1).to(device, torch.bfloat16)

    def per_block(folded):
        def run():
            h = x
            for w in bw:
                h = encoder_block(h, w, heads, 1e-6, False, folded)
            return h[:, 0]
        return run

    variants = {
        "plain": lambda: reference_cls_stack(x, bw, heads, 1e-6, False),
        "block:softmax": per_block(False),
        "block:exp2": per_block(True),
        "stream:exp2": lambda: encoder_cls_stack(x, bw, heads, 1e-6, False,
                                                 True),
    }
    rows = []
    with torch.no_grad():
        want = variants["plain"]().float()
        for name, fn in variants.items():
            got = fn().float()
            fn()
            ms = elapsed_ms(fn, args.iters, device) / args.iters
            row = {"variant": name,
                   "ms_per_block": round(ms / args.blocks, 4),
                   "max_abs_diff_vs_plain": (got - want).abs().max().item(),
                   "shape": f"B={args.batch} N={n} D={d} heads={heads} "
                            f"blocks={args.blocks}",
                   "device": (torch.cuda.get_device_name(device)
                              if device.type == "cuda" else "cpu")}
            print(json.dumps(row), flush=True)
            rows.append(row)
    return rows


if __name__ == "__main__":
    main()
