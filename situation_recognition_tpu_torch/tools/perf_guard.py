"""Kernel A/B bands on the card as ONE JSON line:

    python -m situation_recognition_tpu_torch.tools.perf_guard

The counterpart of the JAX package's ``tools/perf_guard.py``, at its
shapes: K1 (the folded GGNN forward, ``ops/ggnn_kernel.py``) against the
masked GGNN at B=1536, R=6, d=2048, 4 steps, bf16; and the ViT stream
stack (K4 → K7 → K6 on one token stream) against the per-block path (K4 →
K5 → K6 a block) at ViT-L/14, batch 256, 257 tokens, 4 blocks.  Each
candidate runs chained, ``x = f(x)``, and its time is the slope of CUDA
event times over two repetition counts (``common.slope_ms``), so that the
launch queue's fill and the sync cancel.  Prints

    {"ggnn_kernel_ms", "ggnn_masked_ms", "ggnn_ratio",
     "vit_stream_ms", "vit_block_ms", "vit_ratio", "device"}

A ratio above 1 means the kernel path wins.  ``PERF_GUARD_ITERS`` (5)
pairs of counts; ``PERF_GUARD_SKIP_VIT=1`` skips the ViT pair.  The shape
flags cut the sizes (``--device cpu`` runs the plain twins on the CPU:
a check of the tool, not a measurement).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def ggnn_ab(device, batch: int, roles: int, d: int, pairs: int) -> dict:
    """K1 against the masked propagate on the same bf16 weights and
    hidden states (the chain feeds each output back as the next input:
    the gated update keeps it bounded)."""
    import torch

    from situation_recognition_tpu_torch.ops.ggnn import (
        GGNNParams, ggnn_propagate)
    from situation_recognition_tpu_torch.ops.ggnn_kernel import (
        fold_gate_weights, ggnn_propagate_folded)
    from situation_recognition_tpu_torch.tools.common import slope_ms

    g = torch.Generator().manual_seed(0)
    bound = d ** -0.5
    params = GGNNParams(*(
        ((torch.rand((d, d) if i % 2 == 0 else (d,), generator=g) * 2 - 1)
         * bound).to(device, torch.bfloat16) for i in range(14)))
    rng = np.random.default_rng(0)
    hidden = torch.from_numpy(rng.standard_normal((batch, roles, d)) * 0.1) \
        .to(device, torch.bfloat16)
    mask = torch.from_numpy(rng.random((batch, roles)) < 0.8) \
        .to(device, torch.float32)
    weights = fold_gate_weights(params, float(roles))
    with torch.no_grad():
        k_ms = slope_ms(lambda h: ggnn_propagate_folded(
            None, h, mask, 4, weights=weights), hidden, device, pairs)
        m_ms = slope_ms(lambda h: ggnn_propagate(params, h, mask, 4),
                        hidden, device, pairs)
    return {"ggnn_kernel_ms": round(k_ms, 4), "ggnn_masked_ms": round(m_ms, 4),
            "ggnn_ratio": round(m_ms / k_ms, 3),
            "ggnn_shape": f"B={batch} R={roles} d={d} steps=4"}


def vit_blocks(device, d: int, blocks: int, seed: int = 0) -> list:
    """``blocks`` random encoder blocks of width ``d`` (MLP 4d) as the
    kernels take them (``vit_kernel.kernel_weights``)."""
    import torch

    from situation_recognition_tpu_torch.ops.vit import BlockWeights
    from situation_recognition_tpu_torch.ops.vit_kernel import (
        kernel_weights)

    g = torch.Generator().manual_seed(seed)

    def w(*shape, scale=0.02, one=0.0):
        return one + torch.randn(shape, generator=g) * scale

    out = []
    for _ in range(blocks):
        bw = BlockWeights(w(d, one=1.0), w(d), w(3 * d, d), w(3 * d),
                          w(d, d), w(d), w(d, one=1.0), w(d), w(4 * d, d),
                          w(4 * d), w(d, 4 * d), w(d))
        out.append(kernel_weights(BlockWeights(*(t.to(device) for t in bw))))
    return out


def vit_ab(device, batch: int, tokens: int, d: int, blocks: int,
           pairs: int) -> dict:
    """The stream stack against the per-block kernels.  Neither maps
    tokens to tokens (both end at the CLS rows), so the chain adds 1e-30
    × the CLS rows back, which bf16 rounds away while the data dependency
    keeps the calls in order."""
    import torch

    from situation_recognition_tpu_torch.ops.vit_kernel import (
        encoder_block, encoder_cls_stack)
    from situation_recognition_tpu_torch.tools.common import slope_ms

    heads = d // 64
    bw = vit_blocks(device, d, blocks)
    x = (torch.randn((batch, tokens, d), generator=torch.Generator()
                     .manual_seed(1)) * 0.1).to(device, torch.bfloat16)

    def feed(c, cls):
        return c + (cls * 1e-30).to(c.dtype)[:, None, :]

    def stream(c):
        return feed(c, encoder_cls_stack(c, bw, heads, 1e-6, False, True))

    def per_block(c):
        h = c
        for w in bw:
            h = encoder_block(h, w, heads, 1e-6, False, True)
        return feed(c, h[:, 0])

    with torch.no_grad():
        s_ms = slope_ms(stream, x, device, pairs)
        b_ms = slope_ms(per_block, x, device, pairs)
    return {"vit_stream_ms": round(s_ms, 4), "vit_block_ms": round(b_ms, 4),
            "vit_ratio": round(b_ms / s_ms, 3),
            "vit_shape": f"B={batch} N={tokens} D={d} blocks={blocks}"}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--batch", type=int, default=1536)
    ap.add_argument("--roles", type=int, default=6)
    ap.add_argument("--hidden", type=int, default=2048)
    ap.add_argument("--vit-batch", type=int, default=256)
    ap.add_argument("--vit-tokens", type=int, default=257)
    ap.add_argument("--vit-width", type=int, default=1024)
    ap.add_argument("--vit-blocks", type=int, default=4)
    args = ap.parse_args(argv)

    import torch

    from situation_recognition_tpu_torch.device import resolve_device

    device = resolve_device(args.device)
    pairs = int(os.environ.get("PERF_GUARD_ITERS", "5"))
    out = ggnn_ab(device, args.batch, args.roles, args.hidden, pairs)
    if os.environ.get("PERF_GUARD_SKIP_VIT") != "1":
        out.update(vit_ab(device, args.vit_batch, args.vit_tokens,
                          args.vit_width, args.vit_blocks, pairs))
    out["device"] = (torch.cuda.get_device_name(device)
                     if device.type == "cuda" else "cpu")
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
