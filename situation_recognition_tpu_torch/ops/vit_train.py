"""The ViT encoder under autograd: the fine-tuning (ft) stream.

Port of the differentiable half of
``situation_recognition_tpu/ops/vit_pallas.py`` (``_make_diff_attn``,
``_ft_block``, ``_ft_cls_stack``), as ``ops/ggnn_train.py`` is of the GGNN's
backward route.  Only the attention core has a hand-written backward: it is
the one operation whose autograd would keep (B, h, N, N) probabilities in
device memory.  Everything else of a block (the LayerNorms, the q/k/v and
out projections, the MLP) is plain torch on the flattened (B·N, D) stream,
where autograd emits ordinary products, as XLA's AD does in JAX.

* ``DiffAttention`` — the attention core as a ``torch.autograd.Function``:
  the forward is K7 (``vit_kernel.vit_attention_stream_forward``) and saves
  q, k, v and the context; the backward is K8
  (``vit_kernel.vit_attention_backward``).  On CPU tensors the two wrappers
  run their twins, so the route is testable without a card;
* ``ft_block`` — one encoder block on the stream (``_ft_block``);
* ``ft_cls_stack`` — the stack, returning the CLS rows before the final
  LayerNorm; ``remat`` checkpoints each block (``torch.utils.checkpoint``,
  non-reentrant), so that only the block inputs are kept for the backward
  and each block's forward, K7 included, runs again inside it.

The weights are the module's f32 parameters (``EncoderLayer.weights()``),
cast to the stream's type at use, so that every weight gets its gradient.
The stream is not padded (row stride N), as in ``vit_kernel``.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from situation_recognition_tpu_torch.ops import vit_kernel
from situation_recognition_tpu_torch.ops.vit import BlockWeights, gelu, ln_f32


class DiffAttention(torch.autograd.Function):
    """q, k, v (B·row_stride, D) bf16 → the attention core's context, with
    the flash-style backward K8 (``_make_diff_attn``).  The cotangent
    reaches K8 in q's type, as in JAX (``do.astype(q.dtype)``)."""

    @staticmethod
    def forward(ctx, q, k, v, heads: int, folded: bool, row_stride: int,
                n_valid: int):
        o = vit_kernel.vit_attention_stream_forward(q, k, v, heads, folded,
                                                    row_stride, n_valid)
        ctx.save_for_backward(q, k, v, o)
        ctx.layout = (heads, row_stride, n_valid)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o = ctx.saved_tensors
        dq, dk, dv = vit_kernel.vit_attention_backward(
            q, k, v, o, do.to(q.dtype).contiguous(), *ctx.layout)
        return dq, dk, dv, None, None, None, None


def ft_block(x2: torch.Tensor, w: BlockWeights, heads: int, eps: float,
             quick: bool, folded: bool, n: int) -> torch.Tensor:
    """One encoder block on the (B·n, D) stream of n-token examples, in
    its type: f32 LayerNorms, projections in the stream's type, the
    attention core through ``DiffAttention``, GELU — ``reference_block``'s
    math with the per-head reshapes inside the core."""
    dt = x2.dtype
    d = x2.shape[1]
    y = ln_f32(x2, w.ln1_w, w.ln1_b, eps).to(dt)
    in_w, in_b = w.in_w.to(dt), w.in_b.to(dt)
    q, k, v = (y @ in_w[i * d:(i + 1) * d].t() + in_b[i * d:(i + 1) * d]
               for i in range(3))
    ctx = DiffAttention.apply(q, k, v, heads, folded, n, n)
    x2 = x2 + ctx @ w.out_w.to(dt).t() + w.out_b.to(dt)
    y = ln_f32(x2, w.ln2_w, w.ln2_b, eps).to(dt)
    h = gelu(y @ w.fc1_w.to(dt).t() + w.fc1_b.to(dt), quick)
    return x2 + h @ w.fc2_w.to(dt).t() + w.fc2_b.to(dt)


def ft_cls_stack(x: torch.Tensor, blocks, heads: int, eps: float,
                 quick: bool, folded: bool, remat: bool) -> torch.Tensor:
    """Every block of ``blocks`` (``BlockWeights`` of f32 parameters) on
    the differentiable stream: x (B, N, D) → the CLS rows (B, D) before
    the final LayerNorm.  ``remat`` checkpoints each block."""
    b, n, d = x.shape
    x2 = x.reshape(b * n, d)
    for w in blocks:
        args = (x2, w, heads, eps, quick, folded, n)
        x2 = checkpoint(ft_block, *args, use_reentrant=False) if remat \
            else ft_block(*args)
    return x2.reshape(b, n, d)[:, 0, :]
