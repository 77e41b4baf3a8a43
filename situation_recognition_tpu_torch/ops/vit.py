"""The ViT encoder block's math in plain PyTorch: the twins of the CUDA
kernels and the module math they are held against.

Port of the arithmetic of ``situation_recognition_tpu/ops/vit_pallas.py``:

* ``ln_f32``, ``gelu`` — the kernels' LayerNorm (f32, biased variance,
  ``rsqrt(var + eps)``) and GELU (exact erf, or CLIP's QuickGELU);
* ``qkv_reference``       — twin of K4 ``_qkv_kernel``;
* ``attn_core_reference`` — twin of K5 ``_attn_core_kernel`` and K7
  ``_attn_core_stream_kernel`` (``row_stride``/``n_valid`` select which);
* ``out_mlp_reference``   — twin of K6 ``_out_mlp_kernel``;
* ``attn_bwd_reference``  — twin of K8 ``_attn_bwd_stream_kernel``, the
  attention core's backward on the fine-tuning path;
* ``reference_block``, ``reference_cls_stack`` — the encoder block and the
  stack in the module's compute type (``_reference_block``,
  ``_reference_cls_stack``): the plain path of ``models/vit.py`` and the
  oracle of the tests.

The twins repeat each kernel's roundings: bf16 operands multiplied in f32
(exact) and summed in f32, biases, LayerNorm and softmax in f32, and a cast
to the stream type at the end.  ``ops/vit_kernel.py`` runs them for CPU
tensors; ``chip_smoke.py`` holds the CUDA kernels against them on the card.

Weights are in torch's ``nn.Linear`` layout, (out, in), as the ViT's state
dict keeps them (``BlockWeights``): the q/k/v projections packed into one
(3D, D) matrix as torchvision's ``in_proj_weight``.
"""

from __future__ import annotations

import math
import os
from typing import NamedTuple

import torch

LOG2E = math.log2(math.e)


class BlockWeights(NamedTuple):
    """One encoder block's parameters in torchvision's layout: LayerNorm
    scales and shifts (D,), ``in_w`` (3D, D) = [Wq; Wk; Wv] rows with
    ``in_b`` (3D,), ``out_w`` (D, D), ``fc1_w`` (H, D), ``fc2_w`` (D, H)
    and their biases."""

    ln1_w: torch.Tensor
    ln1_b: torch.Tensor
    in_w: torch.Tensor
    in_b: torch.Tensor
    out_w: torch.Tensor
    out_b: torch.Tensor
    ln2_w: torch.Tensor
    ln2_b: torch.Tensor
    fc1_w: torch.Tensor
    fc1_b: torch.Tensor
    fc2_w: torch.Tensor
    fc2_b: torch.Tensor


def attn_core_variant() -> str:
    """The attention core's softmax: ``exp2`` (default; scale·log2(e)
    folded into q, the denominator divided into the context rows) or
    ``softmax`` (f32 softmax of the scaled scores), from
    ``SRTPU_ATTN_CORE`` as in the JAX package."""
    v = os.environ.get("SRTPU_ATTN_CORE", "exp2")
    if v not in ("softmax", "exp2"):
        raise ValueError(f"SRTPU_ATTN_CORE must be softmax|exp2, got {v!r}")
    return v


def ln_f32(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
           eps: float) -> torch.Tensor:
    """LayerNorm over the last axis in f32: biased variance of the centred
    values, ``rsqrt(var + eps)``, then scale and shift."""
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    xc = x - mu
    var = (xc * xc).mean(dim=-1, keepdim=True)
    return xc * torch.rsqrt(var + eps) * g.float() + b.float()


def gelu(h: torch.Tensor, quick: bool) -> torch.Tensor:
    """Exact (erf) GELU, or CLIP's QuickGELU ``h·sigmoid(1.702 h)``, in
    h's type."""
    if quick:
        return h * torch.sigmoid(1.702 * h)
    return 0.5 * h * (1.0 + torch.erf(h * 2.0 ** -0.5))


def _mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """bf16 a (M, K) @ bf16 wᵀ (w (N, K)) with f32 products and sums."""
    return a.float() @ w.float().t()


def qkv_reference(x: torch.Tensor, w: BlockWeights, eps: float):
    """Twin of K4: x (M, D) stream → (q, k, v), each (M, D) in x's type.
    LN1 in f32 cast to bf16, the bf16 product with f32 sums, the f32 bias,
    then the cast to the stream type."""
    y = ln_f32(x, w.ln1_w, w.ln1_b, eps).to(torch.bfloat16)
    o = _mm(y, w.in_w.to(torch.bfloat16)) + w.in_b.float()
    return tuple(t.to(x.dtype) for t in o.chunk(3, dim=1))


def _heads(t: torch.Tensor, heads: int, row_stride: int,
           n_valid: int) -> torch.Tensor:
    """The real rows of a (B·row_stride, D) stream by head: (B, h,
    n_valid, D/h)."""
    m, d = t.shape
    if m % row_stride or not 1 <= n_valid <= row_stride or d % heads:
        raise ValueError(f"bad attention shape: rows {m}, row_stride "
                         f"{row_stride}, n_valid {n_valid}, d {d}, heads "
                         f"{heads}")
    return t.reshape(m // row_stride, row_stride, heads, d // heads)[
        :, :n_valid].permute(0, 2, 1, 3)


def _from_heads(t: torch.Tensor, like: torch.Tensor,
            row_stride: int) -> torch.Tensor:
    """(B, h, n, dh) by head → (B·row_stride, h·dh) rows in ``like``'s
    type, the pad rows zero."""
    b, h, n, dh = t.shape
    out = like.new_zeros((b, row_stride, h * dh))
    out[:, :n] = t.permute(0, 2, 1, 3).reshape(b, n, h * dh).to(like.dtype)
    return out.reshape(b * row_stride, h * dh)


def attn_core_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        heads: int, scale: float, folded: bool,
                        row_stride: int, n_valid: int) -> torch.Tensor:
    """Twin of K5 (``row_stride == n_valid == N``) and K7 (the stream: each
    example ``row_stride`` rows, the first ``n_valid`` real).  q, k, v
    (B·row_stride, D) → context (B·row_stride, D) in q's type; the pad rows
    of each example are never read and are written as zeros.

    ``folded``: q·(scale·log2 e) in f32 cast to bf16 before QKᵀ, the
    exponent ``exp2(s − max)`` cast to bf16, its denominator summed in f32
    from the bf16 values and divided into the context after e·V.  Else the
    f32 softmax of ``s·scale``, cast to bf16 before P·V."""
    qh, kh, vh = (_heads(t, heads, row_stride, n_valid) for t in (q, k, v))
    if folded:
        qh = (qh.float() * (scale * LOG2E)).to(torch.bfloat16)
    s = qh.float() @ kh.float().transpose(-1, -2)
    if folded:
        e = torch.exp2(s - s.amax(dim=-1, keepdim=True)).to(torch.bfloat16)
        den = e.float().sum(dim=-1, keepdim=True)
        ctx = (e.float() @ vh.float()) * (1.0 / den)
    else:
        p = torch.softmax(s * scale, dim=-1).to(torch.bfloat16)
        ctx = p.float() @ vh.float()
    return _from_heads(ctx, q, row_stride)


def attn_bwd_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       o: torch.Tensor, do: torch.Tensor, heads: int,
                       scale: float, row_stride: int, n_valid: int):
    """Twin of K8 ``_attn_bwd_stream_kernel``: the attention core's
    gradients.  q, k, v, the forward's context o and its cotangent do, all
    (B·row_stride, D) bf16 with ``n_valid`` real rows per example → (dq,
    dk, dv) in q's type, the pad rows never read and written as zeros.

    Per example and head, whatever the forward's flavour: the f32 softmax
    recomputed unfolded (s = QKᵀ·scale, e = exp(s − max s), inv = 1/Σe);
    δ = Σ do·o over the head's columns in f32; dv = bf16(e)ᵀ·bf16(do·inv);
    dp = do·vᵀ; ds = bf16(e·(dp − δ)·(inv·scale)); dq = ds·k, dk = dsᵀ·q;
    bf16 operands, f32 sums."""
    bf = torch.bfloat16
    qh, kh, vh, oh, doh = (_heads(t, heads, row_stride, n_valid).float()
                           for t in (q, k, v, o, do))
    s = (qh @ kh.transpose(-1, -2)) * scale
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    inv = 1.0 / e.sum(dim=-1, keepdim=True)
    delta = (doh * oh).sum(dim=-1, keepdim=True)
    dv = e.to(bf).float().transpose(-1, -2) @ (doh * inv).to(bf).float()
    dp = doh @ vh.transpose(-1, -2)
    ds = (e * (dp - delta) * (inv * scale)).to(bf).float()
    dq = ds @ kh
    dk = ds.transpose(-1, -2) @ qh
    return tuple(_from_heads(t, q, row_stride) for t in (dq, dk, dv))


def out_mlp_reference(x: torch.Tensor, ctx: torch.Tensor,
                      w: BlockWeights, eps: float,
                      quick: bool) -> torch.Tensor:
    """Twin of K6: x, ctx (M, D) → (M, D) in x's type.  The residual
    ``(x + ctx·Woᵀ) + bo`` stays f32; LN2 → bf16; ``·W1ᵀ + b1`` and the
    GELU in f32 → bf16; ``(residual + ·W2ᵀ) + b2`` cast to the stream
    type."""
    bf = torch.bfloat16
    xr = (x.float() + _mm(ctx.to(bf), w.out_w.to(bf))) + w.out_b.float()
    y = ln_f32(xr, w.ln2_w, w.ln2_b, eps).to(bf)
    h = gelu(_mm(y, w.fc1_w.to(bf)) + w.fc1_b.float(), quick).to(bf)
    return ((xr + _mm(h, w.fc2_w.to(bf))) + w.fc2_b.float()).to(x.dtype)


def reference_block(x: torch.Tensor, w: BlockWeights, heads: int,
                    eps: float, quick: bool) -> torch.Tensor:
    """One pre-LN encoder block in x's type (B, N, D): f32 LayerNorms,
    projections in the compute type, f32 softmax, GELU in the compute
    type — ``_reference_block``'s composition."""
    dt = x.dtype
    b, n, d = x.shape
    dh = d // heads
    y = ln_f32(x, w.ln1_w, w.ln1_b, eps).to(dt)
    qkv = y @ w.in_w.to(dt).t() + w.in_b.to(dt)
    q, k, v = (t.reshape(b, n, heads, dh) for t in qkv.chunk(3, dim=-1))
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float()
    p = torch.softmax(s * (1.0 / math.sqrt(dh)), dim=-1).to(dt)
    ctx = torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(b, n, d)
    x = x + ctx @ w.out_w.to(dt).t() + w.out_b.to(dt)
    y = ln_f32(x, w.ln2_w, w.ln2_b, eps).to(dt)
    h = gelu(y @ w.fc1_w.to(dt).t() + w.fc1_b.to(dt), quick)
    return x + h @ w.fc2_w.to(dt).t() + w.fc2_b.to(dt)


def reference_cls_stack(x: torch.Tensor, blocks, heads: int, eps: float,
                        quick: bool) -> torch.Tensor:
    """The encoder stack of ``reference_block``s → the CLS rows (B, D)
    before the final LayerNorm."""
    for w in blocks:
        x = reference_block(x, w, heads, eps, quick)
    return x[:, 0, :]
