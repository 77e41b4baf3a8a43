"""The differentiated folded GGNN propagate: K2 forward, K3 backward.

Port of ``ggnn_propagate_pallas``'s custom VJP in
``situation_recognition_tpu/ops/ggnn_pallas.py`` (``_fwd``/``_bwd``,
``_pallas_bwd``, ``resolve_ggnn_bwd``).  Differentiated propagates go one
of two ways, chosen by ``SRTPU_GGNN_BWD`` exactly as in the JAX package:

* ``xla`` (the default, also for any other value): autograd over the
  masked-sum math of ``ops/ggnn.py``;
* ``pallas``: ``FoldedPropagate``, a ``torch.autograd.Function`` whose
  forward is K2 (``folded_rows_res``: K1 plus the per-step residuals) and
  whose backward is K3 (``folded_bwd_rows``: dh and the gate
  pre-activation cotangents ``da``), followed by the parameter gradients.

The parameter gradients are three stacked products over the steps' rows,
in f32 from bf16 operands (exact products, f32 sums, as the JAX einsums'
``preferred_element_type=f32``):

    dWa = AGGᵀ DA      dUzr = Hᵀ DA[:, :2d]      dUh = RHᵀ DA[:, 2d:]
    dba = Σ DA

with ``AGG`` recomputed from the h residuals by the masked-sum identity
and ``RH = bf16(bf16(r) h)`` from the stored bf16 r.  They are pulled back
to the 14 GGNN parameters through an f32 ``fold_gate_weights`` by
``torch.autograd.grad``.  The mask is a structural table: it gets no
gradient.

On the card the products run on the tensor cores from the bf16 operands
with f32 accumulation and output (``param_products``); on the CPU as f32
products of f32 copies (``param_products_f32``).  Like the JAX package's
einsums they are library products outside the kernels.
"""

from __future__ import annotations

import os

import torch

from situation_recognition_tpu_torch.ops.ggnn import GGNNParams
from situation_recognition_tpu_torch.ops.ggnn_kernel import (
    fold_gate_weights, folded_bwd_rows, folded_rows_res)


def resolve_ggnn_bwd() -> str:
    """Backward route of differentiated kernel-impl propagates:
    ``SRTPU_GGNN_BWD=xla|pallas``; anything else means the default,
    'xla' (autograd over the masked-sum math)."""
    v = os.environ.get("SRTPU_GGNN_BWD", "auto")
    if v in ("xla", "pallas"):
        return v
    return "xla"


def param_products_f32(agg, h, rh, da):
    """``(dWa, dUzr, dUh)`` as f32 products of f32 copies of the bf16
    operands agg, h, rh (K, d) and da (K, 3d): the plain version."""
    f32 = torch.float32
    agg, h, rh, da = (x.to(f32) for x in (agg, h, rh, da))
    d = h.shape[1]
    return agg.t() @ da, h.t() @ da[:, :2 * d], rh.t() @ da[:, 2 * d:]


def param_products(agg, h, rh, da):
    """``(dWa, dUzr, dUh)`` f32 from the bf16 operands agg, h, rh (K, d)
    and da (K, 3d).  On the card one library product each, bf16 operands
    with f32 accumulation and output (``torch.mm(..., out_dtype=f32)``):
    no f32 copies, no TF32 switch.  They differ from
    ``param_products_f32`` in the order of the f32 sums only.  CPU tensors
    take ``param_products_f32``."""
    if not da.is_cuda:
        return param_products_f32(agg, h, rh, da)
    f32 = torch.float32
    d = h.shape[1]
    return (torch.mm(agg.t(), da, out_dtype=f32),
            torch.mm(h.t(), da[:, :2 * d], out_dtype=f32),
            torch.mm(rh.t(), da[:, 2 * d:], out_dtype=f32))


def param_operands(mask_rows: torch.Tensor, resids, da: torch.Tensor,
                   r: int):
    """The bf16 operands of the stacked products from K2's residuals and
    K3's ``da`` (steps, M, 3d): AGG recomputed by the masked-sum identity,
    H, RH = bf16(bf16(r) h) and DA, each with steps·M rows."""
    hs, _, rs, _ = resids
    steps, m, d = hs.shape
    f32, bf = torch.float32, torch.bfloat16
    hv = hs.reshape(steps, m // r, r, d).to(f32)
    mk = mask_rows.to(f32).reshape(1, m // r, r, 1)
    s = torch.sum(hv * mk, dim=2, keepdim=True)
    k = steps * m
    agg = torch.where(mk > 0, s - hv, hv).to(bf).reshape(k, d)
    rh = (rs.to(f32) * hv.reshape(rs.shape)).to(bf).reshape(k, d)
    return agg, hs.reshape(k, d), rh, da.reshape(k, 3 * d)


def param_grads(params: GGNNParams, mask_rows: torch.Tensor, resids,
                da: torch.Tensor, r: int):
    """Cotangents of the 14 GGNN parameters from K2's residuals and K3's
    ``da`` (steps, M, 3d): the stacked products, then the pull-back
    through an f32 fold.  Returns a ``GGNNParams`` of f32 gradients."""
    f32 = torch.float32
    agg, h, rh, da = param_operands(mask_rows, resids, da, r)
    dwa, duzr, duh = param_products(agg, h, rh, da)
    dba = da.sum(dim=0, dtype=f32)[None, :]
    with torch.enable_grad():
        p32 = [p.detach().to(f32).requires_grad_() for p in params]
        folded = fold_gate_weights(GGNNParams(*p32), float(r), dtype=f32)
        grads = torch.autograd.grad(folded, p32, (dwa, duzr, duh, dba))
    return GGNNParams(*grads)


class FoldedPropagate(torch.autograd.Function):
    """hidden (B, R, D), mask (B, R) → (B, R, D) in hidden's dtype, bf16
    inside; forward K2, backward K3 + ``param_grads``.  ``weights`` is
    ``fold_gate_weights(params, R)`` of the same ``params`` (a module may
    keep it folded already); gradients flow to ``hidden`` and to the 14
    ``params`` tensors."""

    @staticmethod
    def forward(ctx, hidden, mask, num_steps, weights, *params):
        b, r, d = hidden.shape
        h = hidden.reshape(b * r, d).to(torch.bfloat16).contiguous()
        mask_rows = mask.reshape(b * r).to(torch.float32).contiguous()
        out, resids = folded_rows_res(h, mask_rows, weights, r, num_steps)
        ctx.save_for_backward(mask_rows, *resids, *params)
        ctx.weights = weights
        ctx.shape = (b, r, d)
        return out.reshape(b, r, d).to(hidden.dtype)

    @staticmethod
    def backward(ctx, g):
        mask_rows, *rest = ctx.saved_tensors
        resids, params = tuple(rest[:4]), rest[4:]
        b, r, d = ctx.shape
        steps = resids[0].shape[0]
        g_rows = g.reshape(b * r, d).to(torch.bfloat16).contiguous()
        dh, da = folded_bwd_rows(g_rows, mask_rows, resids, ctx.weights, r,
                                 steps)
        dparams = param_grads(GGNNParams(*params), mask_rows, resids, da, r)
        return (dh.reshape(b, r, d).to(g.dtype), None, None, None,
                *(dp.to(p.dtype) for dp, p in zip(dparams, params)))


def ggnn_propagate_train(params: GGNNParams, hidden: torch.Tensor,
                         mask: torch.Tensor, num_steps: int = 4,
                         weights=None) -> torch.Tensor:
    """Differentiable drop-in for ``ops.ggnn.ggnn_propagate`` through K2
    and K3.  ``weights``: ``fold_gate_weights(params, R)``, when the
    caller keeps them folded already."""
    if weights is None:
        with torch.no_grad():
            weights = fold_gate_weights(params, float(hidden.shape[1]))
    return FoldedPropagate.apply(hidden, mask, num_steps, weights, *params)
