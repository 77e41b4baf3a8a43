"""Bias + GELU on the port's fine-tuning MLPs: the CUDA pair of
``csrc/gelu.cu``, its plain twins, and the autograd Function that puts the
pair under a differentiated call.

The pair replaces no TPU kernel: the JAX package writes the activation as
jnp ops after the fc1 product (``ops/vit.py`` ``gelu`` is their port),
which XLA fuses on the TPU.  Under autograd on the card that composition is
a bias pass and five bf16 passes forward, eleven backward and the bias
gradient's sum, each over a full (rows, H) tensor in device memory.  The
pair is bound by bytes: the forward reads h (the fc1 product without its
bias) once and writes y once, the backward reads h and dy once and writes
dh once; each thread owns fixed columns of the rows it walks (``plan``),
so the bias stays in its registers and the bias gradient is summed in f32
registers over a persistent grid's rows, then over its blocks in a fixed
order.

* ``bias_gelu_forward`` — ``gelu_rows_fwd_kernel``: h (..., H) bf16, b
  (H,) f32 → y = GELU(h + b) (..., H) bf16, in f32 and rounded once;
* ``bias_gelu_backward`` — ``gelu_rows_bwd_kernel`` then
  ``gelu_rows_dbias_kernel``: the cotangent dy (bf16) → (dh bf16, db (H,)
  f32);
* ``BiasGeluRows`` — the pair as a ``torch.autograd.Function``, saving h
  and b only;
* ``bias_gelu(h, b, quick)`` — what the models call: on a CPU tensor
  ``gelu(h + b.to(h.dtype), quick)`` under plain autograd, so that the CPU
  paths compute what they computed before the pair; on a CUDA tensor
  ``BiasGeluRows`` where autograd records, else the forward kernel alone.
  There is no fallback: a CUDA tensor the kernels do not take raises.
* ``gelu_fwd_reference`` / ``gelu_bwd_reference`` — the twins, repeating
  the kernels' arithmetic in f32 (or in the inputs' type where it is
  wider): x = h + b, y = GELU(x); dh = dy·GELU′(x), db = Σ dh over the
  rows.  GELU is exact, 0.5·x·(1 + erf(x/√2)), or QuickGELU
  x·sigmoid(1.702·x) where ``quick``.

``bias_gelu.launches`` counts forward launches on the card and
``bias_gelu.bwd_launches`` backward ones (a backward is its two kernels),
after the launch returned without an error; the CPU's composition is not
counted.
"""

from __future__ import annotations

import ctypes
import math

import torch

from situation_recognition_tpu_torch.ops import _build
from situation_recognition_tpu_torch.ops.layernorm import plan
from situation_recognition_tpu_torch.ops.vit import gelu

#: csrc/gelu.cu's block size, the most 16-byte loads a thread holds of a
#: row, and the blocks an SM of the forward and the backward (their
#: ``__launch_bounds__``)
THREADS, MAX_VPT, FWD_BLOCKS_PER_SM, BWD_BLOCKS_PER_SM = 256, 3, 3, 2
_QUICK = 1.702

_P, _I = ctypes.c_void_p, ctypes.c_int
#: csrc/gelu.cu's entry points → their parameters' ctypes types
SIGNATURES = {
    "gelu_rows_forward": [_I] + [_P] * 3 + [_I] * 5 + [_P],
    "gelu_rows_backward": [_I] + [_P] * 6 + [_I] * 5 + [_P],
}


# ------------------------------------------------------------- the twins


def _grad(x: torch.Tensor, quick: bool) -> torch.Tensor:
    """dGELU(x)/dx in x's type."""
    if quick:
        s = torch.sigmoid(_QUICK * x)
        return s + _QUICK * x * s * (1 - s)
    return 0.5 * (1 + torch.erf(x * 2.0 ** -0.5)) \
        + x * (2 * math.pi) ** -0.5 * torch.exp(-0.5 * x * x)


def gelu_fwd_reference(h: torch.Tensor, b: torch.Tensor,
                       quick: bool) -> torch.Tensor:
    """Twin of ``gelu_rows_fwd_kernel``: h (..., H), b (H,) → GELU(h + b)
    in h's type, computed in f32 (or h's type where it is wider) and
    rounded once."""
    ct = torch.promote_types(h.dtype, torch.float32)
    with torch.no_grad():
        x = h.to(ct) + b.to(ct)
        y = x * torch.sigmoid(_QUICK * x) if quick \
            else 0.5 * x * (1 + torch.erf(x * 2.0 ** -0.5))
    return y.to(h.dtype)


def gelu_bwd_reference(h: torch.Tensor, b: torch.Tensor, dy: torch.Tensor,
                       quick: bool):
    """Twin of ``gelu_rows_bwd_kernel`` + ``gelu_rows_dbias_kernel``: h,
    dy (..., H), b (H,) → (dh = dy·GELU′(h + b) in h's type, db = Σ dh
    over the rows before the rounding), in f32 (or the inputs' type where
    it is wider)."""
    ct = torch.promote_types(torch.promote_types(h.dtype, dy.dtype),
                             torch.float32)
    d = h.shape[-1]
    with torch.no_grad():
        dh = dy.reshape(-1, d).to(ct) * _grad(h.reshape(-1, d).to(ct)
                                              + b.to(ct), quick)
    return dh.to(h.dtype).reshape(h.shape), dh.sum(dim=0)


# ------------------------------------------------------------- the card


def _check(h: torch.Tensor, b: torch.Tensor, *others) -> tuple:
    """Checks of the operands on the card → (rows, H, threads a row,
    loads a thread); the device last, so that the CPU tests reach the
    others."""
    d = h.shape[-1] if h.dim() else 0
    p = plan(d, MAX_VPT)
    if h.dtype != torch.bfloat16 or p is None or h.numel() == 0 \
            or h.numel() // d >= 2 ** 31:
        raise ValueError(
            f"the bias_gelu kernels take non-empty rows of bf16 whose "
            f"16-byte loads split into at most {MAX_VPT} a thread over a "
            f"power of two of at most {THREADS} threads; got "
            f"{tuple(h.shape)} {h.dtype}")
    if b.dtype != torch.float32 or b.shape != (d,):
        raise ValueError(f"the bias must be ({d},) f32, got "
                         f"{tuple(b.shape)} {b.dtype}")
    for t in others:
        if t.dtype != torch.bfloat16 or t.shape != h.shape:
            raise ValueError(f"dy must be bf16 of h's shape {tuple(h.shape)},"
                             f" got {tuple(t.shape)} {t.dtype}")
    for t in (h, b) + others:
        if t.device != h.device or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError("the bias_gelu kernels take contiguous, 16-byte "
                             "aligned tensors on one card")
    if h.device.type != "cuda":
        raise ValueError(f"no bias_gelu kernel for device {h.device}")
    return h.numel() // d, d, *p


def _blocks(h: torch.Tensor, rows: int, tpr: int, per_sm: int) -> int:
    """The persistent grid: ``per_sm`` blocks an SM, or fewer where the
    rows do not fill them."""
    return max(1, min(-(-rows // (THREADS // tpr)),
                      per_sm * _build.sm_count(h.device)))


def bias_gelu_forward(h: torch.Tensor, b: torch.Tensor,
                      quick: bool) -> torch.Tensor:
    """``gelu_rows_fwd_kernel`` on h's card: h (..., H) contiguous bf16,
    b (H,) f32 → GELU(h + b) (..., H) bf16.  Raises for what the kernel
    does not take, a CPU tensor included."""
    rows, d, tpr, vpt = _check(h, b)
    y = torch.empty_like(h)
    with torch.cuda.device(h.device):
        _build.launch(
            "gelu.cu", "gelu_rows_forward", SIGNATURES, int(quick),
            h.data_ptr(), b.data_ptr(), y.data_ptr(), rows, d, tpr, vpt,
            _blocks(h, rows, tpr, FWD_BLOCKS_PER_SM), _build.stream(h))
    bias_gelu.launches += 1
    return y


def bias_gelu_backward(h: torch.Tensor, b: torch.Tensor, dy: torch.Tensor,
                       quick: bool):
    """``gelu_rows_bwd_kernel`` then ``gelu_rows_dbias_kernel`` on h's
    card: h and its cotangent dy (..., H) bf16, b (H,) f32 → (dh bf16, db
    (H,) f32), db summed in a fixed order (two calls on the same inputs
    are bit-equal)."""
    rows, d, tpr, vpt = _check(h, b, dy)
    blocks = _blocks(h, rows, tpr, BWD_BLOCKS_PER_SM)
    dh = torch.empty_like(h)
    part = torch.empty((blocks, d), dtype=torch.float32, device=h.device)
    db = torch.empty(d, dtype=torch.float32, device=h.device)
    with torch.cuda.device(h.device):
        _build.launch(
            "gelu.cu", "gelu_rows_backward", SIGNATURES, int(quick),
            h.data_ptr(), b.data_ptr(), dy.data_ptr(), dh.data_ptr(),
            part.data_ptr(), db.data_ptr(), rows, d, tpr, vpt, blocks,
            _build.stream(h))
    bias_gelu.bwd_launches += 1
    return dh, db


class BiasGeluRows(torch.autograd.Function):
    """h (..., H) bf16, b (H,) f32 → GELU(h + b) bf16, through the pair."""

    @staticmethod
    def forward(ctx, h, b, quick: bool):
        ctx.save_for_backward(h, b)
        ctx.quick = quick
        return bias_gelu_forward(h, b, quick)

    @staticmethod
    def backward(ctx, dy):
        h, b = ctx.saved_tensors
        dh, db = bias_gelu_backward(h, b, dy.contiguous(), ctx.quick)
        return dh, db, None


def bias_gelu(h: torch.Tensor, b: torch.Tensor, quick: bool) -> torch.Tensor:
    """GELU(h + b) of h (..., H) and the f32 bias b (H,), in h's type
    (exact GELU, or QuickGELU where ``quick``).  CPU tensors: ``gelu(h +
    b.to(h.dtype), quick)`` under plain autograd; CUDA tensors: the pair
    (``BiasGeluRows`` where autograd records, else ``bias_gelu_forward``
    alone), or raises."""
    if h.device.type == "cpu":
        return gelu(h + b.to(h.dtype), quick)
    h = h.contiguous()
    if torch.is_grad_enabled() and (h.requires_grad or b.requires_grad):
        return BiasGeluRows.apply(h, b, quick)
    return bias_gelu_forward(h, b, quick)


bias_gelu.launches = 0
bias_gelu.bwd_launches = 0
