"""LayerNorm over the last axis on the port's fine-tuning paths: the CUDA
pair of ``csrc/layernorm.cu``, its plain twins, and the autograd Function
that puts the pair under a differentiated call.

The pair replaces no TPU kernel: the JAX package writes the LayerNorm as
f32 jnp ops (``ops/vit.py`` ``ln_f32`` is their port), which XLA fuses
into one pass on the TPU.  Under autograd on the card that composition is
a cast, nine f32 passes forward and 21 backward, each over a full f32
(rows, D) tensor in device memory.  The pair is bound by bytes: the
forward reads each row of x once and writes y once (with one f32 mean and
rstd a row), the backward reads x and dy once and writes dx once, each
row held in registers through its reductions (a row's 16-byte loads
spread over ``plan``'s threads), the parameters' gradients summed in f32
registers over a persistent grid's rows and then over its blocks in a
fixed order.

* ``ln_forward`` — ``ln_rows_fwd_kernel``: x (..., D) bf16, gamma and
  beta (D,) f32 → (y (..., D) in ``out_dtype``, bf16 or f32, mean (rows,)
  f32, rstd (rows,) f32), rstd = rsqrt(biased variance + eps);
* ``ln_backward`` — ``ln_rows_bwd_kernel`` then ``ln_rows_dparam_kernel``:
  the cotangent dy in y's type → (dx bf16, dgamma (D,) f32, dbeta (D,)
  f32);
* ``LayerNormRows`` — the pair as a ``torch.autograd.Function``, saving
  x, mean and rstd (no f32 copy of the rows);
* ``layer_norm(x, g, b, eps, out_dtype)`` — what the models call: on a CPU
  tensor ``ln_f32(x, g, b, eps).to(out_dtype)`` under plain autograd, so
  that the CPU paths compute exactly what they computed before the pair;
  on a CUDA tensor ``LayerNormRows`` where autograd records, else the
  forward kernel alone.  There is no fallback: a CUDA tensor the kernels
  do not take raises.
* ``ln_fwd_reference`` / ``ln_bwd_reference`` — the twins, repeating the
  kernels' arithmetic in f32 (or in the inputs' type where it is wider):
  the mean, then the centred variance, y = (x − μ)·rstd·γ + β; dx =
  rstd·(γ·dy − mean(γ·dy) − x̂·mean(γ·dy·x̂)), dγ = Σ dy·x̂, dβ = Σ dy.

``layer_norm.launches`` counts forward launches on the card and
``layer_norm.bwd_launches`` backward ones (a backward is its two
kernels), after the launch returned without an error; the CPU's
composition is not counted.
"""

from __future__ import annotations

import ctypes

import torch

from situation_recognition_tpu_torch.ops import _build
from situation_recognition_tpu_torch.ops.vit import ln_f32

#: csrc/layernorm.cu's block size, the most 16-byte loads a thread holds
#: of a row forward and backward (which also holds dy and the partial
#: sums: at 4 loads of bf16 it spills), and the backward's blocks an SM
#: (its ``__launch_bounds__``)
THREADS, MAX_VPT, MAX_VPT_BWD, BWD_BLOCKS_PER_SM = 256, 4, 3, 2
#: the types of y (and of dy) the kernels take; x is bf16
_OUT_DTYPES = (torch.bfloat16, torch.float32)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: csrc/layernorm.cu's entry points → their parameters' ctypes types
SIGNATURES = {
    "ln_rows_forward": [_I] + [_P] * 6 + [_I] * 4 + [_F, _P],
    "ln_rows_backward": [_I] + [_P] * 8 + [_I] * 5 + [_P],
}


def plan(d: int, most: int = MAX_VPT):
    """(threads a row, 16-byte loads a thread) for bf16 rows of ``d``
    values, or None where the kernel takes no such row: the fewest
    threads, a power of two up to ``THREADS``, that split the row's loads
    of 8 values evenly, at most ``most`` each (``MAX_VPT`` forward,
    ``MAX_VPT_BWD`` backward).  D = 192, 384, 768 take 8, 16, 32 threads
    of 3 loads; 1024 one warp of 4 forward, two warps of 2 backward; 1536
    and 3072 two and four warps of 3."""
    if d < 8 or d % 8:
        return None
    loads, tpr = d // 8, 1
    while tpr <= THREADS:
        if loads % tpr == 0 and loads // tpr <= most:
            return tpr, loads // tpr
        tpr *= 2
    return None


# ------------------------------------------------------------- the twins


def ln_fwd_reference(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
                     eps: float, out_dtype=None):
    """Twin of ``ln_rows_fwd_kernel``: x (..., D) → (y (..., D) in
    ``out_dtype`` (x's type if None), mean (rows,), rstd (rows,)), in f32
    (or x's type where it is wider): the mean, the biased variance of the
    centred values, rstd = rsqrt(var + eps), y = (x − μ)·rstd·γ + β
    rounded once."""
    ct = torch.promote_types(x.dtype, torch.float32)
    d = x.shape[-1]
    with torch.no_grad():
        xf = x.reshape(-1, d).to(ct)
        mu = xf.mean(dim=1, keepdim=True)
        xc = xf - mu
        rstd = torch.rsqrt((xc * xc).mean(dim=1, keepdim=True) + eps)
        y = xc * rstd * g.to(ct) + b.to(ct)
    return (y.to(out_dtype or x.dtype).reshape(x.shape), mu.reshape(-1),
            rstd.reshape(-1))


def ln_bwd_reference(x: torch.Tensor, dy: torch.Tensor, g: torch.Tensor,
                     mean: torch.Tensor, rstd: torch.Tensor):
    """Twin of ``ln_rows_bwd_kernel`` + ``ln_rows_dparam_kernel``: x, dy
    (..., D), γ (D,), the forward's mean and rstd (rows,) → (dx in x's
    type, dγ, dβ), in f32 (or the inputs' type where it is wider):
    x̂ = (x − μ)·rstd, dx = rstd·(γ·dy − mean(γ·dy) − x̂·mean(γ·dy·x̂)),
    dγ = Σ dy·x̂ and dβ = Σ dy over the rows."""
    ct = torch.promote_types(torch.promote_types(x.dtype, dy.dtype),
                             torch.float32)
    d = x.shape[-1]
    with torch.no_grad():
        xf, dyf = x.reshape(-1, d).to(ct), dy.reshape(-1, d).to(ct)
        r = rstd.to(ct)[:, None]
        xh = (xf - mean.to(ct)[:, None]) * r
        gd = g.to(ct) * dyf
        a = gd.mean(dim=1, keepdim=True)
        c = (gd * xh).mean(dim=1, keepdim=True)
        dx = r * (gd - a - xh * c)
        dg, db = (dyf * xh).sum(dim=0), dyf.sum(dim=0)
    return dx.to(x.dtype).reshape(x.shape), dg, db


# ------------------------------------------------------------- the card


def _aligned(x: torch.Tensor, *others) -> None:
    for t in (x,) + others:
        if t.device != x.device or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError("the layernorm kernels take contiguous, 16-byte "
                             "aligned tensors on one card")


def _check(x: torch.Tensor, other_dtype: torch.dtype, most: int,
           *params) -> tuple:
    """Checks of the operands of the kernel that holds at most ``most``
    loads a thread on the card → (rows, D, threads a row, loads a
    thread)."""
    if x.device.type != "cuda":
        raise ValueError(f"no layernorm kernel for device {x.device}")
    d = x.shape[-1] if x.dim() else 0
    p = plan(d, most)
    if x.dtype != torch.bfloat16 or other_dtype not in _OUT_DTYPES \
            or p is None or x.numel() == 0 or x.numel() // d >= 2 ** 31:
        raise ValueError(
            f"the layernorm kernels take non-empty rows of bf16 whose "
            f"16-byte loads split into at most {most} a thread over a "
            f"power of two of at most {THREADS} threads, with an output "
            f"(or gradient) of bf16 or f32; got {tuple(x.shape)} {x.dtype} "
            f"→ {other_dtype}")
    _aligned(x, *params)
    for t in params:
        if t.dtype != torch.float32 or t.shape != (d,):
            raise ValueError(f"gamma and beta must be ({d},) f32, got "
                             f"{tuple(t.shape)} {t.dtype}")
    return x.numel() // d, d, *p


def ln_forward(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
               eps: float, out_dtype=None):
    """``ln_rows_fwd_kernel`` on x's card: x (..., D) contiguous bf16, γ
    and β (D,) f32 → (y (..., D) in ``out_dtype`` (bf16 if None, or f32),
    mean (rows,) f32, rstd (rows,) f32).  Raises for what the
    kernel does not take, a CPU tensor included."""
    out_dtype = out_dtype or x.dtype
    rows, d, tpr, vpt = _check(x, out_dtype, MAX_VPT, g, b)
    y = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    mean, rstd = (torch.empty(rows, dtype=torch.float32, device=x.device)
                  for _ in range(2))
    with torch.cuda.device(x.device):
        _build.launch(
            "layernorm.cu", "ln_rows_forward", SIGNATURES,
            int(out_dtype == torch.float32), x.data_ptr(), g.data_ptr(),
            b.data_ptr(), y.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
            rows, d, tpr, vpt, float(eps), _build.stream(x))
    layer_norm.launches += 1
    return y, mean, rstd


def _blocks(x: torch.Tensor, rows: int, tpr: int) -> int:
    """The backward's persistent grid: ``BWD_BLOCKS_PER_SM`` blocks an SM,
    or fewer where the rows do not fill them."""
    return max(1, min(-(-rows // (THREADS // tpr)),
                      BWD_BLOCKS_PER_SM * _build.sm_count(x.device)))


def ln_backward(x: torch.Tensor, dy: torch.Tensor, g: torch.Tensor,
                mean: torch.Tensor, rstd: torch.Tensor):
    """``ln_rows_bwd_kernel`` then ``ln_rows_dparam_kernel`` on x's card:
    x (..., D) bf16 and its cotangent dy (bf16 or f32), γ (D,) f32, the
    forward's mean and rstd → (dx bf16, dγ (D,) f32, dβ (D,) f32), dγ and
    dβ summed in a fixed order (two calls on the same inputs are
    bit-equal)."""
    rows, d, tpr, vpt = _check(x, dy.dtype, MAX_VPT_BWD, g)
    _aligned(x, dy)
    if dy.shape != x.shape:
        raise ValueError(f"dy {tuple(dy.shape)} for x {tuple(x.shape)}")
    for t in (mean, rstd):
        if t.shape != (rows,) or t.dtype != torch.float32 \
                or t.device != x.device or not t.is_contiguous():
            raise ValueError(f"mean and rstd must be contiguous ({rows},) "
                             f"f32 on {x.device}")
    blocks = _blocks(x, rows, tpr)
    dx = torch.empty_like(x)
    part = torch.empty((blocks, 2, d), dtype=torch.float32, device=x.device)
    dparams = torch.empty((2, d), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        _build.launch(
            "layernorm.cu", "ln_rows_backward", SIGNATURES,
            int(dy.dtype == torch.float32), x.data_ptr(), dy.data_ptr(),
            g.data_ptr(), mean.data_ptr(), rstd.data_ptr(), dx.data_ptr(),
            part.data_ptr(), dparams.data_ptr(), rows, d, tpr, vpt, blocks,
            _build.stream(x))
    layer_norm.bwd_launches += 1
    return dx, dparams[0], dparams[1]


class LayerNormRows(torch.autograd.Function):
    """x (..., D), γ, β (D,) f32 → y in ``out_dtype``, through the pair;
    the cotangent reaches the backward as it comes (bf16 or f32)."""

    @staticmethod
    def forward(ctx, x, g, b, eps: float, out_dtype):
        y, mean, rstd = ln_forward(x, g, b, eps, out_dtype)
        ctx.save_for_backward(x, g, mean, rstd)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, g, mean, rstd = ctx.saved_tensors
        dx, dg, db = ln_backward(x, dy.contiguous(), g, mean, rstd)
        return dx, dg, db, None, None


def layer_norm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
               eps: float, out_dtype=None) -> torch.Tensor:
    """LayerNorm of x (..., D) over its last axis with γ, β (D,) f32, in
    ``out_dtype`` (x's type if None).  CPU tensors: ``ln_f32(x, g, b,
    eps).to(out_dtype)`` under plain autograd; CUDA tensors: the pair
    (``LayerNormRows`` where autograd records, else ``ln_forward``
    alone), or raises."""
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return ln_f32(x, g, b, eps).to(out_dtype)
    x = x.contiguous()
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, g, b)):
        return LayerNormRows.apply(x, g, b, eps, out_dtype)
    return ln_forward(x, g, b, eps, out_dtype)[0]


layer_norm.launches = 0
layer_norm.bwd_launches = 0
