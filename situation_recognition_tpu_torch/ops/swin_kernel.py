"""The Swin Transformer's window-attention core: wrappers that choose
between the CUDA pair of ``csrc/swin_attention.cu`` and the plain twins
of ``ops/swin.py`` by the device of the tensors, and the autograd
Function that puts the pair under a differentiated call.

The pair replaces no TPU kernel (the JAX package has no Swin): it was
added because the port's attention kernels take neither Swin's heads of
32 nor an additive bias and mask, and autograd over plain torch would
keep every block's (BW, h, N, N) scores and probabilities in device
memory and run the bias, the mask and the softmax as separate passes over
them.

* ``wattn_forward`` — ``swin_wattn_fwd_kernel``: qkv (BW·N, 3C) bf16 in
  window order, the gathered bias (h, N, N) f32 and the shifted-window
  mask (nW, N, N) f32 or None → the context (BW·N, C) bf16;
* ``wattn_backward`` — ``swin_wattn_bwd_kernel`` then
  ``swin_wattn_dbias_kernel``: (dqkv (BW·N, 3C) bf16, dbias (h, N, N)
  f32), the bias's gradient summed over every window in a fixed order
  (per-group partials, then one pass over the groups), so that two calls
  on the same inputs are bit-equal;
* ``WindowAttention`` — the core as a ``torch.autograd.Function``
  (forward: ``wattn_forward``; backward: ``wattn_backward``), which
  differentiated calls take; an undifferentiated call takes
  ``wattn_forward`` alone (``window_attention``).

The kernels take heads of ``HEAD_WIDTH`` over windows of at most
``MAX_TOKENS`` tokens (``kernel_takes``); a CUDA call of any other shape
or type raises, and a CPU tensor of any float type runs the twin.  There
is no fallback.  Each wrapper's ``launches`` counts its launches on the
card (one of ``wattn_backward`` is its two kernels), after the launch
returned without an error; the twins are not counted.
"""

from __future__ import annotations

import ctypes

import torch

from situation_recognition_tpu_torch.ops import _build
from situation_recognition_tpu_torch.ops.ggnn_kernel import _check_tensors
from situation_recognition_tpu_torch.ops.swin import (
    wattn_bwd_reference, wattn_reference)

#: the kernels' head width and most tokens a window
HEAD_WIDTH = 32
MAX_TOKENS = 64
#: blocks of a launch (over the groups of windows and the heads) the
#: grid aims at: a few waves of the card's 132 SMs
GRID_BLOCKS = 1536

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: csrc/swin_attention.cu's entry points → their parameters' ctypes types
SIGNATURES = {
    "swin_wattn_forward": [_P] * 4 + [_I] * 6 + [_F, _P],
    "swin_wattn_backward": [_P] * 7 + [_I] * 6 + [_F, _P],
}


def kernel_takes(c: int, heads: int, n: int, dtype: torch.dtype) -> bool:
    """True when the pair takes C columns in ``heads`` heads over windows
    of n tokens at ``dtype``: bf16, heads of ``HEAD_WIDTH``, 1 ≤ n ≤
    ``MAX_TOKENS``."""
    return (dtype == torch.bfloat16 and heads >= 1
            and c == heads * HEAD_WIDTH and 1 <= n <= MAX_TOKENS)


def groups(windows: int, heads: int) -> int:
    """The groups of windows a launch splits ``windows`` into: a block
    takes one group of one head (windows g, g + G, ...).  A function of
    the shape alone, so that the bias's gradient is summed in the same
    order on every call."""
    return max(1, min(windows, -(-GRID_BLOCKS // heads)))


def _check(qkv, bias, mask, heads: int, n: int, dout=None) -> tuple:
    """Checks of the pair's arguments on the card → (windows, C,
    windows an image)."""
    if qkv.dim() != 2 or qkv.shape[1] % 3:
        raise ValueError(f"qkv must be (BW·N, 3C), got {tuple(qkv.shape)}")
    m, c = qkv.shape[0], qkv.shape[1] // 3
    if not kernel_takes(c, heads, n, qkv.dtype):
        raise ValueError(
            f"the window-attention kernels take bf16 heads of {HEAD_WIDTH} "
            f"over windows of 1..{MAX_TOKENS} tokens, got {qkv.dtype}, C={c}"
            f" in {heads} heads, {n} tokens")
    if m < n or m % n:
        raise ValueError(f"{m} rows are not whole windows of {n} tokens")
    bw = m // n
    nw = 1 if mask is None else mask.shape[0]
    if nw < 1 or bw % nw:
        raise ValueError(f"{bw} windows are not whole images of {nw}")
    want = {"qkv": (qkv, (m, 3 * c), torch.bfloat16),
            "bias": (bias, (heads, n, n), torch.float32)}
    if mask is not None:
        want["mask"] = (mask, (nw, n, n), torch.float32)
    if dout is not None:
        want["dout"] = (dout, (m, c), torch.bfloat16)
    _check_tensors(qkv.device, want)
    return bw, c, nw


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


def wattn_forward(qkv: torch.Tensor, bias: torch.Tensor, mask, heads: int,
                  n: int) -> torch.Tensor:
    """The window-attention core: qkv (BW·N, 3C), bias (h, N, N) f32, mask
    (nW, N, N) f32 or None → context (BW·N, C) in qkv's type, scale
    dh^-½.  CPU tensors run the twin; CUDA tensors launch
    ``swin_wattn_fwd_kernel`` or raise."""
    c = qkv.shape[1] // 3
    scale = (c // heads) ** -0.5
    if qkv.device.type == "cpu":
        return wattn_reference(qkv, bias, mask, heads, n, scale)
    if qkv.device.type != "cuda":
        raise ValueError(f"no window-attention kernel for {qkv.device}")
    bw, c, nw = _check(qkv, bias, mask, heads, n)
    out = torch.empty((qkv.shape[0], c), dtype=qkv.dtype, device=qkv.device)
    with torch.cuda.device(qkv.device):
        _build.launch(
            "swin_attention.cu", "swin_wattn_forward", SIGNATURES,
            qkv.data_ptr(), bias.data_ptr(), _ptr(mask), out.data_ptr(), bw,
            nw, n, heads, c, groups(bw, heads), float(scale),
            _build.stream(qkv))
    wattn_forward.launches += 1
    return out


wattn_forward.launches = 0


def wattn_backward(qkv: torch.Tensor, bias: torch.Tensor, mask,
                   dout: torch.Tensor, heads: int, n: int):
    """The core's gradients: qkv, bias, mask as ``wattn_forward`` and the
    context's cotangent dout (BW·N, C) in qkv's type → (dqkv (BW·N, 3C) in
    qkv's type, dbias (h, N, N) f32).  CPU tensors run the twin; CUDA
    tensors launch ``swin_wattn_bwd_kernel`` and
    ``swin_wattn_dbias_kernel`` or raise."""
    c = qkv.shape[1] // 3
    scale = (c // heads) ** -0.5
    if qkv.device.type == "cpu":
        return wattn_bwd_reference(qkv, bias, mask, dout, heads, n, scale)
    if qkv.device.type != "cuda":
        raise ValueError(f"no window-attention kernel for {qkv.device}")
    bw, c, nw = _check(qkv, bias, mask, heads, n, dout)
    g = groups(bw, heads)
    dqkv = torch.empty_like(qkv)
    part = torch.empty((g, heads, n, n), dtype=torch.float32,
                       device=qkv.device)
    dbias = torch.empty((heads, n, n), dtype=torch.float32,
                        device=qkv.device)
    with torch.cuda.device(qkv.device):
        _build.launch(
            "swin_attention.cu", "swin_wattn_backward", SIGNATURES,
            qkv.data_ptr(), bias.data_ptr(), _ptr(mask), dout.data_ptr(),
            dqkv.data_ptr(), part.data_ptr(), dbias.data_ptr(), bw, nw, n,
            heads, c, g, float(scale), _build.stream(qkv))
    wattn_backward.launches += 1
    return dqkv, dbias


wattn_backward.launches = 0


class WindowAttention(torch.autograd.Function):
    """qkv (BW·N, 3C) and the gathered bias (h, N, N) → the context, with
    the hand backward: dqkv and dbias (the mask, a constant, takes none).
    The cotangent reaches the backward in qkv's type."""

    @staticmethod
    def forward(ctx, qkv, bias, mask, heads: int, n: int):
        out = wattn_forward(qkv, bias, mask, heads, n)
        ctx.save_for_backward(qkv, bias, mask)
        ctx.layout = (heads, n)
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv, bias, mask = ctx.saved_tensors
        dqkv, dbias = wattn_backward(qkv, bias, mask,
                                     dout.to(qkv.dtype).contiguous(),
                                     *ctx.layout)
        return dqkv, dbias.to(bias.dtype), None, None, None


def window_attention(qkv: torch.Tensor, bias: torch.Tensor, mask,
                     heads: int, n: int) -> torch.Tensor:
    """The core through the pair: ``WindowAttention`` where autograd
    records (qkv or bias requires a gradient), else ``wattn_forward``."""
    if torch.is_grad_enabled() and (qkv.requires_grad or bias.requires_grad):
        return WindowAttention.apply(qkv, bias, mask, heads, n)
    return wattn_forward(qkv, bias, mask, heads, n)
