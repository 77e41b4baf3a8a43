"""The Swin Transformer's windowed attention in plain PyTorch: the window
geometry (relative-position index, shifted-window masks, partition and
reverse) and the twins of the CUDA pair of ``csrc/swin_attention.cu``.

No TPU kernel of the JAX package computes this (it has no Swin): the pair
was written for the port's Swin-L, whose attention K5/K7/K8 cannot run
(heads 32 wide, a learned per-head bias, a mask by window).  The
equations are microsoft/Swin-Transformer's ``WindowAttention`` and
``SwinTransformerBlock`` (arXiv:2103.14030):

* the relative-position bias of a head is its table (``(2w−1)²`` rows)
  gathered by ``relative_position_index(w)``: (h, N, N) over the N = w²
  tokens of a window;
* a shifted block rolls the map by −shift, partitions it into windows,
  and masks the pairs of a window that came from different regions of
  the unrolled map with −100 (``shift_mask``, the published
  construction);
* the core, per window and head: ``softmax(q·kᵀ·scale + bias + mask)·v``.

The core's operand is the qkv projection's output in window order, (BW·N,
3C) with BW = B·nW windows and the heads packed as the published
``reshape(B_, N, 3, h, dh)`` (q of head i at columns i·dh .. i·dh+dh−1, k
from C, v from 2C); the context is (BW·N, C), head i at columns i·dh.
The mask (nW, N, N) is indexed by a window's place in its image, w mod nW
(windows of an image are consecutive).

* ``wattn_reference`` / ``wattn_bwd_reference`` — the twins of
  ``swin_wattn_fwd_kernel`` and ``swin_wattn_bwd_kernel`` (with
  ``swin_wattn_dbias_kernel``): the forward as plain torch operations (f32
  scores, bias and mask, the f32 softmax cast to the operand type, P·V
  with f32 sums; differentiable, so that autograd over it checks the
  backward twin), and the backward with the kernel's roundings: the
  softmax recomputed in f32, dP = dO·Vᵀ, D = Σ P∘dP and dS = P∘(dP − D)
  in f32, dV = P'ᵀ·dO, dQ = dS'·K·scale, dK = dS'ᵀ·Q·scale with P', dS'
  in the operand type and f32 sums, and dbias = Σ over every window of
  dS in f32.

At f32 the twins are the exact equations (the roundings are no-ops);
``ops/swin_kernel.py`` runs them for CPU tensors.
"""

from __future__ import annotations

import torch

#: the published mask value of a pair of tokens from different regions
MASK_VALUE = -100.0


def relative_position_index(w: int) -> torch.Tensor:
    """(N, N) int64, N = w²: the row of the bias table for each pair of
    tokens of a w×w window (``WindowAttention.relative_position_index``)."""
    coords = torch.stack(torch.meshgrid(torch.arange(w), torch.arange(w),
                                        indexing="ij")).flatten(1)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0)
    rel = rel + (w - 1)
    return rel[:, :, 0] * (2 * w - 1) + rel[:, :, 1]


def window_partition(x: torch.Tensor, w: int) -> torch.Tensor:
    """(B, H, W, C) → (B·nW·w², C): the w×w windows in row-major order of
    windows, each window's tokens in row-major order."""
    b, h, wd, c = x.shape
    x = x.reshape(b, h // w, w, wd // w, w, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, c)


def window_reverse(x: torch.Tensor, w: int, h: int, wd: int) -> torch.Tensor:
    """``window_partition``'s inverse: (B·nW·w², C) → (B, H, W, C)."""
    c = x.shape[-1]
    b = x.shape[0] // (h * wd)
    x = x.reshape(b, h // w, wd // w, w, w, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, wd, c)


def shift_mask(h: int, wd: int, w: int, shift: int) -> torch.Tensor:
    """(nW, N, N) f32 of a map of h×wd in windows of w shifted by
    ``shift``: 0 where two tokens of a window come from the same region of
    the unrolled map, −100 where not (``SwinTransformerBlock``'s
    ``attn_mask``)."""
    img = torch.zeros((1, h, wd, 1))
    cnt = 0
    for hs in (slice(0, -w), slice(-w, -shift), slice(-shift, None)):
        for ws in (slice(0, -w), slice(-w, -shift), slice(-shift, None)):
            img[:, hs, ws, :] = cnt
            cnt += 1
    win = window_partition(img, w).view(-1, w * w)
    diff = win[:, None, :] - win[:, :, None]
    return torch.where(diff != 0, torch.tensor(MASK_VALUE),
                       torch.tensor(0.0))


def _split(qkv: torch.Tensor, heads: int, n: int):
    m, c3 = qkv.shape
    c = c3 // 3
    if c3 % 3 or c % heads or m % n:
        raise ValueError(f"bad window-attention shape: qkv {tuple(qkv.shape)}"
                         f", {heads} heads, windows of {n} tokens")
    t = qkv.view(m // n, n, 3, heads, c // heads).permute(2, 0, 3, 1, 4)
    return t[0], t[1], t[2]


def _merge(t: torch.Tensor) -> torch.Tensor:
    """(BW, h, N, dh) → (BW·N, h·dh)."""
    bw, h, n, dh = t.shape
    return t.permute(0, 2, 1, 3).reshape(bw * n, h * dh)


def _scores(q, k, bias, mask, scale):
    """The f32 scores (BW, h, N, N): q·kᵀ·scale + bias (+ the window's
    mask)."""
    s = (q.float() @ k.float().transpose(-1, -2)) * scale + bias.float()
    if mask is not None:
        bw, h, n, _ = s.shape
        nw = mask.shape[0]
        s = (s.view(bw // nw, nw, h, n, n)
             + mask.float()[None, :, None]).view(bw, h, n, n)
    return s


def wattn_reference(qkv: torch.Tensor, bias: torch.Tensor, mask, heads: int,
                    n: int, scale: float) -> torch.Tensor:
    """Twin of ``swin_wattn_fwd_kernel``: qkv (BW·N, 3C), bias (h, N, N),
    mask (nW, N, N) or None → context (BW·N, C) in qkv's type.  Scores,
    bias, mask and softmax in f32; P cast to qkv's type; P·V with f32
    sums."""
    q, k, v = _split(qkv, heads, n)
    p = torch.softmax(_scores(q, k, bias, mask, scale), dim=-1).to(qkv.dtype)
    return _merge(p.float() @ v.float()).to(qkv.dtype)


def wattn_bwd_reference(qkv: torch.Tensor, bias: torch.Tensor, mask,
                        dout: torch.Tensor, heads: int, n: int,
                        scale: float):
    """Twin of ``swin_wattn_bwd_kernel`` + ``swin_wattn_dbias_kernel``:
    qkv (BW·N, 3C), bias, mask, and the context's cotangent dout (BW·N, C)
    → (dqkv (BW·N, 3C) in qkv's type, dbias (h, N, N) f32)."""
    dt = qkv.dtype
    with torch.no_grad():
        q, k, v = (t.float() for t in _split(qkv, heads, n))
        do = dout.view(-1, n, heads, dout.shape[1] // heads).permute(
            0, 2, 1, 3).float()
        p = torch.softmax(_scores(q, k, bias, mask, scale), dim=-1)
        dp = do @ v.transpose(-1, -2)
        ds = p * (dp - (p * dp).sum(dim=-1, keepdim=True))
        dbias = ds.sum(dim=0)
        p_, ds_ = p.to(dt).float(), ds.to(dt).float()
        dv = p_.transpose(-1, -2) @ do
        dq = (ds_ @ k) * scale
        dk = (ds_.transpose(-1, -2) @ q) * scale
        dqkv = torch.cat([_merge(t) for t in (dq, dk, dv)], dim=1).to(dt)
    return dqkv, dbias
