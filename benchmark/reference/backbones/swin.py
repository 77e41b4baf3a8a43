"""Swin Transformer in plain PyTorch, in microsoft/Swin-Transformer's
state-dict names (``backbone.kind`` ``swin``; shape keys ``patch``,
``embed``, ``depths``, ``heads``, ``window``, ``mlp_ratio`` and ``remat``,
with the image's ``crop``).

The published ``SwinTransformer`` (arXiv:2103.14030) without its
classifier, followed equation by equation: the patch embedding and its
LayerNorm; per stage, blocks of pre-LN windowed attention (q scaled by
dh^-½, q·kᵀ plus the head's relative-position bias gathered from its
table, plus the shifted-window mask of 0 / −100 in every second block,
softmax, ·v, the projection) and an MLP (exact GELU), each with its
residual, the shifted blocks rolling the map by −⌊w/2⌋ before the
partition and back after; a stage whose map is no larger than the window
takes the whole map as its window and never shifts; patch merging (x0
(0, 0), x1 (1, 0), x2 (0, 1), x3 (1, 1) concatenated, LayerNorm(4C), a
linear without bias) after every stage but the last; the final LayerNorm
and the mean over the tokens.  LayerNorm eps 1e-5.

Departures: the linears and the bias tables draw normal(0.02) without
the published truncation at ±2σ (``leaves``); stochastic depth and
dropout are left out (the configuration states it).
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from reference.nets import Precision, linear

EPS = 1e-5


def _stages(cfg: dict):
    """(dim, heads, depth, window, shift, resolution) of each stage."""
    b = cfg["backbone"]
    res, dim = cfg["image"]["crop"] // b["patch"], b["embed"]
    out = []
    for depth, heads in zip(b["depths"], b["heads"]):
        window, shift = b["window"], b["window"] // 2
        if res <= window:
            window, shift = res, 0
        out.append((dim, heads, depth, window, shift, res))
        res, dim = res // 2, dim * 2
    return out


def leaves(cfg: dict):
    """(name, shape, init) of the backbone: the patch convolution uniform
    ±1/sqrt(fan in), LayerNorms 1 and 0, linears and bias tables
    normal(0.02), linear biases 0."""
    b = cfg["backbone"]
    patch, c, ratio = b["patch"], b["embed"], b.get("mlp_ratio", 4)
    fan = 3 * patch * patch

    def norm(name, d):
        return [(name + ".weight", (d,), ("const", 1.0)),
                (name + ".bias", (d,), ("const", 0.0))]

    def lin(name, dout, din, bias=True):
        out = [(name + ".weight", (dout, din), ("normal", 0.02))]
        return out + ([(name + ".bias", (dout,), ("const", 0.0))]
                      if bias else [])

    out = [("patch_embed.proj.weight", (c, 3, patch, patch),
            ("uniform", fan ** -0.5)),
           ("patch_embed.proj.bias", (c,), ("uniform", fan ** -0.5))]
    out += norm("patch_embed.norm", c)
    stages = _stages(cfg)
    for i, (dim, heads, depth, window, _, _) in enumerate(stages):
        for j in range(depth):
            pre = f"layers.{i}.blocks.{j}."
            out += norm(pre + "norm1", dim)
            out += [(pre + "attn.relative_position_bias_table",
                     ((2 * window - 1) ** 2, heads), ("normal", 0.02))]
            out += lin(pre + "attn.qkv", 3 * dim, dim)
            out += lin(pre + "attn.proj", dim, dim)
            out += norm(pre + "norm2", dim)
            out += lin(pre + "mlp.fc1", ratio * dim, dim)
            out += lin(pre + "mlp.fc2", dim, ratio * dim)
        if i < len(stages) - 1:
            out += norm(f"layers.{i}.downsample.norm", 4 * dim)
            out += lin(f"layers.{i}.downsample.reduction", 2 * dim, 4 * dim,
                       bias=False)
    return out + norm("norm", stages[-1][0])


@functools.lru_cache(maxsize=None)
def _index(window: int) -> torch.Tensor:
    """The published ``relative_position_index`` (N, N)."""
    coords = torch.stack(torch.meshgrid(torch.arange(window),
                                        torch.arange(window),
                                        indexing="ij"))
    flat = torch.flatten(coords, 1)
    rel = (flat[:, :, None] - flat[:, None, :]).permute(1, 2, 0).contiguous()
    rel[:, :, 0] += window - 1
    rel[:, :, 1] += window - 1
    rel[:, :, 0] *= 2 * window - 1
    return rel.sum(-1)


def _partition(x: torch.Tensor, window: int) -> torch.Tensor:
    """(B, H, W, C) → (B·nW, window², C)."""
    b, h, w, c = x.shape
    x = x.view(b, h // window, window, w // window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window * window, c)


def _reverse(x: torch.Tensor, window: int, h: int, w: int) -> torch.Tensor:
    """(B·nW, window², C) → (B, H, W, C)."""
    b = x.shape[0] // (h * w // window // window)
    x = x.view(b, h // window, w // window, window, window, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, -1)


@functools.lru_cache(maxsize=None)
def _mask(res: int, window: int, shift: int) -> torch.Tensor:
    """The published ``attn_mask`` (nW, N, N) of a shifted block."""
    img = torch.zeros((1, res, res, 1))
    cnt = 0
    for hs in (slice(0, -window), slice(-window, -shift),
               slice(-shift, None)):
        for ws in (slice(0, -window), slice(-window, -shift),
                   slice(-shift, None)):
            img[:, hs, ws, :] = cnt
            cnt += 1
    win = _partition(img, window).view(-1, window * window)
    mask = win.unsqueeze(1) - win.unsqueeze(2)
    return mask.masked_fill(mask != 0, -100.0).masked_fill(mask == 0, 0.0)


def _ln(x, sd, name, p):
    return p(F.layer_norm(x, (x.shape[-1],), sd[name + ".weight"],
                          sd[name + ".bias"], EPS))


def _block(x, sd, pre, heads, window, shift, p):
    b, h, w, c = x.shape
    n, dh = window * window, c // heads
    y = _ln(x, sd, pre + "norm1", p)
    if shift:
        y = torch.roll(y, shifts=(-shift, -shift), dims=(1, 2))
    y = _partition(y, window)
    qkv = linear(y, sd[pre + "attn.qkv.weight"], sd[pre + "attn.qkv.bias"],
                 p).reshape(-1, n, 3, heads, dh).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]
    q = q * dh ** -0.5
    attn = p(q) @ p(k).transpose(-2, -1)
    table = sd[pre + "attn.relative_position_bias_table"]
    bias = table[_index(window).to(table.device).view(-1)].view(
        n, n, heads).permute(2, 0, 1)
    attn = attn + bias.unsqueeze(0)
    if shift:
        mask = _mask(h, window, shift).to(attn.device)
        nw = mask.shape[0]
        attn = attn.view(-1, nw, heads, n, n) + mask.unsqueeze(1).unsqueeze(0)
        attn = attn.view(-1, heads, n, n)
    o = p(p(torch.softmax(attn, dim=-1)) @ p(v))
    o = o.transpose(1, 2).reshape(-1, n, c)
    o = linear(o, sd[pre + "attn.proj.weight"], sd[pre + "attn.proj.bias"],
               p)
    o = _reverse(o, window, h, w)
    if shift:
        o = torch.roll(o, shifts=(shift, shift), dims=(1, 2))
    x = p(x + o)
    y = _ln(x, sd, pre + "norm2", p)
    y = p(F.gelu(linear(y, sd[pre + "mlp.fc1.weight"],
                        sd[pre + "mlp.fc1.bias"], p)))
    return p(x + linear(y, sd[pre + "mlp.fc2.weight"],
                        sd[pre + "mlp.fc2.bias"], p))


def _merge(x, sd, name, p):
    x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2],
                   x[:, 1::2, 1::2]], dim=-1)
    return linear(_ln(x, sd, name + ".norm", p),
                  sd[name + ".reduction.weight"], None, p)


def features(cfg: dict, sd: dict, x_nhwc: torch.Tensor, p: Precision):
    """Swin: patch embedding, the stages, the final LayerNorm's tokens
    averaged → (B, last stage's width).  ``remat`` recomputes each block
    in the backward (memory only; the same numbers)."""
    bcfg = cfg["backbone"]
    patch = bcfg["patch"]
    remat = bcfg.get("remat", False)
    b, s = x_nhwc.shape[0], x_nhwc.shape[1]
    g = s // patch
    w = sd["patch_embed.proj.weight"]
    c = w.shape[0]
    pt = x_nhwc.reshape(b, g, patch, g, patch, 3).permute(0, 1, 3, 5, 2, 4)
    x = linear(pt.reshape(b, g, g, 3 * patch * patch), w.reshape(c, -1),
               sd["patch_embed.proj.bias"], p)
    x = _ln(x, sd, "patch_embed.norm", p)
    stages = _stages(cfg)
    for i, (_, heads, depth, window, shift, _) in enumerate(stages):
        for j in range(depth):
            args = (sd, f"layers.{i}.blocks.{j}.", heads, window,
                    shift if j % 2 else 0, p)
            if remat and torch.is_grad_enabled():
                x = checkpoint(_block, x, *args, use_reentrant=False)
            else:
                x = _block(x, *args)
        if i < len(stages) - 1:
            x = _merge(x, sd, f"layers.{i}.downsample", p)
    x = _ln(x, sd, "norm", p)
    return p(x.mean(dim=(1, 2)))
