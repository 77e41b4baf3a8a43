"""Pre-LN ViT in plain PyTorch, in torchvision's state-dict names
(``backbone.kind`` ``vit``; shape keys ``patch``, ``width``, ``depth``,
``heads``, ``mlp_ratio`` and ``remat``, with the image's ``crop``)."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from reference.nets import Precision, linear

EPS = 1e-6


def leaves(cfg: dict):
    """(name, shape, init) of the backbone: normal(0.02) position
    embedding, zero class token, LayerNorms 1 and 0, uniform ±1/sqrt(fan
    in) projections and patch convolution."""
    b = cfg["backbone"]
    patch, d, depth = b["patch"], b["width"], b["depth"]
    n = (cfg["image"]["crop"] // patch) ** 2 + 1
    fan = 3 * patch * patch
    out = [("class_token", (1, 1, d), ("const", 0.0)),
           ("conv_proj.weight", (d, 3, patch, patch),
            ("uniform", fan ** -0.5)),
           ("conv_proj.bias", (d,), ("uniform", fan ** -0.5)),
           ("encoder.pos_embedding", (1, n, d), ("normal", 0.02))]
    h = d * b.get("mlp_ratio", 4)
    for i in range(depth):
        pre = f"encoder.layers.encoder_layer_{i}."
        out += [(pre + "ln_1.weight", (d,), ("const", 1.0)),
                (pre + "ln_1.bias", (d,), ("const", 0.0)),
                (pre + "self_attention.in_proj_weight", (3 * d, d),
                 ("uniform", d ** -0.5)),
                (pre + "self_attention.in_proj_bias", (3 * d,),
                 ("uniform", d ** -0.5)),
                (pre + "self_attention.out_proj.weight", (d, d),
                 ("uniform", d ** -0.5)),
                (pre + "self_attention.out_proj.bias", (d,),
                 ("uniform", d ** -0.5)),
                (pre + "ln_2.weight", (d,), ("const", 1.0)),
                (pre + "ln_2.bias", (d,), ("const", 0.0)),
                (pre + "mlp.0.weight", (h, d), ("uniform", d ** -0.5)),
                (pre + "mlp.0.bias", (h,), ("uniform", d ** -0.5)),
                (pre + "mlp.3.weight", (d, h), ("uniform", h ** -0.5)),
                (pre + "mlp.3.bias", (d,), ("uniform", h ** -0.5))]
    out += [("encoder.ln.weight", (d,), ("const", 1.0)),
            ("encoder.ln.bias", (d,), ("const", 0.0))]
    return out


def _block(t, sd, pre, heads, eps, p):
    b, n, d = t.shape
    dh = d // heads
    y = p(F.layer_norm(t, (d,), sd[pre + "ln_1.weight"],
                       sd[pre + "ln_1.bias"], eps))
    qkv = linear(y, sd[pre + "self_attention.in_proj_weight"],
                 sd[pre + "self_attention.in_proj_bias"], p)
    q, k, v = (z.reshape(b, n, heads, dh).transpose(1, 2)
               for z in qkv.chunk(3, dim=-1))
    s = (p(q) @ p(k).transpose(-1, -2)) / math.sqrt(dh)
    o = p(p(torch.softmax(s, dim=-1)) @ p(v))
    o = o.transpose(1, 2).reshape(b, n, d)
    t = p(t + linear(o, sd[pre + "self_attention.out_proj.weight"],
                     sd[pre + "self_attention.out_proj.bias"], p))
    y = p(F.layer_norm(t, (d,), sd[pre + "ln_2.weight"],
                       sd[pre + "ln_2.bias"], eps))
    h = p(F.gelu(linear(y, sd[pre + "mlp.0.weight"], sd[pre + "mlp.0.bias"],
                        p)))
    return p(t + linear(h, sd[pre + "mlp.3.weight"], sd[pre + "mlp.3.bias"],
                        p))


def features(cfg: dict, sd: dict, x_nhwc: torch.Tensor, p: Precision):
    """Pre-LN ViT (torchvision's): patch embedding, class token, position
    embedding, ``depth`` blocks (exact-erf GELU), the final LayerNorm's
    class-token row → (B, width).  ``remat`` recomputes each block in the
    backward (memory only; the same numbers)."""
    bcfg = cfg["backbone"]
    patch, heads = bcfg["patch"], bcfg["heads"]
    remat = bcfg.get("remat", False)
    b, s = x_nhwc.shape[0], x_nhwc.shape[1]
    g = s // patch
    w = sd["conv_proj.weight"]
    d = w.shape[0]
    pt = x_nhwc.reshape(b, g, patch, g, patch, 3).permute(0, 1, 3, 5, 2, 4)
    t = linear(pt.reshape(b, g * g, 3 * patch * patch), w.reshape(d, -1),
               sd["conv_proj.bias"], p)
    t = torch.cat([sd["class_token"].expand(b, 1, d), t], dim=1)
    t = p(t + sd["encoder.pos_embedding"])
    for i in range(bcfg["depth"]):
        pre = f"encoder.layers.encoder_layer_{i}."
        if remat and torch.is_grad_enabled():
            t = checkpoint(_block, t, sd, pre, heads, EPS, p,
                           use_reentrant=False)
        else:
            t = _block(t, sd, pre, heads, EPS, p)
    return p(F.layer_norm(t[:, 0], (d,), sd["encoder.ln.weight"],
                          sd["encoder.ln.bias"], EPS))
