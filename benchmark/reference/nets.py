"""The networks in plain PyTorch: the device transform, ResNet v1.5, ViT
and the FCGGNN head, each a function of a state dict in torchvision's and
the reference FCGGNN's names.

Every tensor a layer hands on (a product's operands and result, a norm's
or an activation's output, the residual stream after each add, the GGNN's
gates and state) passes through a ``Precision``: ``f32`` leaves it as it
is (the reference); ``bf16`` and ``fp8`` (e4m3 with one scale per tensor)
round it, which is how a network computed in that type stores its
activations, and how the lower-precision control is computed.  Sums
inside a product or a reduction stay float32 in every case, with TF32 off
(``strict_f32``).
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
FP8_MAX = 448.0


def strict_f32() -> None:
    """Float32 products in float32: no TF32 in matmuls or convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


class Precision:
    """Rounding of a product's operands: ``f32`` (none), ``bf16`` or
    ``fp8`` (float8 e4m3, the tensor scaled so that its largest magnitude
    is 448).  Gradients pass straight through the rounding."""

    def __init__(self, name: str = "f32"):
        if name not in ("f32", "bf16", "fp8"):
            raise ValueError(f"precision must be f32|bf16|fp8, got {name!r}")
        self.name = name

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.name == "f32":
            return x
        with torch.no_grad():
            v = x.detach()
            if self.name == "bf16":
                r = v.to(torch.bfloat16).float()
            else:
                s = v.abs().amax().clamp_min(1e-30) / FP8_MAX
                r = (v / s).to(torch.float8_e4m3fn).float() * s
        return x + (r - v) if x.requires_grad else r


def linear(x, w, b, p: Precision):
    """x @ wᵀ + b with w in ``nn.Linear``'s (out, in) layout."""
    y = p(x) @ p(w).t()
    return p(y if b is None else y + b)


# ------------------------------------------------------------- transform


def resize_weights(src: int, dst: int, device) -> torch.Tensor:
    """(src, dst) weights of an antialiased linear (triangle) resize:
    output sample j sits at (j + 1/2)·src/dst - 1/2, and the triangle is
    widened by src/dst when shrinking; each column sums to 1."""
    scale = src / dst
    width = max(scale, 1.0)
    pos = (torch.arange(dst, dtype=torch.float64) + 0.5) * scale - 0.5
    dist = (pos[None, :] - torch.arange(src, dtype=torch.float64)[:, None])
    w = torch.clamp(1.0 - dist.abs() / width, min=0.0)
    w = w / w.sum(dim=0, keepdim=True)
    inside = (pos >= -0.5) & (pos <= src - 0.5)
    return (w * inside[None, :]).to(torch.float32).to(device)


def transform(images_u8: torch.Tensor, flip, crop: int) -> torch.Tensor:
    """(B, S, S, 3) uint8 windows → (B, crop, crop, 3) float32: resized,
    scaled to [0, 1], ImageNet-normalised, and mirrored left-right where
    ``flip`` (B,) is true (None: no mirror)."""
    dev = images_u8.device
    x = images_u8.float()
    m = resize_weights(x.shape[1], crop, dev)
    y = torch.einsum("bhwc,hH->bHwc", x, m)
    y = torch.einsum("bHwc,wW->bHWc", y, m)
    if flip is not None:
        y = torch.where(flip.to(dev)[:, None, None, None], y.flip(2), y)
    mean = torch.tensor(MEAN, device=dev)
    std = torch.tensor(STD, device=dev)
    return (y / 255.0 - mean) / std



# ---------------------------------------------------------------- ResNet


def _bn(x, sd, name, mode, stats, eps=1e-5):
    """Batch norm: in ``train`` mode the batch's mean and biased variance
    (recorded in ``stats`` by layer name when given), in ``eval`` mode the
    running ones of the state dict."""
    if mode == "train":
        mean = x.mean(dim=(0, 2, 3))
        var = x.var(dim=(0, 2, 3), unbiased=False)
        if stats is not None:
            stats[name] = (mean, var)
    else:
        mean, var = sd[name + ".running_mean"], sd[name + ".running_var"]
    scale = sd[name + ".weight"] * torch.rsqrt(var + eps)
    return x * scale[None, :, None, None] \
        + (sd[name + ".bias"] - mean * scale)[None, :, None, None]


def _conv_bn(x, sd, conv, bn, p, mode, stats, stride=1, padding=0):
    y = p(F.conv2d(p(x), p(sd[conv + ".weight"]), None, stride, padding))
    return p(_bn(y, sd, bn, mode, stats))


def resnet_features(sd: dict, x_nhwc: torch.Tensor, stages, p: Precision,
                    bn: str = "train", stats: dict | None = None):
    """ResNet v1.5 of Bottleneck blocks (expansion 4, stride on the 3x3)
    → pooled features (B, 32·base width); batch norm in ``bn`` mode
    (``train``: batch statistics, recorded in ``stats`` if given;
    ``eval``: the running statistics)."""
    x = p(x_nhwc.permute(0, 3, 1, 2).contiguous())
    cb = functools.partial(_conv_bn, sd=sd, p=p, mode=bn, stats=stats)
    x = torch.relu(cb(x, conv="conv1", bn="bn1", stride=2, padding=3))
    x = F.max_pool2d(x, 3, 2, 1)
    for i, blocks in enumerate(stages):
        for j in range(blocks):
            pre = f"layer{i + 1}.{j}."
            stride = 2 if i > 0 and j == 0 else 1
            y = torch.relu(cb(x, conv=pre + "conv1", bn=pre + "bn1"))
            y = torch.relu(cb(y, conv=pre + "conv2", bn=pre + "bn2",
                              stride=stride, padding=1))
            y = cb(y, conv=pre + "conv3", bn=pre + "bn3")
            if pre + "downsample.0.weight" in sd:
                x = cb(x, conv=pre + "downsample.0", bn=pre + "downsample.1",
                       stride=stride)
            x = p(torch.relu(y + x))
            del y
    return p(x.mean(dim=(2, 3)))


# ------------------------------------------------------------------- ViT


def _vit_block(t, sd, pre, heads, eps, p):
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


def vit_features(sd: dict, x_nhwc: torch.Tensor, patch: int, depth: int,
                 heads: int, p: Precision, remat: bool = False,
                 eps: float = 1e-6):
    """Pre-LN ViT (torchvision's): patch embedding, class token, position
    embedding, ``depth`` blocks (exact-erf GELU), the final LayerNorm's
    class-token row → (B, width).  ``remat`` recomputes each block in the
    backward (memory only; the same numbers)."""
    b, s = x_nhwc.shape[0], x_nhwc.shape[1]
    g = s // patch
    w = sd["conv_proj.weight"]
    d = w.shape[0]
    pt = x_nhwc.reshape(b, g, patch, g, patch, 3).permute(0, 1, 3, 5, 2, 4)
    t = linear(pt.reshape(b, g * g, 3 * patch * patch), w.reshape(d, -1),
               sd["conv_proj.bias"], p)
    t = torch.cat([sd["class_token"].expand(b, 1, d), t], dim=1)
    t = p(t + sd["encoder.pos_embedding"])
    for i in range(depth):
        pre = f"encoder.layers.encoder_layer_{i}."
        if remat and torch.is_grad_enabled():
            t = checkpoint(_vit_block, t, sd, pre, heads, eps, p,
                           use_reentrant=False)
        else:
            t = _vit_block(t, sd, pre, heads, eps, p)
    return p(F.layer_norm(t[:, 0], (d,), sd["encoder.ln.weight"],
                          sd["encoder.ln.bias"], eps))


# ------------------------------------------------------------ the head

GATES = ("W_p", "W_z", "U_z", "W_r", "U_r", "W_h", "U_h")


def role_tables(train_set: dict, max_roles: int):
    """The vocabulary of an imSitu-format train set, scanned in order of
    first appearance → (verb names, role names, label names, role ids
    (V, R) long padded with the number of roles, role counts (V,))."""
    verbs, roles, labels = {}, {}, {}
    per_verb: dict = {}
    for ann in train_set.values():
        verb = ann["verb"]
        verbs.setdefault(verb, len(verbs))
        own = per_verb.setdefault(verb, [])
        for frame in ann["frames"]:
            for role, label in frame.items():
                roles.setdefault(role, len(roles))
                labels.setdefault(label, len(labels))
                if role not in own:
                    own.append(role)
    ids = torch.full((len(verbs), max_roles), len(roles), dtype=torch.long)
    counts = torch.zeros(len(verbs), dtype=torch.long)
    for verb, v in verbs.items():
        counts[v] = len(per_verb[verb])
        for j, role in enumerate(per_verb[verb]):
            ids[v, j] = roles[role]
    return list(verbs), list(roles), list(labels), ids, counts


def adjacency(counts: torch.Tensor, r: int) -> torch.Tensor:
    """(B, r, r) role graph of verbs with ``counts`` real roles: every real
    role linked to every other real role, each pad slot to itself."""
    m = (torch.arange(r, device=counts.device)[None, :]
         < counts[:, None]).float()
    eye = torch.eye(r, device=counts.device)
    return m[:, :, None] * m[:, None, :] * (1 - eye) \
        + eye * (1 - m)[:, :, None]


def _gate(sd, name, x, p):
    return linear(x, sd[f"ggsnn.{name}.weight"], sd[f"ggsnn.{name}.bias"], p)


def ggnn(sd: dict, h: torch.Tensor, adj, steps: int, p: Precision):
    """Gated graph propagation: the message of node i is Σ_j A_ij h_j
    through W_p, whose bias each of the r slots adds; then the GRU
    update.  ``adj`` None: one node per graph, messaging itself."""
    r = 1 if adj is None else h.shape[1]
    for _ in range(steps):
        agg = h if adj is None else adj @ h
        n = p(linear(agg, sd["ggsnn.W_p.weight"], None, p)
              + r * sd["ggsnn.W_p.bias"])
        z = p(torch.sigmoid(_gate(sd, "W_z", n, p) + _gate(sd, "U_z", h, p)))
        rr = p(torch.sigmoid(_gate(sd, "W_r", n, p)
                             + _gate(sd, "U_r", h, p)))
        c = p(torch.tanh(_gate(sd, "W_h", n, p)
                         + _gate(sd, "U_h", p(rr * h), p)))
        h = p((1 - z) * h + z * c)
    return h


def _dropout(x, rate, gen):
    if gen is None or rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=gen, device=x.device) < 1 - rate
    return torch.where(keep, x / (1 - rate), torch.zeros_like(x))


def verb_logits(sd, feats, steps, p, rate=0.0, gen=None):
    """The verb branch: relu(features), single-node propagation, dropout,
    the verb classifier → (B, V)."""
    h = ggnn(sd, p(torch.relu(feats)), None, steps, p)
    return linear(_dropout(h, rate, gen), sd["verb_classifier.1.weight"],
                  sd["verb_classifier.1.bias"], p)


def noun_logits(sd, feats, verbs, role_ids, counts, steps, p, rate=0.0,
                gen=None):
    """The noun branch of the given verbs: node init relu(f · role
    embedding · verb embedding), propagation over the verb's role graph,
    dropout, the noun classifier → (B, R, L)."""
    r = role_ids.shape[1]
    role_e = sd["role_emb.weight"][role_ids[verbs]]
    verb_e = sd["verb_emb.weight"][verbs]
    node = p(torch.relu(feats[:, None, :] * role_e * verb_e[:, None, :]))
    h = ggnn(sd, node, adjacency(counts[verbs], r), steps, p)
    return linear(_dropout(h, rate, gen), sd["nouns_classifier.1.weight"],
                  sd["nouns_classifier.1.bias"], p)


def verb_loss(logits, verbs):
    """Mean cross-entropy over the batch."""
    return F.cross_entropy(logits, verbs)


def nouns_loss(logits, labels, ignore: int):
    """Σ over the 3 annotations of the mean cross-entropy over the (row,
    role) positions that annotation labels (``ignore`` marks the rest)."""
    total = logits.new_zeros(())
    flat = logits.reshape(-1, logits.shape[-1])
    for n in range(labels.shape[1]):
        total = total + F.cross_entropy(flat, labels[:, n, :].reshape(-1),
                                        ignore_index=ignore)
    return total
