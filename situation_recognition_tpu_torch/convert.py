"""Weights carried across: JAX parameter trees and reference checkpoints →
this package's state dicts.

The port's state dicts use the reference layout:

* the backbone is a torchvision ResNet of Bottlenecks or BasicBlocks
  (``conv1.weight``, ``layer3.17.bn2.running_var``,
  ``layer1.0.downsample.0.weight`` ...);
* the head is the reference FCGGNN without its backbones
  (``role_emb.weight``, ``verb_emb.weight``, ``ggsnn.W_p.weight`` ...,
  ``verb_classifier.1.weight``, ``nouns_classifier.1.bias``).

So a reference ``model_state_dict`` splits into the two with
``from_reference`` (its twin backbones are frozen identical copies; the
``convnet_verbs`` one is taken), and the JAX package's trees convert with
``from_jax``:

* conv kernel   flax (kH, kW, I, O) → torch (O, I, kH, kW)
* dense kernel  flax (I, O)         → torch (O, I)
* BatchNorm ``scale``/``bias``/``mean``/``var`` → ``weight``/``bias``/
  ``running_mean``/``running_var``, with ``num_batches_tracked`` 0.

A ViT's tree converts with ``vit_state_from_jax`` into torchvision's
``VisionTransformer`` layout (``models/vit.py``): the flax
``DenseGeneral`` q/k/v kernels (D, h, dh) become the packed (3D, D)
``in_proj_weight``, the out kernel (h, dh, D) ``out_proj.weight``.

Inputs are nested dicts of numpy arrays (or anything ``np.asarray``
takes, and tensors); nothing here imports JAX.  ``head_params_to_jax``,
``resnet_params_to_jax``, ``resnet_stats_to_jax`` and
``vit_params_to_jax`` go the other way: the serving artifact encodes its
weights on that view (``serving.py``), and the tests compare parameters and
BN statistics with the JAX trainer's.

Public checkpoints, as the JAX package's ``utils/torch_convert.py`` reads
them, into the port's ViT layout:

* ``convert_vit`` — a torchvision ``VisionTransformer`` state dict (either
  MLP spelling, ``heads.*`` dropped);
* ``convert_clip_vit`` — a CLIP visual tower (with or without
  ``visual.``; ``proj`` is not applied);
* ``interpolate_pos_embed`` — either one's position embedding resampled to
  another grid as ``jax.image.resize(method="cubic")`` resamples it.

And a JAX package checkpoint (its msgpack tree, ``utils/msgpack.read``)
into the reference checkpoint dict that ``Trainer.load_model_state`` loads:
``export_reference_checkpoint`` (the numpy part of the JAX package's
``utils/torch_export.py``, with the Adamax state of
``export_adamax_state``).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Mapping, Tuple

import re

import numpy as np
import torch

from situation_recognition_tpu_torch.models.fcggnn import GGSNN_NAMES
from situation_recognition_tpu_torch.utils.checkpoint import (
    HISTORY_KEYS, history_list)

_REF_BACKBONE = "convnet_verbs.model."
_REF_TWIN = "convnet_nouns.model."


def _t(x, transpose=None) -> torch.Tensor:
    if torch.is_tensor(x):                     # e.g. a bf16 msgpack leaf
        x = x.detach().to("cpu", torch.float32).numpy()
    a = np.asarray(x, dtype=np.float32)
    if transpose is not None:
        a = np.transpose(a, transpose)
    return torch.from_numpy(np.array(a, order="C"))


def resnet_state_from_jax(params: Mapping, stats: Mapping) -> OrderedDict:
    """flax (params, batch_stats) of ``models/resnet.py`` → the port's
    ResNet state dict."""
    out: OrderedDict = OrderedDict()

    def conv(dst: str, p: Mapping) -> None:
        out[dst + ".weight"] = _t(p["kernel"], (3, 2, 0, 1))

    def bn(dst: str, p: Mapping, s: Mapping) -> None:
        out[dst + ".weight"] = _t(p["scale"])
        out[dst + ".bias"] = _t(p["bias"])
        out[dst + ".running_mean"] = _t(s["mean"])
        out[dst + ".running_var"] = _t(s["var"])
        out[dst + ".num_batches_tracked"] = torch.tensor(0, dtype=torch.long)

    conv("conv1", params["conv1"])
    bn("bn1", params["bn1"], stats["bn1"])
    blocks = sorted(
        (tuple(int(x) for x in k[len("layer"):].split("_")), k)
        for k in params if k.startswith("layer"))
    if not blocks:
        raise ValueError("no ResNet layers in the params tree")
    for (stage, block), key in blocks:
        bp, bs = params[key], stats[key]
        dst = f"layer{stage}.{block}"
        # a Bottleneck (resnet50/101/152) has conv1..3, a BasicBlock
        # (resnet18/34) conv1..2
        for c in (1, 2, 3) if "conv3" in bp else (1, 2):
            conv(f"{dst}.conv{c}", bp[f"conv{c}"])
            bn(f"{dst}.bn{c}", bp[f"bn{c}"], bs[f"bn{c}"])
        if "downsample_conv" in bp:
            conv(f"{dst}.downsample.0", bp["downsample_conv"])
            bn(f"{dst}.downsample.1", bp["downsample_bn"],
               bs["downsample_bn"])
    return out


def head_state_from_jax(head_params: Mapping) -> OrderedDict:
    """flax params of ``FCGGNNHead`` → the port's head state dict."""
    out: OrderedDict = OrderedDict()
    out["role_emb.weight"] = _t(head_params["role_emb"])
    out["verb_emb.weight"] = _t(head_params["verb_emb"])
    g = head_params["ggnn"]
    for theirs in GGSNN_NAMES:
        ours = theirs.lower()
        out[f"ggsnn.{theirs}.weight"] = _t(g[ours], (1, 0))
        out[f"ggsnn.{theirs}.bias"] = _t(g["b_" + ours])
    for name in ("verb_classifier", "nouns_classifier"):
        out[f"{name}.1.weight"] = _t(head_params[name]["kernel"], (1, 0))
        out[f"{name}.1.bias"] = _t(head_params[name]["bias"])
    return out


def from_jax(backbone_params: Mapping, backbone_stats: Mapping,
             head_params: Mapping) -> Tuple[OrderedDict, OrderedDict]:
    """The JAX trainer's three trees → (backbone state, head state)."""
    return (resnet_state_from_jax(backbone_params, backbone_stats),
            head_state_from_jax(head_params))


def from_reference(model_state_dict: Mapping
                   ) -> Tuple[OrderedDict, OrderedDict]:
    """A reference ``model_state_dict`` → (backbone state, head state)."""
    backbone: OrderedDict = OrderedDict()
    head: OrderedDict = OrderedDict()
    for k, v in model_state_dict.items():
        if not torch.is_tensor(v):
            v = torch.from_numpy(np.array(v))
        if k.startswith(_REF_BACKBONE):
            backbone[k[len(_REF_BACKBONE):]] = v
        elif not k.startswith(_REF_TWIN):
            head[k] = v
    return backbone, head


def _np(t) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy() if torch.is_tensor(t) \
        else np.asarray(t, np.float32)


def resnet_params_to_jax(backbone_state: Mapping) -> dict:
    """The port's ResNet state dict → the flax ``params`` tree of
    ``models/resnet.py`` (numpy; with ``resnet_stats_to_jax`` the inverse
    of ``resnet_state_from_jax``)."""
    out: dict = {}
    for key, value in backbone_state.items():
        parts = key.split(".")
        if parts[-1] not in ("weight", "bias"):
            continue
        if len(parts) == 2:                       # the stem's conv1 / bn1
            node = out.setdefault(parts[0], {})
            name = parts[0]
        else:
            block = out.setdefault(f"{parts[0]}_{parts[1]}", {})
            if parts[2] == "downsample":
                name = "downsample_conv" if parts[3] == "0" \
                    else "downsample_bn"
            else:
                name = parts[2]
            node = block.setdefault(name, {})
        if name.startswith("conv") or name == "downsample_conv":
            node["kernel"] = _np(value).transpose(2, 3, 1, 0)
        else:
            node["scale" if parts[-1] == "weight" else "bias"] = _np(value)
    return out


def head_params_to_jax(head_state: Mapping) -> dict:
    """The port's head state dict → flax params of ``FCGGNNHead`` (numpy;
    the inverse of ``head_state_from_jax``)."""
    out = {"role_emb": _np(head_state["role_emb.weight"]),
           "verb_emb": _np(head_state["verb_emb.weight"]), "ggnn": {}}
    for theirs in GGSNN_NAMES:
        ours = theirs.lower()
        out["ggnn"][ours] = _np(head_state[f"ggsnn.{theirs}.weight"]).T
        out["ggnn"]["b_" + ours] = _np(head_state[f"ggsnn.{theirs}.bias"])
    for name in ("verb_classifier", "nouns_classifier"):
        out[name] = {"kernel": _np(head_state[f"{name}.1.weight"]).T,
                     "bias": _np(head_state[f"{name}.1.bias"])}
    return out


def resnet_stats_to_jax(backbone_state: Mapping) -> dict:
    """The port's ResNet state dict → the flax ``batch_stats`` tree of
    ``models/resnet.py`` (numpy ``mean``/``var`` per BN)."""
    out: dict = {}
    for key, value in backbone_state.items():
        if not key.endswith(".running_mean"):
            continue
        prefix = key[:-len(".running_mean")]
        stats = {"mean": _np(value),
                 "var": _np(backbone_state[prefix + ".running_var"])}
        parts = prefix.split(".")
        if len(parts) == 1:                       # the stem's bn1
            out[parts[0]] = stats
            continue
        block = out.setdefault(f"{parts[0]}_{parts[1]}", {})
        name = "downsample_bn" if parts[2] == "downsample" else parts[2]
        block[name] = stats
    return out


_QKV = ("query", "key", "value")


def vit_state_from_jax(params: Mapping) -> OrderedDict:
    """flax params of ``models/vit.py`` ``ViT`` (either variant) → the
    port's ViT state dict in torchvision's layout."""
    out: OrderedDict = OrderedDict()
    d = int(np.asarray(params["cls_token"]).shape[-1])
    out["class_token"] = _t(params["cls_token"])
    out["conv_proj.weight"] = _t(params["patch_embed"]["kernel"],
                                 (3, 2, 0, 1))
    if "bias" in params["patch_embed"]:
        out["conv_proj.bias"] = _t(params["patch_embed"]["bias"])
    if "ln_pre" in params:
        out["ln_pre.weight"] = _t(params["ln_pre"]["scale"])
        out["ln_pre.bias"] = _t(params["ln_pre"]["bias"])
    out["encoder.pos_embedding"] = _t(params["pos_embed"])
    blocks = sorted(int(k[len("block"):]) for k in params
                    if k.startswith("block"))
    if not blocks:
        raise ValueError("no ViT blocks in the params tree")
    for i in blocks:
        p = params[f"block{i}"]
        dst = f"encoder.layers.encoder_layer_{i}"
        a = p["attn"]
        out[f"{dst}.ln_1.weight"] = _t(p["ln1"]["scale"])
        out[f"{dst}.ln_1.bias"] = _t(p["ln1"]["bias"])
        out[f"{dst}.self_attention.in_proj_weight"] = torch.cat([
            _t(np.asarray(a[n]["kernel"]).reshape(d, d), (1, 0))
            for n in _QKV])
        out[f"{dst}.self_attention.in_proj_bias"] = torch.cat([
            _t(np.asarray(a[n]["bias"]).reshape(d)) for n in _QKV])
        out[f"{dst}.self_attention.out_proj.weight"] = _t(
            np.asarray(a["out"]["kernel"]).reshape(d, d), (1, 0))
        out[f"{dst}.self_attention.out_proj.bias"] = _t(a["out"]["bias"])
        out[f"{dst}.ln_2.weight"] = _t(p["ln2"]["scale"])
        out[f"{dst}.ln_2.bias"] = _t(p["ln2"]["bias"])
        for fc, idx in (("fc1", 0), ("fc2", 3)):
            out[f"{dst}.mlp.{idx}.weight"] = _t(p["mlp"][fc]["kernel"],
                                                (1, 0))
            out[f"{dst}.mlp.{idx}.bias"] = _t(p["mlp"][fc]["bias"])
    out["encoder.ln.weight"] = _t(params["ln_final"]["scale"])
    out["encoder.ln.bias"] = _t(params["ln_final"]["bias"])
    return out


def vit_params_to_jax(state: Mapping, heads: int) -> dict:
    """The port's ViT state dict → flax params of ``models/vit.py``
    ``ViT`` (numpy; the inverse of ``vit_state_from_jax``)."""
    d = int(state["class_token"].shape[-1])
    dh = d // heads
    out = {"cls_token": _np(state["class_token"]),
           "pos_embed": _np(state["encoder.pos_embedding"]),
           "patch_embed": {"kernel": _np(state["conv_proj.weight"])
                           .transpose(2, 3, 1, 0)},
           "ln_final": {"scale": _np(state["encoder.ln.weight"]),
                        "bias": _np(state["encoder.ln.bias"])}}
    if "conv_proj.bias" in state:
        out["patch_embed"]["bias"] = _np(state["conv_proj.bias"])
    if "ln_pre.weight" in state:
        out["ln_pre"] = {"scale": _np(state["ln_pre.weight"]),
                         "bias": _np(state["ln_pre.bias"])}
    prefix = "encoder.layers.encoder_layer_"
    blocks = sorted({int(k[len(prefix):].split(".")[0]) for k in state
                     if k.startswith(prefix)})
    for i in blocks:
        src = f"{prefix}{i}"
        w = _np(state[f"{src}.self_attention.in_proj_weight"])
        b = _np(state[f"{src}.self_attention.in_proj_bias"])
        attn = {n: {"kernel": np.ascontiguousarray(
                        w[j * d:(j + 1) * d].T).reshape(d, heads, dh),
                    "bias": b[j * d:(j + 1) * d].reshape(heads, dh)}
                for j, n in enumerate(_QKV)}
        attn["out"] = {
            "kernel": np.ascontiguousarray(_np(
                state[f"{src}.self_attention.out_proj.weight"]).T)
            .reshape(heads, dh, d),
            "bias": _np(state[f"{src}.self_attention.out_proj.bias"])}
        out[f"block{i}"] = {
            "ln1": {"scale": _np(state[f"{src}.ln_1.weight"]),
                    "bias": _np(state[f"{src}.ln_1.bias"])},
            "ln2": {"scale": _np(state[f"{src}.ln_2.weight"]),
                    "bias": _np(state[f"{src}.ln_2.bias"])},
            "attn": attn,
            "mlp": {fc: {"kernel": _np(state[f"{src}.mlp.{idx}.weight"]).T,
                         "bias": _np(state[f"{src}.mlp.{idx}.bias"])}
                    for fc, idx in (("fc1", 0), ("fc2", 3))}}
    return out


# ------------------------------------------------ public ViT checkpoints


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys' cubic kernel with a = -0.5, as ``jax.image.resize`` evaluates
    it on |x| (``_fill_keys_cubic_kernel``)."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def cubic_resize_matrix(src: int, dst: int) -> torch.Tensor:
    """(src, dst) f32 weights of ``jax.image.resize(method="cubic")`` along
    one axis (``compute_weight_mat``): samples at pixel centres, the kernel
    widened by src/dst when shrinking (antialiasing), each column
    normalised, and columns whose sample lies outside the input zeroed.
    ``F.interpolate(mode="bicubic")`` differs: a = -0.75, clamped edges and
    no antialiasing."""
    f32 = torch.float32
    inv_scale = 1.0 / (dst / src)
    kernel_scale = max(inv_scale, 1.0)
    sample = (torch.arange(dst, dtype=f32) + 0.5) * inv_scale - 0.5
    x = torch.abs(sample[None, :] - torch.arange(src, dtype=f32)[:, None]) \
        / kernel_scale
    w = _keys_cubic(x)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(torch.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= src - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def interpolate_pos_embed(pos, target_tokens: int) -> torch.Tensor:
    """A ViT position embedding (1, N, D) → (1, target_tokens, D): the CLS
    row kept, the square grid of the others resampled as the JAX package's
    ``utils/torch_convert.interpolate_pos_embed`` resamples it
    (``cubic_resize_matrix`` along each axis, in f32).  The same token
    count returns the input as it is."""
    pos = pos if torch.is_tensor(pos) else torch.as_tensor(np.asarray(pos))
    if pos.dim() != 3 or pos.shape[0] != 1:
        raise ValueError(f"pos_embed must be (1, N, D), got "
                         f"{tuple(pos.shape)}")
    n_src = pos.shape[1]
    if target_tokens == n_src:
        return pos
    g_src = int(round((n_src - 1) ** 0.5))
    g_tgt = int(round((target_tokens - 1) ** 0.5))
    if g_src * g_src + 1 != n_src or g_tgt * g_tgt + 1 != target_tokens:
        raise ValueError(
            f"pos_embed grids must be square+CLS: {n_src} -> "
            f"{target_tokens} tokens do not factor as g*g+1")
    d = pos.shape[-1]
    grid = pos[0, 1:].reshape(g_src, g_src, d).to(torch.float32)
    m = cubic_resize_matrix(g_src, g_tgt)
    resized = torch.einsum("hwd,hH,wW->HWd", grid, m, m)
    return torch.cat([pos[:, :1].to(torch.float32),
                      resized.reshape(1, g_tgt * g_tgt, d)], dim=1)


def _target_tokens(patch_weight, image_size: int) -> int:
    """Tokens (+1 CLS) that a (O, I, p, p) patch convolution makes of an
    ``image_size`` square."""
    p = int(patch_weight.shape[-1])
    if image_size % p:
        raise ValueError(f"image_size {image_size} not divisible by patch "
                         f"{p}")
    return (image_size // p) ** 2 + 1


def convert_vit(state: Mapping, image_size: int | None = None
                ) -> OrderedDict:
    """A torchvision ``VisionTransformer`` state dict → the port's ViT
    state dict (``models/vit.py``): the MLP's ``mlp.linear_{1,2}`` or
    ``mlp.{0,3}`` as ``mlp.{0,3}``, the classifier ``heads.*`` dropped, and
    with ``image_size`` the position embedding resampled to its grid
    (``interpolate_pos_embed``)."""
    out: OrderedDict = OrderedDict()
    for k, v in state.items():
        if k.startswith("heads."):
            continue
        k = re.sub(r"\.mlp\.linear_1\.", ".mlp.0.", k)
        k = re.sub(r"\.mlp\.linear_2\.", ".mlp.3.", k)
        out[k] = _t(v)
    if not any(k.startswith("encoder.layers.") for k in out):
        raise ValueError("no encoder layers found (not a torchvision ViT?)")
    if image_size is not None:
        out["encoder.pos_embedding"] = interpolate_pos_embed(
            out["encoder.pos_embedding"],
            _target_tokens(out["conv_proj.weight"], image_size))
    return out


def convert_clip_vit(state: Mapping, image_size: int | None = None
                     ) -> OrderedDict:
    """A CLIP visual-tower state dict (keys with or without ``visual.``) →
    the port's CLIP-variant ViT state dict: ``class_embedding`` (D,) as
    ``class_token`` (1, 1, D), ``positional_embedding`` (N, D) as (1, N,
    D), the bias-free ``conv1`` as ``conv_proj``, ``ln_pre``, ``ln_post`` as
    the final LayerNorm, and each ``transformer.resblocks.i`` as an encoder
    layer (``mlp.c_fc`` / ``mlp.c_proj`` as ``mlp.0`` / ``mlp.3``).
    ``proj`` (CLS → the joint embedding space) is not applied: the
    features are the ``ln_post`` CLS row at full width."""
    pre = "visual." if any(k.startswith("visual.") for k in state) else ""

    def g(name):
        return _t(state[pre + name])

    d = int(g("class_embedding").shape[-1])
    out: OrderedDict = OrderedDict()
    out["class_token"] = g("class_embedding").reshape(1, 1, d)
    out["conv_proj.weight"] = g("conv1.weight")
    out["ln_pre.weight"] = g("ln_pre.weight")
    out["ln_pre.bias"] = g("ln_pre.bias")
    pos = g("positional_embedding")[None]
    if image_size is not None:
        pos = interpolate_pos_embed(
            pos, _target_tokens(out["conv_proj.weight"], image_size))
    out["encoder.pos_embedding"] = pos
    layer_re = re.compile(re.escape(pre)
                          + r"transformer\.resblocks\.(\d+)\.ln_1\.weight$")
    layers = sorted(int(m.group(1)) for k in state
                    if (m := layer_re.match(k)))
    if not layers:
        raise ValueError("no resblocks found (not a CLIP visual tower?)")
    names = (("ln_1.weight", "ln_1.weight"), ("ln_1.bias", "ln_1.bias"),
             ("attn.in_proj_weight", "self_attention.in_proj_weight"),
             ("attn.in_proj_bias", "self_attention.in_proj_bias"),
             ("attn.out_proj.weight", "self_attention.out_proj.weight"),
             ("attn.out_proj.bias", "self_attention.out_proj.bias"),
             ("ln_2.weight", "ln_2.weight"), ("ln_2.bias", "ln_2.bias"),
             ("mlp.c_fc.weight", "mlp.0.weight"),
             ("mlp.c_fc.bias", "mlp.0.bias"),
             ("mlp.c_proj.weight", "mlp.3.weight"),
             ("mlp.c_proj.bias", "mlp.3.bias"))
    for i in layers:
        for theirs, ours in names:
            out[f"encoder.layers.encoder_layer_{i}.{ours}"] = g(
                f"transformer.resblocks.{i}.{theirs}")
    out["encoder.ln.weight"] = g("ln_post.weight")
    out["encoder.ln.bias"] = g("ln_post.bias")
    return out


# ----------------------------------------------- JAX package checkpoints


def _find_adamax_node(opt_state: Mapping) -> Mapping:
    """The single ``{count, mu, nu}`` node of a ``to_state_dict`` snapshot
    of the JAX trainer's optax chain (clip + Adamax)."""
    hits = []

    def visit(node):
        if isinstance(node, Mapping):
            if {"count", "mu", "nu"} <= set(node):
                hits.append(node)
            else:
                for v in node.values():
                    visit(v)

    visit(opt_state)
    if len(hits) != 1:
        raise ValueError(
            f"expected exactly one adamax state node, found {len(hits)}")
    return hits[0]


def _trainable_order() -> list:
    """The reference's trainable parameters in registration order (its
    Adamax indices): (name, path in the JAX head tree, whether the JAX
    leaf is a transposed dense kernel)."""
    order = [("role_emb.weight", ("role_emb",), False),
             ("verb_emb.weight", ("verb_emb",), False)]
    for theirs in GGSNN_NAMES:
        ours = theirs.lower()
        order.append((f"ggsnn.{theirs}.weight", ("ggnn", ours), True))
        order.append((f"ggsnn.{theirs}.bias", ("ggnn", "b_" + ours), False))
    for name in ("verb_classifier", "nouns_classifier"):
        order.append((f"{name}.1.weight", (name, "kernel"), True))
        order.append((f"{name}.1.bias", (name, "bias"), False))
    return order


def export_adamax_state(opt_state: Mapping, lr: float = 0.002) -> dict:
    """The optax chain state of a JAX checkpoint → a
    ``torch.optim.Adamax`` state dict in the reference's indices: optax's
    ``mu`` / ``nu`` / ``count`` are Adamax's ``exp_avg`` / ``exp_inf`` /
    ``step``; the hyperparameters are the reference's (lr, torch's
    defaults)."""
    node = _find_adamax_node(opt_state)
    step = float(np.asarray(node["count"]))
    state = {}
    order = _trainable_order()
    for idx, (_, path, transpose) in enumerate(order):
        mu, nu = node["mu"], node["nu"]
        for p in path:
            mu, nu = mu[p], nu[p]
        perm = (1, 0) if transpose else None
        state[idx] = {"step": torch.tensor(step, dtype=torch.float32),
                      "exp_avg": _t(mu, perm), "exp_inf": _t(nu, perm)}
    return {"state": state,
            "param_groups": [{
                "lr": float(lr), "betas": (0.9, 0.999), "eps": 1e-8,
                "weight_decay": 0, "foreach": None, "maximize": False,
                "differentiable": False, "capturable": False,
                "params": list(range(len(order)))}]}


def export_reference_state_dict(backbone_params: Mapping,
                                backbone_stats: Mapping,
                                head_params: Mapping) -> OrderedDict:
    """The JAX trainer's three trees → a reference ``model_state_dict``
    (tensors, the reference's key order; the backbone under both twins,
    a ViT's in torchvision's layout)."""
    if "cls_token" in backbone_params:
        backbone = vit_state_from_jax(backbone_params)
    else:
        backbone = resnet_state_from_jax(backbone_params, backbone_stats)
    head = head_state_from_jax(head_params)
    names = list(head)
    out: OrderedDict = OrderedDict((k, head[k]) for k in names[:2])
    for twin in (_REF_BACKBONE, _REF_TWIN):
        for k, v in backbone.items():
            out[twin + k] = v
    for k in names[2:]:
        out[k] = head[k]
    return out


def export_reference_checkpoint(ckpt: Mapping, lr: float = 0.002) -> dict:
    """A JAX package checkpoint tree (``utils/msgpack.read`` of its
    ``save_checkpoint`` file: epoch, histories, ``backbone_params``,
    ``backbone_stats``, ``head_params``, ``opt_state``, ``step_count``, a
    mid-epoch ``mid``) → the reference checkpoint dict that
    ``Trainer.load_model_state`` and ``fit`` take."""
    out: dict = {"epoch": int(ckpt["epoch"])}
    for k in HISTORY_KEYS:
        out[k] = history_list(ckpt.get(k, []))
    out["model_state_dict"] = export_reference_state_dict(
        ckpt["backbone_params"], ckpt.get("backbone_stats") or {},
        ckpt["head_params"])
    if ckpt.get("opt_state") is not None:
        out["optimizer_state_dict"] = export_adamax_state(ckpt["opt_state"],
                                                          lr=lr)
    if ckpt.get("step_count") is not None:
        out["step_count"] = int(np.asarray(ckpt["step_count"]))
    mid = ckpt.get("mid")
    if isinstance(mid, Mapping):
        mid = dict(mid)
        if "loss_sums" in mid:
            mid["loss_sums"] = history_list(mid["loss_sums"])
        for k in ("batch_in_epoch", "step_count", "num_batches"):
            if k in mid:
                mid[k] = int(np.asarray(mid[k]))
        out["mid"] = mid
    return out
