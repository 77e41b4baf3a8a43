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
takes); nothing here imports JAX.  ``head_params_to_jax``,
``resnet_stats_to_jax`` and ``vit_params_to_jax`` go the other way, so
that parameters and BN statistics can be compared with the JAX trainer's
after training steps.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Mapping, Tuple

import numpy as np
import torch

from situation_recognition_tpu_torch.models.fcggnn import GGSNN_NAMES

_REF_BACKBONE = "convnet_verbs.model."
_REF_TWIN = "convnet_nouns.model."


def _t(x, transpose=None) -> torch.Tensor:
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
