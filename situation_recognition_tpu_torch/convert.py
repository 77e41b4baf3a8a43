"""Weights carried across: JAX parameter trees and reference checkpoints →
this package's state dicts.

The port's state dicts use the reference layout:

* the backbone is a torchvision ResNet (``conv1.weight``,
  ``layer3.17.bn2.running_var``, ``layer1.0.downsample.0.weight`` ...);
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

Inputs are nested dicts of numpy arrays (or anything ``np.asarray``
takes); nothing here imports JAX.
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
        for c in (1, 2, 3):
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
