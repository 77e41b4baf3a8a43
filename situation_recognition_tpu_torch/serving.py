"""Serving artifacts: export → load → ``fn(images_u8)``.

Port of ``situation_recognition_tpu/serving.py``.  ``export_inference``
writes a directory with the model's weights (``weights.pt``, f32 state
dicts in the reference layout) and a ``meta.json`` with the JAX
artifact's keys.  ``load_inference`` rebuilds the model from the meta and
returns

    fn(images_u8 (B, 256, 256, 3) uint8)
        → (verb_logits (B, V) f32, verb_ids (B,), noun_logits (B, R, L) f32)

with ``fn.gt(images_u8, verb_ids) → noun_logits`` (the reference's
gt-verb path), ``fn.meta`` and ``fn.batch_size``.  The path on the device:
resize-as-matmul + ImageNet normalise, the backbone, the FCGGNN verb
branch, argmax, the noun branch.  The backbone is a ResNet
(eval-mode BN) or a ViT (``models/vit.py``, at the artifact's
``image_size``).  At bf16 on a CUDA device both GGNN propagates run
through the folded kernel, and a ViT's encoder blocks through the ViT
kernels (``block_impl``).  Like the JAX artifact the batch is baked at
export and any batch size is served by padding and chunking
(``_over_chunks``).
"""

from __future__ import annotations

import json
import os
from typing import Callable

import numpy as np
import torch
from torch import nn

from situation_recognition_tpu_torch.data.encoder import ImsituEncoder
from situation_recognition_tpu_torch.data.transforms import CROP, eval_transform
from situation_recognition_tpu_torch.device import resolve_device
from situation_recognition_tpu_torch.models.fcggnn import (
    FCGGNNHead, resolve_ggnn_impl)
from situation_recognition_tpu_torch.models.backbone import build_backbone

FORMAT_VERSION = 7          # the JAX artifact's meta version this mirrors
WEIGHTS_FILE = "weights.pt"

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class SituationModel(nn.Module):
    """Backbone + head + the encoder's tables: the served function.

    ``dtype`` is the compute type; ``ggnn_impl`` as in
    ``models.fcggnn.resolve_ggnn_impl`` (resolved by ``load_inference``
    for the device it serves on); ``block_impl`` a ViT's, as in
    ``models.vit.resolve_block_impl`` (resolved at each call)."""

    def __init__(self, encoder: ImsituEncoder, backbone: str = "resnet152",
                 hidden: int = 2048, image_size: int = CROP,
                 num_steps: int = 4, dtype: torch.dtype = torch.float32,
                 ggnn_impl: str = "masked", block_impl: str = "auto"):
        super().__init__()
        self.encoder = encoder
        self.backbone_name = backbone
        self.hidden = hidden
        self.image_size = image_size
        self.dtype = dtype
        self.backbone, self.backbone_has_bn = build_backbone(
            backbone, hidden, image_size, dtype, block_impl)
        self.head = FCGGNNHead(
            encoder.get_num_verbs(), encoder.get_num_roles(),
            encoder.get_num_labels(), encoder.max_role_count, hidden=hidden,
            num_steps=num_steps, dtype=dtype, ggnn_impl=ggnn_impl)
        self.register_buffer("role_ids", torch.as_tensor(
            encoder.role_ids, dtype=torch.long), persistent=False)
        self.register_buffer("role_mask", torch.as_tensor(
            encoder.role_mask), persistent=False)

    def features(self, images_u8: torch.Tensor) -> torch.Tensor:
        x = eval_transform(images_u8, dtype=self.dtype,
                           crop=self.image_size)
        return self.backbone(x).float()

    def serve(self, images_u8: torch.Tensor):
        feats = self.features(images_u8)
        verb_logits = self.head.predict_verb(feats)
        verb_ids = torch.argmax(verb_logits, dim=1)
        noun_logits = self.head.predict_nouns(feats, verb_ids, self.role_ids,
                                              self.role_mask)
        return verb_logits, verb_ids, noun_logits

    def serve_gt(self, images_u8: torch.Tensor, verb_ids: torch.Tensor):
        feats = self.features(images_u8)
        return self.head.predict_nouns(feats, verb_ids, self.role_ids,
                                       self.role_mask)


def export_inference(model: SituationModel, path: str,
                     batch_size: int = 1) -> None:
    """Write ``model`` as a serving artifact directory (weights + meta)."""
    enc = model.encoder
    os.makedirs(path, exist_ok=True)
    cpu = lambda sd: {k: v.detach().to("cpu", torch.float32)  # noqa: E731
                      if v.is_floating_point() else v.detach().cpu()
                      for k, v in sd.items()}
    torch.save({"backbone": cpu(model.backbone.state_dict()),
                "head": cpu(model.head.state_dict())},
               os.path.join(path, WEIGHTS_FILE))
    dtype_name = {v: k for k, v in _DTYPES.items()}[model.dtype]
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump({
            "format_version": FORMAT_VERSION,
            "batch_size": batch_size,
            "weights": "f32",
            "weights_file": WEIGHTS_FILE,
            "compute_dtype": dtype_name,
            "entries": {
                "argmax": {"signature": "images_u8 -> (verb_logits, "
                                        "verb_ids, noun_logits)"},
                "gt": {"signature": "(images_u8, verb_ids) -> "
                                    "noun_logits"},
            },
            "backbone": model.backbone_name,
            "hidden": model.hidden,
            "image_size": model.image_size,
            "num_steps": model.head.ggsnn.num_steps,
            "num_verbs": enc.get_num_verbs(),
            "num_labels": enc.get_num_labels(),
            "max_role_count": enc.max_role_count,
            "verb_list": enc.verb_list,
            "label_list": enc.label_list,
            "role_list": enc.role_list,
            "roles_per_verb": enc.roles_per_verb,
        }, f)


def load_inference(path: str, device=None, ggnn_impl: str = "auto",
                   block_impl: str = "auto") -> Callable:
    """Load an artifact → ``fn(images_u8)`` on ``device`` (default cuda;
    raises without a card unless ``device="cpu"``).  ``ggnn_impl`` and a
    ViT's ``block_impl`` override the implementations (``masked`` and
    ``plain`` serve the same weights through the plain paths)."""
    dev = resolve_device(device)
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    dtype = _DTYPES[meta.get("compute_dtype", "float32")]
    enc = ImsituEncoder.from_dict({
        "verb_list": meta["verb_list"], "role_list": meta["role_list"],
        "label_list": meta["label_list"],
        "roles_per_verb": meta["roles_per_verb"],
        "max_role_count": meta["max_role_count"]})
    model = SituationModel(
        enc, backbone=meta["backbone"], hidden=meta["hidden"],
        image_size=meta.get("image_size", CROP),
        num_steps=meta.get("num_steps", 4), dtype=dtype,
        ggnn_impl=resolve_ggnn_impl(ggnn_impl, dtype, dev),
        block_impl=block_impl)
    state = torch.load(os.path.join(path, meta["weights_file"]),
                       map_location="cpu", weights_only=True)
    model.backbone.load_state_dict(state["backbone"], strict=True)
    model.head.load_state_dict(state["head"], strict=True)
    model.eval().to(dev)
    if model.backbone_has_bn:
        # a ResNet's convolutions run in the compute type and its
        # BatchNorm parameters and statistics stay f32, as the JAX serving
        # keeps every 1-D leaf and as Trainer casts; channels-last on the
        # card (cuDNN's layout)
        for m in model.backbone.modules():
            if isinstance(m, nn.Conv2d):
                m.to(dtype=dtype)
        if dev.type == "cuda":
            model.backbone.to(memory_format=torch.channels_last)
    else:
        # a ViT block_impl that cannot run raises here, not at a request
        model.backbone.resolved_impl(dev)
    baked = int(meta["batch_size"])

    def fn(images_u8):
        with torch.inference_mode():
            return _over_chunks(model.serve, baked,
                                (_coerce(images_u8, torch.uint8, dev),))

    def gt(images_u8, verb_ids):
        with torch.inference_mode():
            return _over_chunks(model.serve_gt, baked,
                                (_coerce(images_u8, torch.uint8, dev),
                                 _coerce(verb_ids, torch.long, dev)))

    fn.gt = gt
    fn.meta = meta
    fn.batch_size = baked
    fn.model = model
    return fn


def _over_chunks(call, baked: int, args):
    """Serve any leading batch size through the baked batch: split into
    baked-size chunks, zero-pad the last one (zero images are safe with
    eval-mode BN), and slice the concatenated outputs back to B.  An
    exactly baked batch is one call."""
    sizes = {a.shape[0] for a in args}
    if len(sizes) != 1:
        raise ValueError(f"argument batch sizes disagree: "
                         f"{[a.shape[0] for a in args]}")
    b = args[0].shape[0]
    if b == baked:
        return call(*args)
    if b == 0:
        raise ValueError("empty batch")
    outs = []
    for lo in range(0, b, baked):
        chunk = tuple(a[lo:lo + baked] for a in args)
        short = baked - chunk[0].shape[0]
        if short:
            chunk = tuple(torch.cat([c, c.new_zeros((short,) + c.shape[1:])])
                          for c in chunk)
        res = call(*chunk)
        outs.append(res if isinstance(res, tuple) else (res,))
    cat = tuple(torch.cat([o[i] for o in outs])[:b]
                for i in range(len(outs[0])))
    return cat if len(cat) > 1 else cat[0]


def _coerce(x, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """Host inputs (numpy, lists) or tensors → ``dtype`` on ``device``."""
    if not torch.is_tensor(x):
        x = torch.from_numpy(np.ascontiguousarray(np.asarray(x)))
    return x.to(device=device, dtype=dtype)
