"""Backbones by name: the ResNets of ``models/resnet.py`` and the ViTs of
``models/vit.py``, as the JAX trainer's ``build_backbone`` dispatches
them."""

from __future__ import annotations

import torch
from torch import nn

from situation_recognition_tpu_torch.models.resnet import (
    STAGE_SIZES, build_resnet)
from situation_recognition_tpu_torch.models.vit import (
    VIT_CONFIGS, VIT_WIDTHS, build_vit)

BACKBONES = tuple(STAGE_SIZES) + tuple(VIT_CONFIGS)


def build_backbone(name: str, hidden: int, image_size: int = 224,
                   dtype: torch.dtype = torch.float32,
                   block_impl: str = "auto",
                   remat: bool = False) -> tuple[nn.Module, bool]:
    """name → (module, whether it has BatchNorm).  The head's hidden size
    must equal the backbone's feature width (a ResNet's base width · 32, a
    ViT's width).  A ViT keeps f32 parameters and computes in ``dtype``,
    its position embedding sized for ``image_size`` and its blocks run as
    ``block_impl`` says; a ResNet computes in its input's type.  ``remat``
    checkpoints each residual or encoder block of a differentiated call
    (fine-tuning)."""
    if name in STAGE_SIZES:
        return build_resnet(name, hidden, remat), True
    if name in VIT_CONFIGS:
        if hidden != VIT_WIDTHS[name]:
            raise ValueError(f"{name} produces {VIT_WIDTHS[name]}-d "
                             f"features; set hidden={VIT_WIDTHS[name]} "
                             f"(got {hidden})")
        return build_vit(name, image_size, dtype, block_impl, remat), False
    raise ValueError(f"unknown backbone {name!r}; one of {list(BACKBONES)}")
