"""Backbones by name: the ResNets of ``models/resnet.py`` and the ViTs of
``models/vit.py``, as the JAX trainer's ``build_backbone`` dispatches
them, and the port's Swins of ``models/swin.py``."""

from __future__ import annotations

import torch
from torch import nn

from situation_recognition_tpu_torch.models.resnet import (
    STAGE_SIZES, build_resnet)
from situation_recognition_tpu_torch.models.swin import (
    SWIN_CONFIGS, SWIN_WIDTHS, build_swin)
from situation_recognition_tpu_torch.models.vit import (
    VIT_CONFIGS, VIT_WIDTHS, build_vit)

BACKBONES = tuple(STAGE_SIZES) + tuple(VIT_CONFIGS) + tuple(SWIN_CONFIGS)


def build_backbone(name: str, hidden: int, image_size: int = 224,
                   dtype: torch.dtype = torch.float32,
                   block_impl: str = "auto",
                   remat: bool = False) -> tuple[nn.Module, bool]:
    """name → (module, whether it has BatchNorm).  The head's hidden size
    must equal the backbone's feature width (a ResNet's base width · 32 for
    Bottlenecks, · 8 for BasicBlocks; a ViT's width; a Swin's last stage's,
    8·C for four stages).  A ViT keeps f32 parameters and computes in
    ``dtype``, its position embedding sized for ``image_size`` and its
    blocks run as ``block_impl`` says; a Swin keeps f32 parameters and
    computes in ``dtype``, its windows laid out for ``image_size``; a
    ResNet computes in its input's type.  ``remat`` checkpoints each
    residual, encoder or Swin block of a differentiated call
    (fine-tuning)."""
    if name in STAGE_SIZES:
        return build_resnet(name, hidden, remat), True
    if name in VIT_CONFIGS:
        if hidden != VIT_WIDTHS[name]:
            raise ValueError(f"{name} produces {VIT_WIDTHS[name]}-d "
                             f"features; set hidden={VIT_WIDTHS[name]} "
                             f"(got {hidden})")
        return build_vit(name, image_size, dtype, block_impl, remat), False
    if name in SWIN_CONFIGS:
        if hidden != SWIN_WIDTHS[name]:
            raise ValueError(f"{name} produces {SWIN_WIDTHS[name]}-d "
                             f"features; set hidden={SWIN_WIDTHS[name]} "
                             f"(got {hidden})")
        return build_swin(name, image_size, dtype, remat=remat), False
    raise ValueError(f"unknown backbone {name!r}; one of {list(BACKBONES)}")
