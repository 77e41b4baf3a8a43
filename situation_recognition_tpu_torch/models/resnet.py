"""ResNet v1.5 backbones in PyTorch, returning pooled features.

Port of ``situation_recognition_tpu/models/resnet.py``: torchvision's
Bottleneck (expansion 4, stride on the 3x3 conv, BN eps 1e-5) with no fc,
so the output is the (B, base_width*32) pooled feature the FCGGNN head
takes.  Module names are torchvision's (``layer3.17.conv2``,
``downsample.0/1``), so a torchvision or reference state dict loads with
``strict=True`` and the JAX trees convert mechanically (``convert.py``).

The public boundary is NHWC, as in the JAX package; inside, the NHWC
tensor is viewed as NCHW in channels-last memory, which is also the layout
cuDNN prefers.  In eval mode BN normalises with the running statistics
(``nn.BatchNorm2d``'s eval path); in train mode it is flax's BatchNorm
(``BatchNorm`` below), which is not ``nn.BatchNorm2d``'s.  Convolutions
cast their weights to the input's type at use, as flax's ``Conv(dtype=)``
does, so a fine-tuned backbone keeps f32 weights and computes in bf16.

``remat`` (``--remat_backbone``, JAX ``ResNet.remat``) checkpoints each
bottleneck of a differentiated call with ``torch.utils.checkpoint``: the
backward keeps only the block inputs and runs each block's forward again.
The recomputed forward does not update the BN running statistics a second
time (``_stats_frozen``), as flax's ``nn.remat`` updates them once.
"""

from __future__ import annotations

import contextlib
from typing import Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

#: stage sizes by backbone name (``mini`` is the test-sized stack)
STAGE_SIZES = {
    "resnet152": (3, 8, 36, 3),
    "mini": (1, 1, 1, 1),
}


class BatchNorm(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose train mode is flax's ``nn.BatchNorm``
    (momentum 0.9, the JAX package's ``models/resnet.py``):

    * batch statistics in f32 over (N, H, W), with the biased variance, and
      the input normalised with them in f32 and cast back to its type —
      one fused call of torch's batch-norm kernel, which also returns the
      statistics (flax takes the variance as E[x²] - E[x]², torch by a
      running update: they differ by f32 rounding);
    * running statistics ``(1 - momentum) * running + momentum * batch``
      with torch's ``momentum`` = 0.1 = 1 - flax's 0.9, for the mean and
      the *biased* variance (``nn.BatchNorm2d`` would blend in the
      unbiased one).

    Eval mode is ``nn.BatchNorm2d``'s, unchanged.  In train mode the
    output is differentiable in x and in the scale and shift (fine-tuning);
    the statistics are updated without a gradient, and not at all while
    ``update_stats`` is false (a checkpointed block's recomputation)."""

    update_stats = True

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        y, mean, invstd = torch.native_batch_norm(
            x, self.weight, self.bias, None, None, True, 0.0, self.eps)
        if not self.update_stats:
            return y
        with torch.no_grad():
            var = torch.clamp_min(torch.reciprocal(invstd * invstd)
                                  - self.eps, 0.0)
            m = self.momentum
            self.running_mean.copy_((1 - m) * self.running_mean + m * mean)
            self.running_var.copy_((1 - m) * self.running_var + m * var)
            self.num_batches_tracked.add_(1)
        return y


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` (no bias) that casts its weight to the input's type
    at use: a no-op where the weights were cast already (the frozen
    trainer, serving), f32 master weights under fine-tuning."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, self.weight.to(x.dtype), None)


@contextlib.contextmanager
def _stats_frozen(module: nn.Module):
    """BN running statistics of ``module`` left as they are inside."""
    bns = [m for m in module.modules() if isinstance(m, BatchNorm)]
    for bn in bns:
        bn.update_stats = False
    try:
        yield
    finally:
        for bn in bns:
            bn.update_stats = True


def _checkpointed(block: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``block(x)`` under ``torch.utils.checkpoint``, with its recomputation
    leaving the BN statistics alone."""
    return checkpoint(block, x, use_reentrant=False, context_fn=lambda: (
        contextlib.nullcontext(), _stats_frozen(block)))


class Bottleneck(nn.Module):
    """torchvision-style bottleneck block (expansion 4, stride on the 3x3)."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: nn.Module | None = None):
        super().__init__()
        self.conv1 = Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = BatchNorm(planes, eps=1e-5)
        self.conv2 = Conv2d(planes, planes, 3, stride=stride, padding=1,
                            bias=False)
        self.bn2 = BatchNorm(planes, eps=1e-5)
        self.conv3 = Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = BatchNorm(planes * 4, eps=1e-5)
        self.downsample = downsample

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(y + residual)


class ResNet(nn.Module):
    """ResNet v1.5 (Bottleneck stacks) → pooled features (B, base_width*32).

    ``forward`` takes NHWC images, like the JAX module; ``remat``
    checkpoints each bottleneck of a differentiated call."""

    def __init__(self, stage_sizes: Sequence[int], base_width: int = 64,
                 remat: bool = False):
        super().__init__()
        self.stage_sizes = tuple(stage_sizes)
        self.remat = remat
        self.conv1 = Conv2d(3, base_width, 7, stride=2, padding=3,
                            bias=False)
        self.bn1 = BatchNorm(base_width, eps=1e-5)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        inplanes, planes = base_width, base_width
        for i, blocks in enumerate(self.stage_sizes):
            stride = 1 if i == 0 else 2
            # every stage's first block changes the channel count
            downsample = nn.Sequential(
                Conv2d(inplanes, planes * 4, 1, stride=stride, bias=False),
                BatchNorm(planes * 4, eps=1e-5))
            layers = [Bottleneck(inplanes, planes, stride, downsample)]
            inplanes = planes * 4
            layers += [Bottleneck(inplanes, planes)
                       for _ in range(1, blocks)]
            setattr(self, f"layer{i + 1}", nn.Sequential(*layers))
            planes *= 2
        self.out_features = inplanes

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, H, W, 3) → (B, out_features)."""
        x = x.permute(0, 3, 1, 2)             # NCHW view, channels-last
        if x.device.type == "cpu":
            # torch's CPU convolution backward on channels-last inputs or
            # weights crashes (segfaults, heap corruption) at some widths;
            # the CPU computes in contiguous NCHW
            x = x.contiguous()
        x = self.maxpool(torch.relu(self.bn1(self.conv1(x))))
        remat = self.remat and torch.is_grad_enabled() and any(
            p.requires_grad for p in self.parameters())
        for i in range(1, len(self.stage_sizes) + 1):
            for block in getattr(self, f"layer{i}"):
                x = _checkpointed(block, x) if remat else block(x)
        return x.mean(dim=(2, 3))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Random weights from ``generator``: torchvision's init (conv
        weights normal with std sqrt(2 / fan_out), BN scale 1 and shift
        0, running mean 0 and variance 1)."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.Conv2d):
                    fan_out = m.out_channels * m.kernel_size[0] \
                        * m.kernel_size[1]
                    m.weight.copy_(torch.randn(m.weight.shape,
                                               generator=generator)
                                   * (2.0 / fan_out) ** 0.5)
                elif isinstance(m, nn.BatchNorm2d):
                    m.reset_parameters()


def build_resnet(name: str, hidden: int, remat: bool = False) -> ResNet:
    """Backbone by name, with the stem width tied to the head's hidden
    size (``hidden = base_width * 32``) as the JAX trainer does."""
    if name not in STAGE_SIZES:
        raise ValueError(f"unknown backbone {name!r}; one of "
                         f"{sorted(STAGE_SIZES)}")
    if hidden % 32 != 0:
        raise ValueError("hidden must be a multiple of 32 for ResNets")
    return ResNet(STAGE_SIZES[name], base_width=hidden // 32, remat=remat)


def resnet152() -> ResNet:
    return ResNet(STAGE_SIZES["resnet152"])


def mini(hidden: int = 64) -> ResNet:
    return build_resnet("mini", hidden)
