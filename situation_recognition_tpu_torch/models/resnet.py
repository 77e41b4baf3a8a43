"""ResNet v1.5 backbones in PyTorch, returning pooled features.

Port of ``situation_recognition_tpu/models/resnet.py``: torchvision's
Bottleneck (expansion 4, stride on the 3x3 conv, BN eps 1e-5; resnet50,
101 and 152) and BasicBlock (two 3x3 convs, expansion 1, stride on the
first; resnet18 and 34) with no fc, so the output is the pooled feature the
FCGGNN head takes: (B, base_width*32) of a Bottleneck stack, (B,
base_width*8) of a BasicBlock stack.  Module names are torchvision's
(``layer3.17.conv2``, ``downsample.0/1``), so a torchvision or reference
state dict loads with ``strict=True`` and the JAX trees convert
mechanically (``convert.py``).

The public boundary is NHWC, as in the JAX package; inside, the NHWC
tensor is viewed as NCHW in channels-last memory, which is also the layout
cuDNN prefers.  In eval mode BN normalises with the running statistics
(``nn.BatchNorm2d``'s eval path); in train mode it is flax's BatchNorm
(``BatchNorm`` below), which is not ``nn.BatchNorm2d``'s.  Convolutions
cast their weights to the input's type at use, as flax's ``Conv(dtype=)``
does, so a fine-tuned backbone keeps f32 weights and computes in bf16.

In a world of processes (``parallel/``) train-mode BN takes its statistics
over the global batch, as JAX's jit step does over its mesh (flax's E[x²] -
E[x]² over every shard): each BatchNorm's ``stats_group`` is the data
axis's process group, and the layer all-reduces this rank's per-channel
E[x] and E[x²] (one vector of 2C floats; the shards are of equal size),
normalises with the global statistics in one pass, and in its backward
all-reduces the two per-channel sums Σdy and Σdy·(x - mean) as
SyncBatchNorm does (``_GlobalBatchNorm``).  On the card both passes run on
SyncBatchNorm's primitives (``forward_cuda``, ``backward_cuda``: no f32
copy of x or dy); the CPU runs the same arithmetic in plain torch ops on
the f32 view (``forward_shared``, ``backward_shared``), the form the card
tests hold the card's against.

``remat`` (``--remat_backbone``, JAX ``ResNet.remat``) checkpoints each
residual block of a differentiated call with ``torch.utils.checkpoint``: the
backward keeps only the block inputs and runs each block's forward again.
The recomputed forward does not update the BN running statistics a second
time (``_stats_frozen``), as flax's ``nn.remat`` updates them once.
"""

from __future__ import annotations

import contextlib
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from situation_recognition_tpu_torch.parallel import distributed

#: stage sizes by backbone name (``mini`` is the test-sized stack)
STAGE_SIZES = {
    "resnet18": (2, 2, 2, 2),
    "resnet34": (3, 4, 6, 3),
    "resnet50": (3, 4, 6, 3),
    "resnet101": (3, 4, 23, 3),
    "resnet152": (3, 8, 36, 3),
    "mini": (1, 1, 1, 1),
}
#: the stacks of BasicBlocks (the others are of Bottlenecks)
BASIC_STACKS = ("resnet18", "resnet34")


def _reduce_moments(stats: torch.Tensor, group):
    """This rank's per-channel (E[x], E[x²]), one vector of 2C floats →
    the group's (mean, var) by one all-reduce (the shards are of equal
    size), var = E[x²] - E[x]² floored at 0 (flax's form)."""
    distributed.all_reduce(stats, group, "bn")
    stats.div_(distributed.group_size(group))
    mean, ex2 = stats.chunk(2)
    return mean, torch.addcmul(ex2, mean, mean, value=-1).clamp_min_(0.0)


def forward_shared(x, weight, bias, eps: float, group):
    """Train-mode BN over every rank of ``group`` in plain torch ops, on
    any device (the CPU's form, which the card's is held against): the
    moments of x's f32 view, then ``F.batch_norm`` with the global
    statistics → (y, mean, var)."""
    xf = x.float()
    mean, var = _reduce_moments(torch.cat(
        [xf.mean(dim=(0, 2, 3)), (xf * xf).mean(dim=(0, 2, 3))]), group)
    return (F.batch_norm(x, mean, var, weight, bias, False, 0.0, eps),
            mean, var)


def forward_cuda(x, weight, bias, eps: float, group):
    """``forward_shared`` on SyncBatchNorm's primitives: the local moments
    from ``torch.batch_norm_stats`` (one read of x; E[x²] from its mean
    and 1/sqrt(var + eps)), ``torch.batch_norm_elemt`` with the global
    statistics → (y, mean, var)."""
    mean, invstd = torch.batch_norm_stats(x, eps)
    mean, var = _reduce_moments(torch.cat(
        [mean, torch.addcmul(invstd.pow(-2).sub_(eps), mean, mean)]), group)
    return (torch.batch_norm_elemt(x, weight, bias, mean,
                                   var.add(eps).rsqrt_(), eps), mean, var)


def backward_shared(dy, x, weight, mean, var, eps: float, group,
                    needs: tuple) -> tuple:
    """The backward of ``forward_shared`` for (x, weight, bias) where
    ``needs`` says: the scale's and shift's gradients this rank's (the
    trainer's gradient all-reduce sums them), dx from the group's (Σdy,
    Σdy·(x - mean)), one all-reduce, as SyncBatchNorm takes it."""
    c = x.shape[1]
    shape = (1, c, 1, 1)
    invstd = (var + eps).rsqrt()
    dyf = dy.float()
    xmu = x.float() - mean.view(shape)
    sums = torch.cat([dyf.sum(dim=(0, 2, 3)),
                      (dyf * xmu).sum(dim=(0, 2, 3))])
    grad_w = (sums[c:] * invstd).to(weight.dtype) if needs[1] else None
    # copied: the all-reduce below sums ``sums`` in place
    grad_b = sums[:c].to(weight.dtype, copy=True) if needs[2] else None
    dx = None
    if needs[0]:
        distributed.all_reduce(sums, group, "bn")
        n = x.numel() // c * distributed.group_size(group)
        mean_dy = (sums[:c] / n).view(shape)
        mean_dy_xmu = (sums[c:] / n).view(shape)
        istd = invstd.view(shape)
        dx = ((dyf - mean_dy - xmu * istd * istd * mean_dy_xmu)
              * istd * weight.float().view(shape)).to(x.dtype)
    return dx, grad_w, grad_b


def backward_cuda(dy, x, weight, mean, var, eps: float, group,
                  needs: tuple) -> tuple:
    """``backward_shared`` on SyncBatchNorm's primitives:
    ``torch.batch_norm_backward_reduce`` (the local sums and the scale's
    and shift's gradients, no f32 copy of x or dy), one all-reduce of the
    sums, ``torch.batch_norm_backward_elemt``."""
    fmt = (torch.channels_last
           if x.is_contiguous(memory_format=torch.channels_last)
           else torch.contiguous_format)
    dy = dy.contiguous(memory_format=fmt)
    invstd = (var + eps).rsqrt()
    sum_dy, sum_dy_xmu, grad_w, grad_b = torch.batch_norm_backward_reduce(
        dy, x, mean, invstd, weight, *needs)
    dx = None
    if needs[0]:
        sums = distributed.all_reduce(torch.cat([sum_dy, sum_dy_xmu]),
                                      group, "bn")
        count = torch.full(
            (1,), x.numel() // x.shape[1] * distributed.group_size(group),
            dtype=torch.int32, device=x.device)
        dx = torch.batch_norm_backward_elemt(dy, x, mean, invstd, weight,
                                             *sums.chunk(2), count)
    return dx, grad_w, grad_b


def _forms(x):
    """(forward, backward) of the global-statistics BN for x's device."""
    return ((forward_cuda, backward_cuda) if x.is_cuda
            else (forward_shared, backward_shared))


class _GlobalBatchNorm(torch.autograd.Function):
    """The global-statistics BN of x's device (``_forms``) under autograd
    → (y, mean, var)."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, group):
        y, mean, var = _forms(x)[0](x, weight, bias, eps, group)
        ctx.save_for_backward(x, weight, mean, var)
        ctx.group, ctx.eps = group, eps
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _mean, _var):
        x, weight, mean, var = ctx.saved_tensors
        return _forms(x)[1](dy, x, weight, mean, var, ctx.eps, ctx.group,
                            ctx.needs_input_grad[:3]) + (None, None)


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
    #: the process group whose ranks' batches give the train-mode
    #: statistics (global BN), or None for this batch's own
    stats_group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        group = self.stats_group
        if group is None:
            y, mean, invstd = torch.native_batch_norm(
                x, self.weight, self.bias, None, None, True, 0.0, self.eps)
        elif torch.is_grad_enabled() and (x.requires_grad
                                          or self.weight.requires_grad):
            y, mean, var = _GlobalBatchNorm.apply(
                x, self.weight, self.bias, self.eps, group)
        else:
            y, mean, var = _forms(x)[0](x, self.weight, self.bias,
                                        self.eps, group)
        if not self.update_stats:
            return y
        with torch.no_grad():
            m = self.momentum
            if group is None:
                var = torch.clamp_min(torch.reciprocal(invstd * invstd)
                                      - self.eps, 0.0)
                self.running_mean.copy_((1 - m) * self.running_mean
                                        + m * mean)
                self.running_var.copy_((1 - m) * self.running_var + m * var)
            else:
                torch._foreach_lerp_([self.running_mean, self.running_var],
                                     [mean, var], m)
            self.num_batches_tracked.add_(1)
        return y


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` (no bias) that casts its weight to the input's type
    at use: a no-op where the weights were cast already (the frozen
    trainer, serving), f32 master weights under fine-tuning."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, self.weight.to(x.dtype), None)


def set_stats_group(module: nn.Module, group) -> None:
    """Every ``BatchNorm`` of ``module`` takes its train-mode statistics
    over the ranks of ``group`` (None: its own batch's)."""
    for m in module.modules():
        if isinstance(m, BatchNorm):
            m.stats_group = group


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


class BasicBlock(nn.Module):
    """torchvision-style basic block (two 3x3 convs, expansion 1, stride on
    the first), the resnet18/34 block."""

    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: nn.Module | None = None):
        super().__init__()
        self.conv1 = Conv2d(inplanes, planes, 3, stride=stride, padding=1,
                            bias=False)
        self.bn1 = BatchNorm(planes, eps=1e-5)
        self.conv2 = Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = BatchNorm(planes, eps=1e-5)
        self.downsample = downsample

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(y + residual)


class ResNet(nn.Module):
    """ResNet v1.5 → pooled features (B, out_features): base_width*32 of
    Bottleneck stacks, base_width*8 of BasicBlock stacks (``basic``).

    ``forward`` takes NHWC images, like the JAX module; ``remat``
    checkpoints each residual block of a differentiated call."""

    def __init__(self, stage_sizes: Sequence[int], base_width: int = 64,
                 remat: bool = False, basic: bool = False):
        super().__init__()
        self.stage_sizes = tuple(stage_sizes)
        self.remat = remat
        self.conv1 = Conv2d(3, base_width, 7, stride=2, padding=3,
                            bias=False)
        self.bn1 = BatchNorm(base_width, eps=1e-5)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        block = BasicBlock if basic else Bottleneck
        inplanes, planes = base_width, base_width
        for i, blocks in enumerate(self.stage_sizes):
            stride = 1 if i == 0 else 2
            out = planes * block.expansion
            # torchvision's rule: a downsample where the stride or the
            # channel count changes — every stage's first Bottleneck, but
            # not the first stage's BasicBlock (64 → 64 at stride 1)
            downsample = None
            if stride != 1 or inplanes != out:
                downsample = nn.Sequential(
                    Conv2d(inplanes, out, 1, stride=stride, bias=False),
                    BatchNorm(out, eps=1e-5))
            layers = [block(inplanes, planes, stride, downsample)]
            inplanes = out
            layers += [block(inplanes, planes) for _ in range(1, blocks)]
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
    size as the JAX trainer does: ``hidden = base_width * 32`` for a
    Bottleneck stack, ``base_width * 8`` for a BasicBlock stack."""
    if name not in STAGE_SIZES:
        raise ValueError(f"unknown backbone {name!r}; one of "
                         f"{sorted(STAGE_SIZES)}")
    basic = name in BASIC_STACKS
    mult = 8 if basic else 32
    if hidden % mult != 0:
        raise ValueError(f"hidden must be a multiple of {mult} for "
                         f"{name}")
    return ResNet(STAGE_SIZES[name], base_width=hidden // mult, remat=remat,
                  basic=basic)


def resnet152() -> ResNet:
    return ResNet(STAGE_SIZES["resnet152"])


def mini(hidden: int = 64) -> ResNet:
    return build_resnet("mini", hidden)
