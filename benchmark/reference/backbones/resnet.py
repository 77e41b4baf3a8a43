"""ResNet v1.5 of Bottleneck blocks in plain PyTorch, in torchvision's
state-dict names (``backbone.kind`` ``resnet``; shape keys
``stage_sizes``, ``base_width``, ``branch_bn_scale`` and ``bn``)."""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from reference.nets import Precision


def leaves(cfg: dict):
    """(name, shape, init) of the backbone: convolutions normal with std
    sqrt(2 / fan_out), BN scale 1 and shift 0, running mean 0 and
    variance 1; the last BN of each residual branch (``bn3``) scaled
    ``branch_bn_scale`` (1 where the configuration gives none)."""
    b = cfg["backbone"]
    base, branch_scale = b["base_width"], b.get("branch_bn_scale", 1.0)
    out = []

    def conv(name, cout, cin, k):
        out.append((name + ".weight", (cout, cin, k, k),
                    ("normal", math.sqrt(2.0 / (cout * k * k)))))

    def bn(name, c, scale=1.0):
        out.extend([(name + ".weight", (c,), ("const", scale)),
                    (name + ".bias", (c,), ("const", 0.0)),
                    (name + ".running_mean", (c,), ("const", 0.0)),
                    (name + ".running_var", (c,), ("const", 1.0)),
                    (name + ".num_batches_tracked", (), ("count", 0))])

    conv("conv1", base, 3, 7)
    bn("bn1", base)
    cin, planes = base, base
    for i, blocks in enumerate(b["stage_sizes"]):
        for j in range(blocks):
            pre = f"layer{i + 1}.{j}."
            conv(pre + "conv1", planes, cin, 1)
            bn(pre + "bn1", planes)
            conv(pre + "conv2", planes, planes, 3)
            bn(pre + "bn2", planes)
            conv(pre + "conv3", planes * 4, planes, 1)
            bn(pre + "bn3", planes * 4, branch_scale)
            if j == 0:
                conv(pre + "downsample.0", planes * 4, cin, 1)
                bn(pre + "downsample.1", planes * 4)
            cin = planes * 4
        planes *= 2
    return out


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


def forward(sd: dict, x_nhwc: torch.Tensor, stages, p: Precision,
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


def features(cfg: dict, sd: dict, x_nhwc: torch.Tensor, p: Precision):
    """The pooled features (B, 32·base width) of a transformed batch, with
    batch norm in the configuration's ``bn`` mode (``train`` where it
    gives none)."""
    b = cfg["backbone"]
    return forward(sd, x_nhwc, b["stage_sizes"], p, bn=b.get("bn", "train"))
