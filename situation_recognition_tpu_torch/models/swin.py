"""Swin Transformer backbones in PyTorch, returning pooled features.

The port's own model (the JAX package has no Swin): microsoft/
Swin-Transformer's ``SwinTransformer`` (arXiv:2103.14030) without its
classifier, whose features, the final LayerNorm's tokens averaged, feed
the FCGGNN head (hidden = the last stage's width, 8·C for four stages).
A patch embedding (a patch×patch convolution and a LayerNorm), then
stages of blocks at widths C, 2C, 4C, ..., each stage but the last ending
in a patch merging (2×2 neighbours concatenated, LayerNorm(4C), a linear
4C → 2C without bias).  A block is pre-LN windowed attention and an MLP
(ratio 4, exact GELU), each with its residual; every second block of a
stage shifts its windows by half a window (a cyclic roll, with
``ops.swin.shift_mask``'s masks), except in a stage whose map is no
larger than the window: its window is the whole map and it never shifts
(the published rule).  LayerNorm eps 1e-5; no absolute position
embedding; stochastic depth and dropout are left out (they are off at
evaluation, and the benchmark's configuration states their absence).

Module names are the published ones, so that a checkpoint's state dict
loads as it is: ``patch_embed.proj``, ``patch_embed.norm``,
``layers.{i}.blocks.{j}.{norm1, attn.qkv, attn.proj,
attn.relative_position_bias_table, norm2, mlp.fc1, mlp.fc2}``,
``layers.{i}.downsample.{norm, reduction}``, ``norm``.  One departure:
``relative_position_index`` and the shifted blocks' masks are
non-persistent buffers built in ``__init__`` (the published module keeps
the index in its state dict), so the state dict holds the parameters
only.

Parameters stay f32 and are cast to the compute type at use, as in
``models/vit.py``: the LayerNorms in f32 through ``ops.layernorm.
layer_norm`` (on the card the hand pair, on the CPU ``ops.vit.ln_f32``)
rounded to the compute type once (the final norm kept in f32 for the
mean over the tokens), the projections and the MLP in the compute type under
autograd, fc1's bias and the GELU by ``ops.gelu.bias_gelu`` (on the card
the hand pair, on the CPU ``ops.vit.gelu`` after the bias add), the
relative-position bias gathered from its table in f32 (``F.embedding``,
differentiable).  The attention core is the window-attention pair of
``ops/swin_kernel.py``: a differentiated call through ``WindowAttention``
(the forward kernel, then the backward kernel with the bias's gradient),
any other through the forward kernel alone; on CPU tensors the wrappers
run the twins of ``ops/swin.py``, at any float type, and on the card a
type other than bf16 raises.  ``remat`` checkpoints each block of a differentiated call
(non-reentrant), so that only the block inputs are kept for the backward
and each block's forward, the attention core's included, runs again
inside it.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from situation_recognition_tpu_torch.ops import swin_kernel
from situation_recognition_tpu_torch.ops.gelu import bias_gelu
from situation_recognition_tpu_torch.ops.layernorm import layer_norm
from situation_recognition_tpu_torch.ops.swin import (
    relative_position_index, shift_mask, window_partition, window_reverse)

EPS = 1e-5


class SwinConfig(NamedTuple):
    patch: int
    embed: int          # C, the first stage's width
    depths: tuple       # blocks a stage
    heads: tuple        # heads a stage
    window: int
    mlp_ratio: int = 4


#: by backbone name: Swin-L (``swin_large_patch4_window7_224``) and a CPU
#: preset whose 64² crop gives maps of 16, 8 and 4 (shifted blocks over
#: several windows, and a last stage that does not shift)
SWIN_CONFIGS = {
    "swin_l": SwinConfig(4, 192, (2, 2, 18, 2), (6, 12, 24, 48), 7),
    "swin_micro": SwinConfig(4, 32, (2, 2, 2), (1, 2, 4), 4),
}
#: feature width by backbone name: the last stage's, C·2^(stages − 1)
SWIN_WIDTHS = {name: c.embed * 2 ** (len(c.depths) - 1)
               for name, c in SWIN_CONFIGS.items()}


class PatchEmbed(nn.Module):
    def __init__(self, patch: int, embed: int):
        super().__init__()
        self.proj = nn.Conv2d(3, embed, patch, stride=patch)
        self.norm = nn.LayerNorm(embed, eps=EPS)


class Attention(nn.Module):
    """The parameters of the published ``WindowAttention``, and its index
    of the bias table (a non-persistent buffer)."""

    def __init__(self, dim: int, heads: int, window: int):
        super().__init__()
        self.heads, self.window = heads, window
        self.relative_position_bias_table = nn.Parameter(
            torch.empty((2 * window - 1) ** 2, heads))
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.register_buffer("relative_position_index",
                             relative_position_index(window),
                             persistent=False)

    def bias(self) -> torch.Tensor:
        """(heads, N, N) f32: the table gathered by the index."""
        n = self.window ** 2
        b = F.embedding(self.relative_position_index.view(-1),
                        self.relative_position_bias_table)
        return b.view(n, n, self.heads).permute(2, 0, 1).contiguous()


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)


class Block(nn.Module):
    """One Swin block on a map of ``resolution``² tokens: windows of
    ``window``, shifted by ``shift`` (0: not shifted), the mask of a
    shifted block a non-persistent buffer."""

    def __init__(self, dim: int, heads: int, resolution: int, window: int,
                 shift: int, mlp_ratio: int):
        super().__init__()
        self.resolution, self.window, self.shift = resolution, window, shift
        self.norm1 = nn.LayerNorm(dim, eps=EPS)
        self.attn = Attention(dim, heads, window)
        self.norm2 = nn.LayerNorm(dim, eps=EPS)
        self.mlp = Mlp(dim, dim * mlp_ratio)
        self.register_buffer(
            "attn_mask", shift_mask(resolution, resolution, window, shift)
            if shift else None, persistent=False)


class PatchMerging(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim, eps=EPS)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)


class BasicLayer(nn.Module):
    def __init__(self, blocks, downsample: Optional[PatchMerging]):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.downsample = downsample


def _lin(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    dt = x.dtype
    return F.linear(x, layer.weight.to(dt),
                    None if layer.bias is None else layer.bias.to(dt))


def _block(x: torch.Tensor, blk: Block) -> torch.Tensor:
    """One block on x (B, H, W, C) in its type → (B, H, W, C)."""
    dt = x.dtype
    _, h, w, _ = x.shape
    ws, shift, heads = blk.window, blk.shift, blk.attn.heads
    y = layer_norm(x, blk.norm1.weight, blk.norm1.bias, EPS, dt)
    if shift:
        y = torch.roll(y, (-shift, -shift), (1, 2))
    qkv = _lin(window_partition(y, ws), blk.attn.qkv)
    ctx = swin_kernel.window_attention(qkv, blk.attn.bias(), blk.attn_mask,
                                       heads, ws * ws)
    y = window_reverse(_lin(ctx, blk.attn.proj), ws, h, w)
    if shift:
        y = torch.roll(y, (shift, shift), (1, 2))
    x = x + y
    y = layer_norm(x, blk.norm2.weight, blk.norm2.bias, EPS, dt)
    fc1 = blk.mlp.fc1
    h = bias_gelu(F.linear(y, fc1.weight.to(dt)), fc1.bias, False)
    return x + _lin(h, blk.mlp.fc2)


def _merge(x: torch.Tensor, m: PatchMerging) -> torch.Tensor:
    """Patch merging: x (B, H, W, C) → (B, H/2, W/2, 2C), the published
    order of the 2×2 neighbours (x0 (0, 0), x1 (1, 0), x2 (0, 1), x3 (1,
    1))."""
    dt = x.dtype
    x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2],
                   x[:, 1::2, 1::2]], dim=-1)
    return _lin(layer_norm(x, m.norm.weight, m.norm.bias, EPS, dt),
                m.reduction)


class SwinTransformer(nn.Module):
    """Swin → the final LayerNorm's tokens averaged, (B, width).

    ``forward`` takes NHWC images of ``image_size`` in the compute type
    ``dtype`` and returns the features in that type."""

    def __init__(self, cfg: SwinConfig, image_size: int = 224,
                 dtype: torch.dtype = torch.float32, remat: bool = False):
        super().__init__()
        stages = len(cfg.depths)
        if len(cfg.heads) != stages:
            raise ValueError(f"{stages} depths but {len(cfg.heads)} heads")
        if image_size % (cfg.patch * 2 ** (stages - 1)):
            raise ValueError(f"image_size {image_size} is not a multiple of "
                             f"the patch {cfg.patch} times "
                             f"{2 ** (stages - 1)} (the patch mergings)")
        self.cfg, self.image_size, self.dtype = cfg, image_size, dtype
        self.remat = remat
        self.width = cfg.embed * 2 ** (stages - 1)
        self.patch_embed = PatchEmbed(cfg.patch, cfg.embed)
        layers = []
        res, dim = image_size // cfg.patch, cfg.embed
        for i in range(stages):
            window, shift = cfg.window, cfg.window // 2
            if res <= window:
                window, shift = res, 0
            if res % window:
                raise ValueError(f"stage {i}'s map of {res}² is not whole "
                                 f"windows of {window}² (image_size "
                                 f"{image_size})")
            blocks = [Block(dim, cfg.heads[i], res, window,
                            shift if j % 2 else 0, cfg.mlp_ratio)
                      for j in range(cfg.depths[i])]
            down = PatchMerging(dim) if i < stages - 1 else None
            layers.append(BasicLayer(blocks, down))
            if down is not None:
                res, dim = res // 2, dim * 2
        self.layers = nn.ModuleList(layers)
        self.norm = nn.LayerNorm(self.width, eps=EPS)

    def _differentiated(self, x: torch.Tensor) -> bool:
        return torch.is_grad_enabled() and (x.requires_grad or any(
            p.requires_grad for p in self.parameters()))

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images (B, H, W, 3) → features (B, width) in the compute
        type."""
        dt = self.dtype
        pe = self.patch_embed
        x = F.conv2d(images.to(dt).permute(0, 3, 1, 2),
                     pe.proj.weight.to(dt), pe.proj.bias.to(dt),
                     stride=self.cfg.patch)
        x = x.permute(0, 2, 3, 1).contiguous()            # (B, H, W, C)
        if x.shape[1] != self.image_size // self.cfg.patch:
            raise ValueError(f"images of {images.shape[1]}² for a model of "
                             f"{self.image_size}²")
        x = layer_norm(x, pe.norm.weight, pe.norm.bias, EPS, dt)
        remat = self.remat and self._differentiated(x)
        for layer in self.layers:
            for blk in layer.blocks:
                if remat:
                    x = checkpoint(_block, x, blk, use_reentrant=False)
                else:
                    x = _block(x, blk)
            if layer.downsample is not None:
                x = _merge(x, layer.downsample)
        x = layer_norm(x, self.norm.weight, self.norm.bias, EPS,
                       torch.float32)
        return x.mean(dim=(1, 2)).to(dt)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Random weights from ``generator``: normal(0.02) linears and
        bias tables (the published init, untruncated), zero linear
        biases, LayerNorms 1 and 0, and the patch convolution uniform
        ±1/sqrt(fan_in) (PyTorch's default, as published)."""
        def normal(t):
            t.copy_(torch.randn(t.shape, generator=generator) * 0.02)

        with torch.no_grad():
            fan = 3 * self.cfg.patch ** 2
            for t in (self.patch_embed.proj.weight,
                      self.patch_embed.proj.bias):
                t.copy_((torch.rand(t.shape, generator=generator) * 2 - 1)
                        * fan ** -0.5)
            for m in self.modules():
                if isinstance(m, nn.LayerNorm):
                    m.reset_parameters()
                elif isinstance(m, nn.Linear):
                    normal(m.weight)
                    if m.bias is not None:
                        m.bias.zero_()
                elif isinstance(m, Attention):
                    normal(m.relative_position_bias_table)


def build_swin(name: str, image_size: int = 224,
               dtype: torch.dtype = torch.float32,
               remat: bool = False) -> SwinTransformer:
    """Backbone by name (``SWIN_CONFIGS``: ``swin_l`` and the test-sized
    ``swin_micro``) computing in ``dtype``, with its blocks checkpointed
    under autograd when ``remat``."""
    if name not in SWIN_CONFIGS:
        raise ValueError(f"unknown Swin {name!r}; one of "
                         f"{sorted(SWIN_CONFIGS)}")
    return SwinTransformer(SWIN_CONFIGS[name], image_size, dtype, remat)
