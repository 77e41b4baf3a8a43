"""Vision Transformer backbones in PyTorch, returning pooled features.

Port of ``situation_recognition_tpu/models/vit.py``: a pre-LN ViT whose
features are the final-LayerNorm CLS token at full width, fed to the same
FCGGNN head (hidden = the width).  ``clip_variant=True`` is the CLIP visual
tower's three deltas: no patch bias, an ``ln_pre`` LayerNorm after the
position embedding, QuickGELU; and LayerNorm eps 1e-5 against torchvision's
1e-6.

Module names are torchvision's ``VisionTransformer``'s (``class_token``,
``conv_proj``, ``encoder.pos_embedding``,
``encoder.layers.encoder_layer_{i}.{ln_1, self_attention.in_proj_weight,
self_attention.out_proj, ln_2, mlp.0, mlp.3}``, ``encoder.ln``), so the
state dict is the one ``utils/torch_convert.convert_vit`` reads, and
``convert.py`` carries the JAX trees across.

``block_impl`` chooses how the encoder blocks run (``resolve_block_impl``):

* ``kernel`` — the CUDA kernels of ``ops/vit_kernel.py`` at bf16 (the
  plain twins on the CPU).  By default the stream stack: every block as
  K4 → K7 → K6 on one (B·N, D) token stream, then the CLS rows;
  ``SRTPU_VIT_STREAM=0`` runs the per-block path (K4 → K5 → K6 per block
  on (B, N, D)), as in the JAX package.  On the card the two launch the
  same kernels on the same bytes (the TPU's stream pads to 8-row tiles;
  this one needs no padding);
* ``plain`` — ``ops.vit.reference_block`` per block in the compute type,
  the module math and the oracle of the tests.

The default ``auto`` takes the kernels on a CUDA device at bf16.

A differentiated call (fine-tuning: gradients enabled and the tokens or a
parameter requiring them) on the kernel path is routed as the JAX
package's custom VJPs route it: the stream stack runs the ft stream of
``ops/vit_train.py`` (torch LayerNorms, projections and MLP under autograd
around the attention core, whose forward is K7 and whose backward is K8);
the per-block path (``SRTPU_VIT_STREAM=0``) runs the plain
``reference_block`` under autograd, because that is what JAX's per-block
VJP differentiates (``_make_fused_block``), not as a fallback.  ``remat``
checkpoints each block of a differentiated call, on either path.  K4 and
K6 run only in undifferentiated calls.

The patch convolution, the CLS concatenation, the position embedding,
``ln_pre`` and the final LayerNorm are torch operations on every path, as
they are XLA operations outside Pallas in JAX.  Parameters stay f32 and are
cast to the compute type at use; the undifferentiated kernel path keeps a
bf16 copy of each block's weights (``kernel_weights``, made without a
gradient) until a parameter is replaced or written in place, and the ft
stream never reads it.

One difference from the JAX module: the CLIP variant's ``ln_pre`` output
is cast to the compute type, so that the stream is bf16 at bf16 (flax's f32
LayerNorm leaves it f32 there).  At f32 the two are the same.
"""

from __future__ import annotations

import os
from collections import OrderedDict

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from situation_recognition_tpu_torch.ops import vit_kernel
from situation_recognition_tpu_torch.ops.vit import (
    BlockWeights, attn_core_variant, ln_f32, reference_block)
from situation_recognition_tpu_torch.ops.vit_train import ft_cls_stack

#: feature width by backbone name (the head's hidden size must equal it)
VIT_WIDTHS = {"vit_l14": 1024, "vit_l14_clip": 1024, "vit_b16": 768,
              "vit_tiny": 64}
#: (patch, width, depth, heads, clip_variant) by backbone name
VIT_CONFIGS = {
    "vit_l14": (14, 1024, 24, 16, False),
    "vit_l14_clip": (14, 1024, 24, 16, True),
    "vit_b16": (16, 768, 12, 12, False),
    "vit_tiny": (32, 64, 2, 2, False),
}
BLOCK_IMPLS = ("auto", "kernel", "plain")


def vit_stream() -> bool:
    """The kernel path's layout: the stream stack (default) or, with
    ``SRTPU_VIT_STREAM=0``, the per-block kernels."""
    return os.environ.get("SRTPU_VIT_STREAM", "1") != "0"


def _jax_kernels_take(width: int, heads: int) -> bool:
    """The width part of the JAX package's kernel gate
    (``fused_block_supported``): a multiple of 128 in heads whose width is
    a multiple of 64.  Its other terms are the TPU's memory and a least
    row count, which say nothing of this card."""
    return (width % 128 == 0 and heads >= 1 and width % heads == 0
            and (width // heads) % 64 == 0)


def resolve_block_impl(impl: str, dtype: torch.dtype, device, width: int,
                       heads: int) -> str:
    """'auto' → 'kernel' on cuda at bf16 where ``block_supported`` passes,
    and 'plain' where the JAX package also runs without kernels: off the
    card, at f32, or at a width its kernels do not take.  A width that
    the JAX kernels take and these do not (heads wider than 64) raises
    under 'auto' on the card rather than move to the plain path unseen.
    'plain' passes through; 'kernel' passes through when the kernels take
    the width and the type is bf16, and raises otherwise (on the CPU,
    'kernel' runs the kernels' twins)."""
    if impl not in BLOCK_IMPLS:
        raise ValueError(f"block_impl must be auto|kernel|plain, got "
                         f"{impl!r}")
    if impl == "plain":
        return impl
    bf16 = dtype == torch.bfloat16
    ok = bf16 and vit_kernel.block_supported(width, heads)
    need = (f"they need bf16, heads of width {vit_kernel.HEAD_DIM} and a "
            f"width that is a multiple of {vit_kernel.D_MULTIPLE}")
    if impl == "kernel":
        if not ok:
            raise ValueError(
                f"block_impl='kernel' forced but the ViT kernels cannot run "
                f"this model: dtype={dtype}, width {width}, {heads} heads "
                f"({need}); use block_impl='auto' or 'plain'")
        return impl
    if torch.device(device).type != "cuda" or not bf16:
        return "plain"
    if ok:
        return "kernel"
    if _jax_kernels_take(width, heads):
        raise ValueError(
            f"the JAX package runs width {width} in {heads} heads through "
            f"its kernels, but the port's kernels cannot ({need}); pass "
            f"block_impl='plain' to run it without kernels")
    return "plain"


class SelfAttention(nn.Module):
    """The parameters of torchvision's ``nn.MultiheadAttention``: the
    packed (3D, D) q/k/v projection and the out projection.  The
    attention itself runs in ``ViT``."""

    def __init__(self, width: int):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * width))
        self.out_proj = nn.Linear(width, width)


class EncoderLayer(nn.Module):
    """One encoder block's parameters under torchvision's names."""

    def __init__(self, width: int, mlp_ratio: int, eps: float):
        super().__init__()
        self.ln_1 = nn.LayerNorm(width, eps=eps)
        self.self_attention = SelfAttention(width)
        self.ln_2 = nn.LayerNorm(width, eps=eps)
        # indices 0 and 3 as torchvision's MLPBlock (Linear, GELU, Dropout,
        # Linear, Dropout); the activation runs in the block math
        self.mlp = nn.Sequential(nn.Linear(width, width * mlp_ratio),
                                 nn.Identity(), nn.Identity(),
                                 nn.Linear(width * mlp_ratio, width))
        self._kernel_weights = None

    def weights(self) -> BlockWeights:
        a = self.self_attention
        return BlockWeights(
            self.ln_1.weight, self.ln_1.bias, a.in_proj_weight,
            a.in_proj_bias, a.out_proj.weight, a.out_proj.bias,
            self.ln_2.weight, self.ln_2.bias, self.mlp[0].weight,
            self.mlp[0].bias, self.mlp[3].weight, self.mlp[3].bias)

    def kernel_weights(self) -> BlockWeights:
        """``vit_kernel.kernel_weights`` of this block, kept until a
        parameter is replaced or written in place."""
        key = tuple((p.data_ptr(), p._version) for p in self.parameters())
        hit = self._kernel_weights
        if hit is None or hit[0] != key:
            with torch.no_grad():
                hit = (key, vit_kernel.kernel_weights(self.weights()))
            self._kernel_weights = hit
        return hit[1]


class Encoder(nn.Module):
    def __init__(self, n_tokens: int, width: int, depth: int,
                 mlp_ratio: int, eps: float):
        super().__init__()
        self.pos_embedding = nn.Parameter(torch.empty(1, n_tokens, width))
        self.layers = nn.Sequential(OrderedDict(
            (f"encoder_layer_{i}", EncoderLayer(width, mlp_ratio, eps))
            for i in range(depth)))
        self.ln = nn.LayerNorm(width, eps=eps)


class ViT(nn.Module):
    """Pre-LN ViT → the final-LN CLS token (B, width).

    ``forward`` takes NHWC images of ``image_size`` in the compute type
    ``dtype`` (the position embedding is sized for them) and returns the
    features in that type.  ``remat`` checkpoints each encoder block of a
    differentiated call (``--remat_backbone``); the parameters are the
    same either way."""

    def __init__(self, patch: int, width: int, depth: int, heads: int,
                 image_size: int = 224, clip_variant: bool = False,
                 mlp_ratio: int = 4, dtype: torch.dtype = torch.float32,
                 block_impl: str = "auto", remat: bool = False):
        super().__init__()
        if width % heads:
            raise ValueError(f"width {width} is not divisible by {heads} "
                             f"heads")
        if image_size % patch:
            raise ValueError(f"image_size {image_size} is not divisible by "
                             f"the patch {patch}")
        self.patch, self.width, self.depth, self.heads = (
            patch, width, depth, heads)
        self.image_size = image_size
        self.clip_variant = clip_variant
        self.eps = 1e-5 if clip_variant else 1e-6
        self.dtype = dtype
        self.block_impl = block_impl
        self.remat = remat
        self.n_tokens = (image_size // patch) ** 2 + 1
        self.class_token = nn.Parameter(torch.zeros(1, 1, width))
        self.conv_proj = nn.Conv2d(3, width, patch, stride=patch,
                                   bias=not clip_variant)
        if clip_variant:
            self.ln_pre = nn.LayerNorm(width, eps=self.eps)
        self.encoder = Encoder(self.n_tokens, width, depth, mlp_ratio,
                               self.eps)

    def _differentiated(self, x: torch.Tensor) -> bool:
        return torch.is_grad_enabled() and (x.requires_grad or any(
            p.requires_grad for p in self.parameters()))

    def resolved_impl(self, device) -> str:
        """``block_impl`` resolved for this model on ``device``
        (``resolve_block_impl``)."""
        return resolve_block_impl(self.block_impl, self.dtype, device,
                                  self.width, self.heads)

    def path(self, x: torch.Tensor) -> str:
        """The encoder path for tokens x: 'stream' or 'block' (the
        forward kernels), 'ft' (the differentiable stream: K7 forward, K8
        backward) or 'plain'.  Where the choice resolves to the kernels
        ('kernel', or 'auto' on the card at bf16), a differentiated call
        takes 'ft' on the stream stack and 'plain' under
        ``SRTPU_VIT_STREAM=0``, as JAX's two custom VJPs do."""
        impl = self.resolved_impl(x.device)
        if impl == "plain":
            return "plain"
        if x.dtype != torch.bfloat16:
            raise ValueError(f"the ViT kernels take a bf16 stream, got "
                             f"{x.dtype}")
        if self._differentiated(x):
            return "ft" if vit_stream() else "plain"
        return "stream" if vit_stream() else "block"

    def tokens(self, images: torch.Tensor) -> torch.Tensor:
        """NHWC images → (B, N, width) tokens in the compute type: patch
        embedding, CLS, position embedding (and ``ln_pre``)."""
        dt = self.dtype
        b = images.shape[0]
        x = images.to(dt).permute(0, 3, 1, 2)
        w = self.conv_proj.weight.to(dt)
        bias = None if self.conv_proj.bias is None \
            else self.conv_proj.bias.to(dt)
        x = nn.functional.conv2d(x, w, bias, stride=self.patch)
        x = x.flatten(2).transpose(1, 2)                     # (B, N-1, D)
        cls = self.class_token.to(dt).expand(b, 1, self.width)
        x = torch.cat([cls, x], dim=1)
        if x.shape[1] != self.n_tokens:
            raise ValueError(f"{x.shape[1]} tokens for a position embedding "
                             f"of {self.n_tokens} (image_size "
                             f"{self.image_size})")
        x = x + self.encoder.pos_embedding.to(dt)
        if self.clip_variant:
            x = ln_f32(x, self.ln_pre.weight, self.ln_pre.bias,
                       self.eps).to(dt)
        return x

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images (B, H, W, 3) → features (B, width) in the compute type."""
        x = self.tokens(images)
        path = self.path(x)
        quick, eps = self.clip_variant, self.eps
        folded = attn_core_variant() == "exp2"
        layers = list(self.encoder.layers)
        remat = self.remat and self._differentiated(x)
        if path == "stream":
            cls = vit_kernel.encoder_cls_stack(
                x, [blk.kernel_weights() for blk in layers], self.heads, eps,
                quick, folded)
        elif path == "ft":
            cls = ft_cls_stack(x, [blk.weights() for blk in layers],
                               self.heads, eps, quick, folded, remat)
        else:
            for blk in layers:
                if path == "block":
                    x = vit_kernel.encoder_block(
                        x, blk.kernel_weights(), self.heads, eps, quick,
                        folded)
                elif remat:
                    x = checkpoint(reference_block, x, blk.weights(),
                                   self.heads, eps, quick,
                                   use_reentrant=False)
                else:
                    x = reference_block(x, blk.weights(), self.heads, eps,
                                        quick)
            cls = x[:, 0]
        # the final LayerNorm is row-local: on the CLS rows alone it gives
        # the JAX module's LayerNorm-over-every-token's CLS row exactly
        ln = self.encoder.ln
        return ln_f32(cls, ln.weight, ln.bias, eps).to(self.dtype)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Random weights from ``generator``: normal(0.02) position
        embedding, zero CLS token, LayerNorms 1 and 0, and uniform
        ±1/sqrt(fan_in) projections, convolution and biases."""
        def uniform(t, fan_in):
            bound = fan_in ** -0.5
            t.copy_((torch.rand(t.shape, generator=generator) * 2 - 1)
                    * bound)

        with torch.no_grad():
            self.class_token.zero_()
            self.encoder.pos_embedding.copy_(torch.randn(
                self.encoder.pos_embedding.shape, generator=generator)
                * 0.02)
            fan_conv = 3 * self.patch * self.patch
            uniform(self.conv_proj.weight, fan_conv)
            if self.conv_proj.bias is not None:
                uniform(self.conv_proj.bias, fan_conv)
            for m in self.modules():
                if isinstance(m, nn.LayerNorm):
                    m.reset_parameters()
                elif isinstance(m, nn.Linear):
                    uniform(m.weight, m.in_features)
                    uniform(m.bias, m.in_features)
                elif isinstance(m, SelfAttention):
                    uniform(m.in_proj_weight, self.width)
                    uniform(m.in_proj_bias, self.width)


def build_vit(name: str, image_size: int = 224,
              dtype: torch.dtype = torch.float32,
              block_impl: str = "auto", remat: bool = False) -> ViT:
    """Backbone by name (``VIT_CONFIGS``: ``vit_l14``, its CLIP visual
    tower ``vit_l14_clip``, ``vit_b16``, and the test-sized ``vit_tiny``)
    computing in ``dtype``, with its blocks checkpointed under autograd
    when ``remat``."""
    if name not in VIT_CONFIGS:
        raise ValueError(f"unknown ViT {name!r}; one of "
                         f"{sorted(VIT_CONFIGS)}")
    patch, width, depth, heads, clip = VIT_CONFIGS[name]
    return ViT(patch, width, depth, heads, image_size=image_size,
               clip_variant=clip, dtype=dtype, block_impl=block_impl,
               remat=remat)
