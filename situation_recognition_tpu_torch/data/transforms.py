"""Image preprocessing: host windowing + batched device transforms.

Port of ``situation_recognition_tpu/data/transforms.py``.

1. **Host** (numpy, per image): decode to uint8 and cut a fixed 256x256
   window — a random (train) or torchvision-aligned center (eval) offset
   along the long axis (``host_window``), or the reference-exact
   ``Resize(224)`` + ``CenterCrop(224)`` (``host_window_exact``).
2. **Device** (torch, batched): uint8 → separable antialiased bilinear
   resize 256→224 as two matrix products with the same static weights as
   the JAX package (``_resize_matrix``) → /255 + ImageNet normalise →
   optional horizontal flip folded into the column weights.

Numerics follow the JAX version: at bf16 the weights and the row pass are
rounded to bf16 and every product accumulates in f32 (computed here as f32
products of bf16-valued operands, which are exact), and the column pass
stays f32 until the final cast.  A 224→224 input takes the identity branch.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)

WINDOW = 256
CROP = 224


# ------------------------------------------------------------------- host


def normalize_short_side(img: np.ndarray) -> np.ndarray:
    """Resize (PIL bilinear) so the shorter side == WINDOW; identity for
    images whose shorter side is already 256."""
    h, w = img.shape[:2]
    if min(h, w) == WINDOW:
        return img
    from PIL import Image

    scale = WINDOW / min(h, w)
    nh, nw = max(WINDOW, round(h * scale)), max(WINDOW, round(w * scale))
    return np.asarray(Image.fromarray(img).resize((nw, nh), Image.BILINEAR))


def host_window(img: np.ndarray, train: bool,
                rng: np.random.Generator | None = None) -> np.ndarray:
    """Cut a (WINDOW, WINDOW, 3) uint8 window from a decoded HWC image:
    random offset for train (``rng`` required), center for eval."""
    img = normalize_short_side(img)
    h, w = img.shape[:2]
    if train:
        if rng is None:
            raise ValueError("host_window(train=True) requires the seeded "
                             "rng — unseeded crops break determinism")
        oy = int(rng.integers(0, h - WINDOW + 1))
        ox = int(rng.integers(0, w - WINDOW + 1))
    else:
        oy = _center_offset(h)
        ox = _center_offset(w)
    return img[oy:oy + WINDOW, ox:ox + WINDOW]


def host_window_exact(img: np.ndarray) -> np.ndarray:
    """Reference-exact eval window: torchvision's shorter-side
    ``Resize(224)`` (long side truncated, no resize when the short side is
    already 224) then ``CenterCrop(224)`` with banker's rounding → a
    (224, 224, 3) uint8 image for the identity branch of the device
    transform."""
    from PIL import Image

    pil = Image.fromarray(img)
    w, h = pil.size
    if not ((w <= h and w == CROP) or (h <= w and h == CROP)):
        if w < h:
            ow, oh = CROP, int(CROP * h / w)
        else:
            oh, ow = CROP, int(CROP * w / h)
        pil = pil.resize((ow, oh), Image.BILINEAR)
        w, h = pil.size
    top = int(round((h - CROP) / 2.0))
    left = int(round((w - CROP) / 2.0))
    return np.asarray(pil)[top:top + CROP, left:left + CROP]


def _center_offset(full: int) -> int:
    """Center-window offset along one axis, computed at the reference's
    224-scale (``int(round((dim224 - 224) / 2))``) and mapped back."""
    if full <= WINDOW:
        return 0
    dim224 = round(full * CROP / WINDOW)
    off224 = int(round((dim224 - CROP) / 2))
    return min(full - WINDOW, round(off224 * full / dim224))


# ----------------------------------------------------------------- device


@functools.lru_cache(maxsize=None)
def _resize_matrix(src: int, dst: int) -> np.ndarray:
    """(src, dst) f32 matrix M with ``resized = v @ M`` for a length-src
    axis: the triangle-kernel weights of ``jax.image.resize(...,
    'linear', antialias=True)``, in numpy."""
    scale = dst / src
    inv_scale = 1.0 / scale
    kernel_scale = max(inv_scale, 1.0)
    sample_f = (np.arange(dst, dtype=np.float32) + 0.5) * inv_scale - 0.5
    x = np.abs(sample_f[None, :]
               - np.arange(src, dtype=np.float32)[:, None]) / kernel_scale
    weights = np.maximum(0.0, 1.0 - x).astype(np.float32)
    total = weights.sum(axis=0, keepdims=True)
    weights = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                       weights / np.where(total != 0, total, 1), 0.0)
    keep = (sample_f >= -0.5) & (sample_f <= src - 0.5)
    return np.where(keep[None, :], weights, 0.0).astype(np.float32)


def _normalize(z: torch.Tensor) -> torch.Tensor:
    mean = torch.as_tensor(IMAGENET_MEAN, device=z.device)
    std = torch.as_tensor(IMAGENET_STD, device=z.device)
    return (z * (1.0 / 255.0) - mean) / std


def device_transform(images_u8: torch.Tensor,
                     flip: torch.Tensor | None = None,
                     dtype: torch.dtype = torch.float32,
                     crop: int = CROP) -> torch.Tensor:
    """(B, H, W, 3) uint8 → (B, crop, crop, 3) normalised, on the input's
    device.  ``flip``: optional (B,) bool, horizontal flip per example."""
    if images_u8.dtype != torch.uint8 or images_u8.dim() != 4:
        raise ValueError(f"expected a (B, H, W, 3) uint8 batch, got "
                         f"{tuple(images_u8.shape)} {images_u8.dtype}")
    dev = images_u8.device
    h, w = images_u8.shape[1], images_u8.shape[2]
    if h == crop and w == crop:
        # the crop→crop triangle matrix is exactly I
        z = images_u8.float()
        if flip is not None:
            z = torch.where(flip.to(dev)[:, None, None, None],
                            z.flip(2), z)
        return _normalize(z).to(dtype)
    # weights (and at bf16 the row pass) rounded to the compute type; the
    # products are formed in f32 from those rounded values
    mdtype = dtype if dtype == torch.bfloat16 else torch.float32

    def weights(src):
        m = torch.as_tensor(_resize_matrix(src, crop), device=dev)
        return m.to(mdtype).float()

    mh = weights(h)
    mw = mh if w == h else weights(w)
    x = images_u8.float()
    y = torch.einsum("bhwc,hH->bHwc", x, mh).to(mdtype).float()
    z = torch.einsum("bHwc,wW->bHWc", y, mw)
    if flip is not None:
        zf = torch.einsum("bHwc,wW->bHWc", y, mw.flip(1))
        z = torch.where(flip.to(dev)[:, None, None, None], zf, z)
    return _normalize(z).to(dtype)


def eval_transform(images_u8: torch.Tensor,
                   dtype: torch.dtype = torch.float32,
                   crop: int = CROP) -> torch.Tensor:
    return device_transform(images_u8, flip=None, dtype=dtype, crop=crop)
