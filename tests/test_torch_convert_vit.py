"""The port's ViT converters (``convert.interpolate_pos_embed``,
``convert_vit``, ``convert_clip_vit``) against the JAX package's
(``utils/torch_convert.py``) on the same checkpoints, on the CPU: the
position embedding resampled as ``jax.image.resize(method="cubic")`` does
(within 1e-6; the same grid bit for bit), and the features of a ViT loaded
with each package's conversion within 1e-5 at f32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from situation_recognition_tpu.models.vit import ViT as JaxViT
from situation_recognition_tpu.utils import torch_convert as jax_convert
from situation_recognition_tpu_torch import convert
from situation_recognition_tpu_torch.models.vit import ViT

# the resampled grid: the same weights, f32 sums in another order
POS_TOL = 1e-6
# features after two blocks and the final LayerNorm, both at f32 (the JAX
# module scales q before QKᵀ, the port the scores); the weights are small
# (0.02 normal), as a trained ViT's
FEATURE_TOL = 1e-5


@pytest.mark.parametrize("src,dst", [(16, 24), (24, 16), (7, 10), (16, 16)],
                         ids=["16to24", "24to16", "7to10", "same"])
def test_pos_embed_matches_jax_resize(src, dst):
    rng = np.random.default_rng(src * 100 + dst)
    pos = (rng.standard_normal((1, src * src + 1, 48)) * 0.02).astype(
        np.float32)
    want = jax_convert.interpolate_pos_embed(pos, dst * dst + 1)
    got = convert.interpolate_pos_embed(torch.from_numpy(pos),
                                        dst * dst + 1)
    assert got.shape == want.shape == (1, dst * dst + 1, 48)
    if src == dst:
        assert torch.equal(got, torch.from_numpy(pos))
    else:
        assert np.abs(got.numpy() - want).max() <= POS_TOL
        np.testing.assert_array_equal(got[0, 0].numpy(), pos[0, 0])


def test_pos_embed_is_not_torch_bicubic():
    """``F.interpolate(mode="bicubic")`` (a = -0.75, clamped edges, no
    antialias) is another resampling: it misses JAX's grid by far more
    than the tolerance, which the port's meets."""
    rng = np.random.default_rng(1)
    grid = rng.standard_normal((1, 24 * 24 + 1, 8)).astype(np.float32)
    want = jax_convert.interpolate_pos_embed(grid, 16 * 16 + 1)[0, 1:]
    img = torch.from_numpy(grid[0, 1:]).reshape(1, 24, 24, 8).permute(
        0, 3, 1, 2)
    torch_bicubic = F.interpolate(img, size=(16, 16), mode="bicubic",
                                  align_corners=False)
    other = torch_bicubic.permute(0, 2, 3, 1).reshape(-1, 8).numpy()
    assert np.abs(other - want).max() > 100 * POS_TOL


def test_pos_embed_refuses_grids_that_are_not_square():
    with pytest.raises(ValueError, match="g\\*g\\+1"):
        convert.interpolate_pos_embed(torch.zeros(1, 11, 4), 17)
    with pytest.raises(ValueError, match="\\(1, N, D\\)"):
        convert.interpolate_pos_embed(torch.zeros(11, 4), 17)


def _jax_features(params, cfg, images):
    jm = JaxViT(**cfg, block_impl="flax")
    return np.asarray(jm.apply({"params": params}, jnp.asarray(images)))


def _port_features(state, cfg, image, images):
    m = ViT(cfg["patch"], cfg["width"], cfg["depth"], cfg["heads"],
            image_size=image, clip_variant=cfg.get("clip_variant", False))
    m.load_state_dict(state, strict=True)
    with torch.no_grad():
        return m.eval()(torch.from_numpy(images)).numpy()


def _random_state(cfg, image, seed):
    """A torchvision-layout ViT state of ``cfg`` with small random
    weights (LayerNorms near 1)."""
    m = ViT(cfg["patch"], cfg["width"], cfg["depth"], cfg["heads"],
            image_size=image, clip_variant=cfg.get("clip_variant", False))
    g = torch.Generator().manual_seed(seed)
    return {k: (1.0 if k.endswith(("ln_1.weight", "ln_2.weight",
                                   "ln.weight", "ln_pre.weight")) else 0.0)
            + torch.randn(v.shape, generator=g) * 0.02
            for k, v in m.state_dict().items()}


@pytest.mark.parametrize("image", [224, 288, 160])
def test_convert_vit_features_match_jax(image):
    """A torchvision ViT checkpoint at the 224 grid (``mlp.linear_*``
    spelling, a classifier head) converted by both packages at
    ``image``."""
    cfg = dict(patch=32, width=64, depth=2, heads=2)
    state = {}
    for k, v in _random_state(cfg, 224, image).items():
        state[k.replace(".mlp.0.", ".mlp.linear_1.")
              .replace(".mlp.3.", ".mlp.linear_2.")] = v
    state["heads.head.weight"] = torch.randn(5, 64)
    state["heads.head.bias"] = torch.randn(5)
    images = np.random.default_rng(image).standard_normal(
        (2, image, image, 3)).astype(np.float32)
    params = jax_convert.convert_vit({k: v.numpy() for k, v in state.items()},
                                     2, image_size=image)
    want = _jax_features(params, cfg, images)
    got = _port_features(convert.convert_vit(state, image_size=image), cfg,
                         image, images)
    np.testing.assert_allclose(got, want, rtol=0, atol=FEATURE_TOL)


@pytest.mark.parametrize("prefix", ["visual.", ""])
@pytest.mark.parametrize("image", [224, 336])
def test_convert_clip_vit_features_match_jax(prefix, image):
    """A CLIP visual tower (ViT-L/14's layout at width 128, two blocks)
    at the 224 grid, with or without ``visual.``, converted by both
    packages at ``image``; its ``proj`` is not applied."""
    cfg = dict(patch=14, width=128, depth=2, heads=2, clip_variant=True)
    ours = _random_state(cfg, 224, 7)
    d = 128
    state = {prefix + "class_embedding": ours["class_token"].reshape(d),
             prefix + "positional_embedding": ours["encoder.pos_embedding"][0],
             prefix + "conv1.weight": ours["conv_proj.weight"],
             prefix + "proj": torch.randn(d, 16)}
    for mine, theirs in (("ln_pre", "ln_pre"), ("encoder.ln", "ln_post")):
        for p in ("weight", "bias"):
            state[f"{prefix}{theirs}.{p}"] = ours[f"{mine}.{p}"]
    for i in range(2):
        src = f"encoder.layers.encoder_layer_{i}."
        dst = f"{prefix}transformer.resblocks.{i}."
        for mine, theirs in (("ln_1", "ln_1"), ("ln_2", "ln_2"),
                             ("self_attention.out_proj", "attn.out_proj"),
                             ("mlp.0", "mlp.c_fc"), ("mlp.3", "mlp.c_proj")):
            for p in ("weight", "bias"):
                state[f"{dst}{theirs}.{p}"] = ours[f"{src}{mine}.{p}"]
        for p in ("weight", "bias"):
            state[f"{dst}attn.in_proj_{p}"] = ours[
                f"{src}self_attention.in_proj_{p}"]
    images = np.random.default_rng(image).standard_normal(
        (2, image, image, 3)).astype(np.float32)
    params = jax_convert.convert_clip_vit(
        {k: v.numpy() for k, v in state.items()}, 2, image_size=image)
    want = _jax_features(params, cfg, images)
    converted = convert.convert_clip_vit(state, image_size=image)
    assert not any(k.split(".")[-1] == "proj" for k in converted)
    got = _port_features(converted, cfg, image, images)
    np.testing.assert_allclose(got, want, rtol=0, atol=FEATURE_TOL)
    if image == 224:
        np.testing.assert_array_equal(
            converted["encoder.pos_embedding"].numpy(),
            ours["encoder.pos_embedding"].numpy())
    jax.clear_caches()
