"""The port's ViT (``models/vit.py``) against the JAX package's ViT on the
CPU: the same flax parameters carried across by ``convert.py``, the same
numpy images; the conversions both ways and through the JAX package's own
``convert_vit``; and how ``block_impl`` and ``SRTPU_VIT_STREAM`` choose a
path."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from situation_recognition_tpu.models.vit import ViT as JaxViT
from situation_recognition_tpu.ops import vit_pallas as jv
from situation_recognition_tpu.utils.torch_convert import convert_vit
from situation_recognition_tpu_torch import convert
from situation_recognition_tpu_torch.models.backbone import build_backbone
from situation_recognition_tpu_torch.models.vit import (
    ViT, resolve_block_impl)
from situation_recognition_tpu_torch.ops import vit_kernel as vk

# f32 through 2 blocks in other operation orders (flax scales q before QKᵀ,
# the port scales the scores)
F32_TOL = dict(rtol=1e-4, atol=1e-4)


def _jax_params(model, image, seed):
    """Random flax params of ``model`` with nonzero CLS token, biases and
    LayerNorm shifts, numpy f32."""
    params = model.init(jax.random.PRNGKey(seed),
                        jnp.zeros((1, image, image, 3)))["params"]
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (np.asarray(a) + rng.standard_normal(a.shape) * 0.05)
        .astype(np.float32), params)


def _port(params, patch, width, depth, heads, image, clip=False,
          **kw) -> ViT:
    m = ViT(patch, width, depth, heads, image_size=image, clip_variant=clip,
            **kw)
    m.load_state_dict(convert.vit_state_from_jax(params), strict=True)
    return m.eval()


def _images(b, image, seed):
    return np.random.default_rng(seed).standard_normal(
        (b, image, image, 3)).astype(np.float32)


@pytest.mark.parametrize("clip", [False, True], ids=["vit_tiny", "clip"])
def test_plain_vit_matches_jax_flax_path(clip):
    """vit_tiny's shape (patch 32, width 64, 2 blocks, 2 heads, 224²) and
    its CLIP variant (no patch bias, ln_pre, QuickGELU, eps 1e-5) at f32."""
    jm = JaxViT(patch=32, width=64, depth=2, heads=2, clip_variant=clip,
                block_impl="flax")
    params = _jax_params(jm, 224, seed=int(clip))
    x = _images(3, 224, 5)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    port = _port(params, 32, 64, 2, 2, 224, clip=clip)
    assert port.path(port.tokens(torch.from_numpy(x))) == "plain"
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **F32_TOL)


def test_state_dict_round_trips_and_reads_with_convert_vit():
    """The port's state dict is torchvision's layout: the JAX package's
    ``convert_vit`` reads it back into the exact JAX tree, and
    ``vit_params_to_jax`` inverts ``vit_state_from_jax`` exactly."""
    jm = JaxViT(patch=32, width=64, depth=2, heads=2)
    params = _jax_params(jm, 224, seed=3)
    state = convert.vit_state_from_jax(params)
    assert list(state) == list(ViT(32, 64, 2, 2).state_dict())
    back = convert_vit({k: v.numpy() for k, v in state.items()}, 2)
    for tree in (back, convert.vit_params_to_jax(state, 2)):
        got = jax.tree_util.tree_leaves_with_path(tree)
        want = dict(jax.tree_util.tree_leaves_with_path(params))
        assert len(got) == len(want)
        for path, leaf in got:
            np.testing.assert_array_equal(leaf, want[path], err_msg=str(path))


def test_clip_state_dict_round_trips():
    jm = JaxViT(patch=32, width=64, depth=1, heads=2, clip_variant=True)
    params = _jax_params(jm, 64, seed=4)
    state = convert.vit_state_from_jax(params)
    assert "ln_pre.weight" in state and "conv_proj.bias" not in state
    got = jax.tree_util.tree_leaves_with_path(
        convert.vit_params_to_jax(state, 2))
    want = dict(jax.tree_util.tree_leaves_with_path(params))
    assert len(got) == len(want)
    for path, leaf in got:
        np.testing.assert_array_equal(leaf, want[path], err_msg=str(path))


def _kernel_path_case(width, heads, stream, monkeypatch, seed):
    """The kernel path at bf16 (the kernels' twins on the CPU) against the
    JAX ViT's Pallas path in interpret mode over two blocks, 257 tokens
    (patch 8 on 128²) as ViT-L/14 has, 4 images (1028 token rows, above
    the JAX gate's 1024).  Both keep the stream in bf16 between blocks;
    the bound is the encoder paths' of tests/test_torch_vit_ops.py, on the
    final-LN features."""
    monkeypatch.setenv("SRTPU_VIT_STREAM", stream)
    jm = JaxViT(patch=8, width=width, depth=2, heads=heads,
                dtype=jnp.bfloat16, block_impl="pallas", interpret=True)
    params = _jax_params(jm, 128, seed=seed)
    x = _images(4, 128, seed + 1)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x))
                      .astype(jnp.float32))
    port = _port(params, 8, width, 2, heads, 128, dtype=torch.bfloat16,
                 block_impl="kernel")
    counts = (vk.vit_attention_stream_forward.launches,
              vk.vit_attention_forward.launches)
    with torch.no_grad():
        tokens = port.tokens(torch.from_numpy(x))
        assert port.path(tokens) == ("stream" if stream == "1" else "block")
        got = port(torch.from_numpy(x)).float().numpy()
    # the CPU runs the twins: nothing is counted as a launch
    assert (vk.vit_attention_stream_forward.launches,
            vk.vit_attention_forward.launches) == counts
    scale = np.abs(want).max()
    diff = np.abs(got - want)
    assert diff.max() <= 2 ** -5 * scale, (diff.max(), scale)
    assert diff.mean() <= 2 ** -9 * scale, (diff.mean(), scale)


@pytest.mark.parametrize("stream", ["1", "0"], ids=["stream", "per_block"])
def test_kernel_path_matches_jax_pallas_path(stream, monkeypatch):
    """``_kernel_path_case`` through the stream stack and the per-block
    kernels at width 128 (2 heads of 64)."""
    _kernel_path_case(128, 2, stream, monkeypatch, seed=6)


@pytest.mark.parametrize("stream", ["1", "0"], ids=["stream", "per_block"])
def test_kernel_path_matches_jax_pallas_path_heads_of_128(stream,
                                                          monkeypatch):
    """``_kernel_path_case`` at width 256 in 2 heads of 128, a head width
    the JAX kernels take (scale 1/sqrt(128)), with the same bounds."""
    _kernel_path_case(256, 2, stream, monkeypatch, seed=16)


def test_resolve_block_impl():
    """'auto' takes the kernels on the card at bf16 for every ViT of the
    repo and for heads wider than 64 (128, 256); it runs plain only where
    the JAX package also runs without its kernels, and never raises.  A
    forced 'kernel' raises where the kernels cannot run, naming the head
    width rule."""
    bf, f32 = torch.bfloat16, torch.float32
    ok = (1024, 16)
    assert resolve_block_impl("auto", bf, "cuda", *ok) == "kernel"
    assert resolve_block_impl("auto", bf, "cuda", 768, 12) == "kernel"
    assert resolve_block_impl("auto", bf, "cpu", *ok) == "plain"
    assert resolve_block_impl("auto", f32, "cuda", *ok) == "plain"
    assert resolve_block_impl("auto", bf, "cuda", 64, 2) == "plain"
    assert resolve_block_impl("auto", bf, "cuda", 1024, 8) == "kernel"
    assert resolve_block_impl("auto", bf, "cuda", 1024, 4) == "kernel"
    assert resolve_block_impl("auto", bf, "cpu", 1024, 8) == "plain"
    assert resolve_block_impl("plain", bf, "cuda", 1024, 8) == "plain"
    assert resolve_block_impl("plain", bf, "cuda", *ok) == "plain"
    assert resolve_block_impl("kernel", bf, "cpu", *ok) == "kernel"
    assert resolve_block_impl("kernel", bf, "cuda", 1024, 8) == "kernel"
    for bad in ((f32, 1024, 16), (bf, 64, 2), (bf, 768, 16), (bf, 192, 2)):
        with pytest.raises(ValueError, match="forced"):
            resolve_block_impl("kernel", bad[0], "cuda", *bad[1:])
    with pytest.raises(ValueError,
                       match="heads whose width is a multiple of 64"):
        resolve_block_impl("kernel", bf, "cuda", 192, 2)    # heads of 96
    with pytest.raises(ValueError, match="auto\\|kernel\\|plain"):
        resolve_block_impl("pallas", bf, "cuda", *ok)


@pytest.mark.parametrize("width", [128, 256, 384, 768, 1024, 1280])
def test_auto_takes_every_width_the_jax_kernels_take(width):
    """Over every head count of a width: where the JAX package's kernel
    gate (``fused_block_supported`` at ViT-L/14's 257 tokens, batch 256)
    takes the model, 'auto' on the card at bf16 resolves to the kernels;
    it resolves to them exactly where the gate's width terms pass (heads
    whose width is a multiple of 64), and to 'plain' elsewhere."""
    taken = 0
    for heads in range(1, width + 1):
        terms = width % heads == 0 and (width // heads) % 64 == 0
        got = resolve_block_impl("auto", torch.bfloat16, "cuda", width,
                                 heads)
        assert got == ("kernel" if terms else "plain"), (width, heads)
        if jv.fused_block_supported(width, heads, 257, 256):
            assert terms, (width, heads)
            taken += 1
    assert taken == sum(1 for h in range(1, width + 1)
                        if width % h == 0 and (width // h) % 64 == 0)


def test_path_selection(monkeypatch):
    """'kernel' takes the stream stack unless SRTPU_VIT_STREAM=0; a
    differentiated call takes the ft stream on the stream stack and the
    plain blocks on the per-block path (JAX's two custom VJPs); an f32
    stream on the kernel path raises, differentiated or not; the vit_tiny
    width never reaches the kernels."""
    m = ViT(16, 128, 1, 2, image_size=32, dtype=torch.bfloat16,
            block_impl="kernel")
    x = torch.zeros(2, 5, 128, dtype=torch.bfloat16)
    with torch.no_grad():
        monkeypatch.delenv("SRTPU_VIT_STREAM", raising=False)
        assert m.path(x) == "stream"
        monkeypatch.setenv("SRTPU_VIT_STREAM", "0")
        assert m.path(x) == "block"
        with pytest.raises(ValueError, match="bf16"):
            m.path(x.float())
    assert m.path(x) == "plain"                    # SRTPU_VIT_STREAM=0
    with pytest.raises(ValueError, match="bf16"):
        m.path(x.float())
    monkeypatch.delenv("SRTPU_VIT_STREAM")
    assert m.path(x) == "ft"
    m.requires_grad_(False)
    assert m.path(x) == "stream"                   # nothing to differentiate
    assert m.path(x.requires_grad_()) == "ft"
    m.block_impl = "auto"
    with torch.no_grad():
        assert m.path(x) == "plain"                # the CPU
    tiny, has_bn = build_backbone("vit_tiny", 64, dtype=torch.bfloat16)
    assert not has_bn and tiny.block_impl == "auto"
    assert tiny.dtype == torch.bfloat16
    tiny.block_impl = "kernel"
    with torch.no_grad(), pytest.raises(ValueError, match="forced"):
        tiny.path(torch.zeros(1, 50, 64, dtype=torch.bfloat16))


def test_auto_on_the_card_raises_under_autograd(monkeypatch):
    """Where 'auto' resolves to the kernels (the card at bf16), a
    differentiated call takes the ft stream (K7 forward, K8 backward), as
    a forced 'kernel' does, and an f32 stream there still raises rather
    than move to the plain path unseen.  Without gradients the same call
    takes the forward kernels, and on the CPU 'auto' differentiates
    through the plain path."""
    m = ViT(16, 128, 1, 2, image_size=32, dtype=torch.bfloat16)
    x = torch.zeros(2, 5, 128, dtype=torch.bfloat16)
    assert m.block_impl == "auto" and m.path(x) == "plain"
    monkeypatch.setattr(m, "resolved_impl", lambda device: resolve_block_impl(
        m.block_impl, m.dtype, "cuda", m.width, m.heads))
    monkeypatch.delenv("SRTPU_VIT_STREAM", raising=False)
    assert m.path(x) == "ft"
    with pytest.raises(ValueError, match="bf16"):
        m.path(x.float())
    with torch.no_grad():
        assert m.path(x) == "stream"
    m.block_impl = "plain"
    assert m.path(x) == "plain"


def test_build_backbone_contract():
    m, has_bn = build_backbone("vit_l14_clip", 1024)
    assert not has_bn and m.clip_variant and m.n_tokens == 257
    assert m.encoder.pos_embedding.shape == (1, 257, 1024)
    m, has_bn = build_backbone("vit_b16", 768, image_size=384)
    assert m.n_tokens == 577 and m.depth == 12
    assert build_backbone("mini", 64)[1]
    with pytest.raises(ValueError, match="hidden=64"):
        build_backbone("vit_tiny", 2048)
    with pytest.raises(ValueError, match="not divisible"):
        build_backbone("vit_l14", 1024, image_size=200)
    with pytest.raises(ValueError, match="unknown backbone"):
        build_backbone("vit_h14", 1280)


def test_attn_core_variant_env(monkeypatch):
    from situation_recognition_tpu_torch.ops.vit import attn_core_variant

    monkeypatch.delenv("SRTPU_ATTN_CORE", raising=False)
    assert attn_core_variant() == "exp2"
    monkeypatch.setenv("SRTPU_ATTN_CORE", "softmax")
    assert attn_core_variant() == "softmax"
    monkeypatch.setenv("SRTPU_ATTN_CORE", "bogus")
    with pytest.raises(ValueError):
        attn_core_variant()
