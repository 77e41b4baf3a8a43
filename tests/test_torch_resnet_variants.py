"""resnet18 / 34 (BasicBlock stacks) and resnet50 / 101 (Bottleneck
stacks) of the port against the JAX package's ``ResNet``, at their
published depths and at small widths (base width 8 for BasicBlocks, 2 for
Bottlenecks: the head width 64 either way), 64² inputs: the features in
eval- and train-mode BN and the statistics train mode updates, with
weights carried across by ``convert.py``; the converters both ways against
the JAX package's own (``utils/torch_convert.convert_resnet``,
``utils/torch_export.export_resnet_state``); and a reference-layout
state dict (``export_reference_state_dict``) loading with
``strict=True``.  The CLI's head width per backbone is JAX's
``default_hidden``.

Tolerance: f32 convolutions summed in other orders through up to 104
layers, against features of order 1 — 1e-4 relative and absolute, as
``tests/test_torch_resnet.py`` holds the mini stack; the statistics of
those activations 1e-5 (``tests/test_torch_train.py``).  Train-mode BN
divides by the batch's standard deviation, which amplifies rounding where
it is taken over few values: at 32² the last stage's BN sees 4 values per
channel (1×1 maps, batch 4) and one feature in 256 of resnet34 moved by
2.6e-4; at 64² it sees 16."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from situation_recognition_tpu.models.resnet import ResNet as JaxResNet
from situation_recognition_tpu.train import (
    _BASIC_RESNETS, _RESNETS, default_hidden)
from situation_recognition_tpu.utils.torch_convert import convert_resnet
from situation_recognition_tpu.utils.torch_export import (
    export_reference_state_dict, export_resnet_state)
from situation_recognition_tpu_torch import convert
from situation_recognition_tpu_torch.cli import _default_hidden
from situation_recognition_tpu_torch.models import resnet as tr
from situation_recognition_tpu_torch.models.backbone import build_backbone
from tests.test_torch_resnet import _dummy_head

HIDDEN = 64
NAMES = ("resnet18", "resnet34", "resnet50", "resnet101")
FEAT_TOL = dict(rtol=1e-4, atol=1e-4)
STATS_TOL = dict(rtol=1e-5, atol=1e-5)


def _jax(name):
    basic = name in _BASIC_RESNETS
    stages = (_BASIC_RESNETS if basic else _RESNETS)[name]
    return JaxResNet(stage_sizes=stages, basic=basic,
                     base_width=HIDDEN // (8 if basic else 32))


@functools.lru_cache(maxsize=None)
def _case(name):
    """(name, JAX module, params, statistics): random running statistics,
    so that eval-mode BN is not the identity."""
    model = _jax(name)
    variables = jax.jit(model.init, static_argnames="train")(
        jax.random.PRNGKey(3), jnp.zeros((1, 64, 64, 3)), train=False)
    params = jax.tree.map(np.asarray, variables["params"])
    rng = np.random.default_rng(4)
    stats = jax.tree.map(np.asarray, variables["batch_stats"])
    for leaf_path, _ in jax.tree_util.tree_leaves_with_path(stats):
        node = stats
        for k in leaf_path[:-1]:
            node = node[k.key]
        key = leaf_path[-1].key
        shape = node[key].shape
        node[key] = (rng.standard_normal(shape) * 0.1 if key == "mean"
                     else rng.uniform(0.5, 1.5, shape)).astype(np.float32)
    return name, model, params, stats


def _port(name, params, stats):
    model = tr.build_resnet(name, HIDDEN)
    model.load_state_dict(convert.resnet_state_from_jax(params, stats),
                          strict=True)
    return model


def _train_stats_close(model, updates, keys=None):
    got = convert.resnet_stats_to_jax(model.state_dict())
    want = jax.tree.map(np.asarray, updates)
    if keys is not None:
        got = {k: got[k] for k in keys}
    flat = dict(jax.tree_util.tree_leaves_with_path(want))
    assert len(jax.tree_util.tree_leaves(got)) == len(flat)
    for path, leaf in jax.tree_util.tree_leaves_with_path(got):
        np.testing.assert_allclose(leaf, flat[path], **STATS_TOL,
                                   err_msg=str(path))


@pytest.mark.parametrize("name,train", [(n, False) for n in NAMES] + [
    ("resnet18", True), ("resnet34", True)])
def test_features_match_jax(name, train):
    """The whole stack; in train mode the BasicBlock stacks (the
    Bottleneck stacks block by block: ``test_train_mode_blocks_match_jax``
    says why)."""
    _, jmodel, params, stats = _case(name)
    x = np.random.default_rng(5).standard_normal((4, 64, 64, 3)).astype(
        np.float32)
    apply = jax.jit(jmodel.apply, static_argnames=("train", "mutable"))
    variables = {"params": params, "batch_stats": stats}
    model = _port(name, params, stats).train(train)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == (4, HIDDEN) and model.out_features == HIDDEN
    if not train:
        want = apply(variables, jnp.asarray(x), train=False)
        np.testing.assert_allclose(got, np.asarray(want), **FEAT_TOL)
        return
    want, updates = apply(variables, jnp.asarray(x), train=True,
                          mutable=("batch_stats",))
    np.testing.assert_allclose(got, np.asarray(want), **FEAT_TOL)
    _train_stats_close(model, updates["batch_stats"])


@pytest.mark.parametrize("name", NAMES)
def test_train_mode_blocks_match_jax(name):
    """Train-mode BN block by block: each block of the port against the
    JAX block (``BasicBlock`` / ``Bottleneck``) on the JAX chain's input,
    outputs and updated statistics.  Whole Bottleneck stacks at base width
    2 are not compared in train mode: flax's E[x²] − E[x]² variance loses
    digits to cancellation once the residual stream's mean outgrows its
    spread, and 16–33 train-mode BNs compound it — at resnet101 the JAX
    stack's features lie 1.8e-3 from a float64 run of the same weights,
    the port's 2.7e-4."""
    from situation_recognition_tpu.models.resnet import (
        BasicBlock, Bottleneck)

    _, _, params, stats = _case(name)
    basic = name in tr.BASIC_STACKS
    block_cls = BasicBlock if basic else Bottleneck
    model = _port(name, params, stats).train(True)
    features = HIDDEN // (8 if basic else 32)
    # the stem's output at 64²: 16² maps of the stem's width
    x = np.random.default_rng(6).standard_normal(
        (4, 16, 16, features)).astype(np.float32)
    for stage, blocks in enumerate(tr.STAGE_SIZES[name]):
        for b in range(blocks):
            key = f"layer{stage + 1}_{b}"
            jblock = block_cls(features=features,
                               strides=2 if stage and not b else 1,
                               has_downsample=not b and (
                                   not basic or stage > 0))
            want, updates = jblock.apply(
                {"params": params[key], "batch_stats": stats[key]},
                jnp.asarray(x), train=True, mutable=("batch_stats",))
            block = getattr(model, f"layer{stage + 1}")[b]
            with torch.no_grad():
                got = block(torch.from_numpy(x).permute(0, 3, 1, 2))
            want = np.array(want)                  # writable, for torch
            np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                                       **FEAT_TOL, err_msg=key)
            _train_stats_close(model, {key: updates["batch_stats"]}, [key])
            x = want
        features *= 2


@pytest.mark.parametrize("name", NAMES)
def test_converters_both_ways_agree_with_jax(name):
    """JAX trees → the port's state dict equals the JAX package's own
    torchvision export, key for key; and the JAX package's importer and
    ``resnet_stats_to_jax`` read that state dict back to the same trees."""
    _, _, params, stats = _case(name)
    state = convert.resnet_state_from_jax(params, stats)
    ref = export_resnet_state(params, stats)
    assert list(state) == list(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(state[k].numpy(), v, err_msg=k)
    back_params, back_stats = convert_resnet(
        {k: v.numpy() for k, v in state.items()})
    for want, got in ((params, back_params), (stats, back_stats)):
        flat = dict(jax.tree_util.tree_leaves_with_path(got))
        assert len(flat) == len(jax.tree_util.tree_leaves(want))
        for path, leaf in jax.tree_util.tree_leaves_with_path(want):
            np.testing.assert_array_equal(np.asarray(flat[path]), leaf)
    ours = convert.resnet_stats_to_jax(state)
    flat = dict(jax.tree_util.tree_leaves_with_path(ours))
    for path, leaf in jax.tree_util.tree_leaves_with_path(stats):
        np.testing.assert_array_equal(flat[path], leaf)


@pytest.mark.parametrize("name", NAMES)
def test_reference_state_dict_loads_strict(name):
    """The reference's checkpoint layout of this backbone
    (``convnet_verbs.model.*`` and its twin) → ``from_reference`` → the
    port's backbone of the same name, ``strict=True``."""
    _, _, params, stats = _case(name)
    ref = export_reference_state_dict(params, stats, _dummy_head(HIDDEN))
    bb, head = convert.from_reference(ref)
    model, has_bn = build_backbone(name, HIDDEN)
    assert has_bn
    model.load_state_dict(bb, strict=True)
    assert "ggsnn.W_p.weight" in head and not any(
        k.startswith("convnet") for k in head)


@pytest.mark.parametrize("backbone", [
    "resnet18", "resnet34", "resnet50", "resnet101", "resnet152", "mini",
    "vit_l14", "vit_l14_clip", "vit_b16", "vit_tiny"])
def test_cli_head_width_is_jax_default_hidden(backbone):
    assert _default_hidden(backbone) == default_hidden(backbone)


@pytest.mark.parametrize("name,width", [("resnet18", 512),
                                        ("resnet50", 2048)])
def test_published_width_and_block_counts(name, width):
    """At the CLI's head width: the published stem (64) and the block
    counts of each stage."""
    model = tr.build_resnet(name, _default_hidden(name))
    assert model.out_features == width and model.conv1.out_channels == 64
    assert [len(getattr(model, f"layer{i}")) for i in range(1, 5)] == list(
        tr.STAGE_SIZES[name])
    basic = name in tr.BASIC_STACKS
    assert isinstance(model.layer1[0],
                      tr.BasicBlock if basic else tr.Bottleneck)
    assert (model.layer1[0].downsample is None) == basic
