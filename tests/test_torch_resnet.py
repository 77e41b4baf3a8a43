"""The port's ResNet against the JAX ResNet, weights carried across by
``convert.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from situation_recognition_tpu.models.resnet import ResNet as JaxResNet
from situation_recognition_tpu.utils.torch_export import (
    export_reference_state_dict)
from situation_recognition_tpu_torch import convert
from situation_recognition_tpu_torch.models import resnet as tr


def _jax_mini(hidden, seed):
    model = JaxResNet(stage_sizes=(1, 1, 1, 1), base_width=hidden // 32)
    variables = model.init(jax.random.PRNGKey(seed),
                           jnp.zeros((1, 64, 64, 3)), train=False)
    params = jax.tree.map(np.asarray, variables["params"])
    rng = np.random.default_rng(seed)
    # random running statistics, so eval-mode BN is not the identity
    stats = jax.tree.map(
        lambda s: np.asarray(s),
        variables["batch_stats"])
    for block in stats.values():
        for bn in (block.values() if "mean" not in block else [block]):
            bn["mean"] = rng.standard_normal(bn["mean"].shape).astype(
                np.float32) * 0.1
            bn["var"] = rng.uniform(0.5, 1.5, bn["var"].shape).astype(
                np.float32)
    return model, params, stats


@pytest.mark.parametrize("hidden", [64, 128])
def test_mini_resnet_eval_matches_jax(hidden):
    jmodel, params, stats = _jax_mini(hidden, 0)
    x = np.random.default_rng(1).standard_normal((2, 64, 64, 3)).astype(
        np.float32)
    want = np.asarray(jmodel.apply({"params": params, "batch_stats": stats},
                                   jnp.asarray(x), train=False))
    model = tr.mini(hidden).eval()
    model.load_state_dict(convert.resnet_state_from_jax(params, stats),
                          strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == (2, hidden)
    # f32 convolutions summed in other orders through 13 layers
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_reference_layout_equals_direct_conversion():
    """export_reference_state_dict (JAX side) → from_reference gives the
    same backbone state as converting the trees directly."""
    _, params, stats = _jax_mini(64, 2)
    direct = convert.resnet_state_from_jax(params, stats)
    ref = export_reference_state_dict(params, stats, _dummy_head(64))
    backbone, _ = convert.from_reference(ref)
    assert list(backbone) == list(direct)
    for k in direct:
        np.testing.assert_array_equal(np.asarray(backbone[k]),
                                      direct[k].numpy(), err_msg=k)


def _dummy_head(d):
    z = np.zeros
    g = {}
    for n in ("w_p", "w_z", "u_z", "w_r", "u_r", "w_h", "u_h"):
        g[n] = z((d, d), np.float32)
        g["b_" + n] = z((d,), np.float32)
    return {"role_emb": z((3, d), np.float32), "verb_emb": z((2, d), np.float32),
            "ggnn": g,
            "verb_classifier": {"kernel": z((d, 2), np.float32),
                                "bias": z((2,), np.float32)},
            "nouns_classifier": {"kernel": z((d, 4), np.float32),
                                 "bias": z((4,), np.float32)}}


def test_resnet152_conversion_is_complete():
    """Every leaf of the JAX ResNet-152 maps onto the port's ResNet-152
    with the right shape, and no port key is left over."""
    shapes = jax.eval_shape(
        lambda: JaxResNet(stage_sizes=(3, 8, 36, 3)).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), train=False))
    zeros = jax.tree.map(
        lambda s: np.broadcast_to(np.float32(0), s.shape), shapes)
    state = convert.resnet_state_from_jax(zeros["params"],
                                          zeros["batch_stats"])
    model = tr.resnet152()
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in state.items()} == want
    model.load_state_dict(state, strict=True)
    n_params = sum(p.numel() for p in model.parameters())
    assert n_params == sum(np.prod(s.shape) for s in
                           jax.tree.leaves(shapes["params"]))
    assert model.out_features == 2048
