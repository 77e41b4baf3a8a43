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


# ------------------------------------------- train-mode BN, ReLU and add


def _parent_bn(bn, x):
    """Train-mode BN as the port composed it before ``bn_act``: torch's
    batch-norm kernel, then the running update in torch ops."""
    y, mean, invstd = torch.native_batch_norm(
        x, bn.weight, bn.bias, None, None, True, 0.0, bn.eps)
    with torch.no_grad():
        m = bn.momentum
        var = torch.clamp_min(torch.reciprocal(invstd * invstd) - bn.eps,
                              0.0)
        bn.running_mean.copy_((1 - m) * bn.running_mean + m * mean)
        bn.running_var.copy_((1 - m) * bn.running_var + m * var)
        bn.num_batches_tracked.add_(1)
    return y


def _parent_forward(model, x_nhwc):
    """The ResNet's train-mode forward as the port composed it before
    ``bn_act``: BN, the residual add and ReLU as separate torch ops."""
    x = x_nhwc.permute(0, 3, 1, 2).contiguous()
    x = model.maxpool(torch.relu(_parent_bn(model.bn1, model.conv1(x))))
    for i in range(1, len(model.stage_sizes) + 1):
        for block in getattr(model, f"layer{i}"):
            y = torch.relu(_parent_bn(block.bn1, block.conv1(x)))
            if isinstance(block, tr.Bottleneck):
                y = torch.relu(_parent_bn(block.bn2, block.conv2(y)))
                y = _parent_bn(block.bn3, block.conv3(y))
            else:
                y = _parent_bn(block.bn2, block.conv2(y))
            residual = x
            if block.downsample is not None:
                conv, bn = block.downsample
                residual = _parent_bn(bn, conv(x))
            x = torch.relu(y + residual)
    return x.mean(dim=(2, 3))


def _bn_buffers(model):
    return {k: v.clone() for k, v in model.state_dict().items()
            if "running" in k or "num_batches" in k}


def _frozen(name, dtype, seed):
    model = tr.build_resnet(name, 64).train()
    g = torch.Generator().manual_seed(seed)
    model.reset_parameters(g)
    model.requires_grad_(False)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, tr.BatchNorm):
                m.weight.uniform_(0.5, 1.5, generator=g)
                m.bias.uniform_(-0.2, 0.2, generator=g)
                m.running_var.uniform_(0.5, 1.5, generator=g)
            elif isinstance(m, torch.nn.Conv2d):
                m.to(dtype)
    return model


@pytest.mark.parametrize("case,want", [
    ("frozen_no_grad", True), ("frozen_grad_enabled", True),
    ("fine_tune", False), ("trainable_under_no_grad", True),
    ("input_needs_grad", False), ("eval", False), ("group", False),
    ("recomputation", False)])
def test_bn_act_takes_the_fused_pass_only_without_gradient(case, want):
    """``fused`` — the frozen backbone's train-mode BN (no gradient
    needed: the trainer's ``_features(grad=False)``) takes the fused pass
    on the card; fine-tuning, eval mode, a global-statistics group and a
    checkpointed block's recomputation keep the module's path."""
    bn = tr.BatchNorm(8).train()
    bn.requires_grad_(case in ("fine_tune", "trainable_under_no_grad"))
    x = torch.randn(2, 8, 3, 3, requires_grad=case == "input_needs_grad")
    if case == "eval":
        bn.eval()
    elif case == "group":
        bn.stats_group = object()
    elif case == "recomputation":
        bn.update_stats = False
    grad = case in ("frozen_grad_enabled", "fine_tune", "input_needs_grad",
                    "eval", "group", "recomputation")
    with torch.set_grad_enabled(grad):
        assert tr.fused(bn, x) is want


def _cl(t):
    return t.contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("case,want", [
    ("bf16", True), ("f32", True), ("f32_residual", True),
    ("one_by_one_nchw", True), ("nchw", True), ("nchw_residual", True),
    ("strided", False), ("f16", False),
    ("f64", False), ("three_dims", False), ("empty", False),
    ("residual_nchw", False), ("residual_dtype", False),
    ("residual_shape", False), ("bf16_params", False),
    ("bf16_running_stats", False)])
def test_kernel_takes_only_channels_last_bf16_or_f32(case, want):
    """``kernel_takes``, what ``batchnorm_act`` holds a card tensor to:
    channels-last or plain contiguous NCHW bf16 or f32, a residual in x's
    layout, f32 BN tensors; it raises for anything else."""
    bn = tr.BatchNorm(6)
    x = _cl(torch.randn(2, 6, 4, 4)).to(torch.float32)
    residual = None
    if case == "bf16":
        x = x.to(torch.bfloat16)
    elif case == "f32_residual":
        residual = _cl(torch.randn(2, 6, 4, 4))
    elif case == "one_by_one_nchw":
        x = torch.randn(2, 6, 1, 1)
    elif case == "nchw":
        x = x.contiguous()
    elif case == "nchw_residual":
        x = x.contiguous()
        residual = torch.randn(2, 6, 4, 4)
    elif case == "strided":
        x = x[:, :, :, ::2]
    elif case in ("f16", "f64"):
        x = x.to(torch.float16 if case == "f16" else torch.float64)
    elif case == "three_dims":
        x = torch.randn(2, 6, 4)
    elif case == "empty":
        x = _cl(torch.randn(0, 6, 4, 4))
    elif case == "residual_nchw":
        residual = torch.randn(2, 6, 4, 4)
    elif case == "residual_dtype":
        residual = _cl(torch.randn(2, 6, 4, 4)).to(torch.bfloat16)
    elif case == "residual_shape":
        residual = _cl(torch.randn(2, 6, 2, 2))
    elif case == "bf16_params":
        bn.to(torch.bfloat16)
        bn.num_batches_tracked = bn.num_batches_tracked.long()
    elif case == "bf16_running_stats":
        bn.running_var = bn.running_var.to(torch.bfloat16)
    from situation_recognition_tpu_torch.ops import batchnorm

    assert batchnorm.kernel_takes(x, bn, residual) is want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["relu", "residual_relu", "neither"])
def test_twin_is_the_parent_composition_bit_for_bit(dtype, mode):
    """The twin (``batchnorm_act_reference``, the card kernels' reference)
    against the port's earlier composition: output, running statistics and
    batch count bit-equal."""
    from situation_recognition_tpu_torch.ops import batchnorm

    g = torch.Generator().manual_seed(7)
    x = (torch.randn(3, 16, 5, 5, generator=g) * 1.7 + 0.4).to(dtype)
    residual = None
    if mode == "residual_relu":
        residual = torch.randn(3, 16, 5, 5, generator=g).to(dtype)
    relu = mode != "neither"
    bns = []
    for _ in range(2):
        bn = tr.BatchNorm(16).train()
        with torch.no_grad():
            bn.weight.copy_(torch.linspace(0.5, 1.5, 16))
            bn.bias.copy_(torch.linspace(-0.3, 0.3, 16))
            bn.running_mean.copy_(torch.linspace(-1, 1, 16))
        bns.append(bn)
    with torch.no_grad():
        got = batchnorm.batchnorm_act_reference(x.clone(), bns[0], residual,
                                                relu)
        want = _parent_bn(bns[1], x.clone())
        if residual is not None:
            want = want + residual
        if relu:
            want = torch.relu(want)
    assert got.dtype == dtype
    assert torch.equal(got, want)
    for a, b in zip(bns[0].buffers(), bns[1].buffers()):
        assert torch.equal(a, b)
    assert int(bns[0].num_batches_tracked) == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["mini", "resnet18"])
def test_frozen_train_forward_is_the_parent_composition(name, dtype,
                                                        monkeypatch):
    """A frozen backbone's train-mode forward on the CPU (the trainer's
    features without a gradient), Bottleneck and BasicBlock stacks: no BN
    goes to the card's ``batchnorm_act``, and the features and every BN
    buffer are bit-equal to the earlier composition's."""
    from situation_recognition_tpu_torch.ops import batchnorm

    got_model, want_model = (_frozen(name, dtype, 4) for _ in range(2))
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 32, 32, 3)).astype(np.float32)).to(dtype)
    calls = []
    act = batchnorm.batchnorm_act
    monkeypatch.setattr(batchnorm, "batchnorm_act",
                        lambda *a, **k: calls.append(1) or act(*a, **k))
    with torch.no_grad():
        got = got_model(x)
        want = _parent_forward(want_model, x)
    assert not calls
    assert torch.equal(got, want)
    got_buf, want_buf = _bn_buffers(got_model), _bn_buffers(want_model)
    assert list(got_buf) == list(want_buf)
    for k in got_buf:
        assert torch.equal(got_buf[k], want_buf[k]), k


def test_batchnorm_act_raises_off_the_card():
    """``batchnorm_act`` has no CPU branch: a CPU tensor is refused before
    anything runs, and the running statistics stay as they were."""
    from situation_recognition_tpu_torch.ops import batchnorm

    bn = tr.BatchNorm(8).train()
    x = _cl(torch.randn(2, 8, 3, 3))
    with torch.no_grad(), pytest.raises(ValueError, match="device cpu"):
        batchnorm.batchnorm_act(x, bn)
    assert int(bn.num_batches_tracked) == 0
    assert torch.equal(bn.running_mean, torch.zeros(8))
