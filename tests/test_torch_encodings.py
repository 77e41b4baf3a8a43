"""The serving artifact's weight encodings (f32 / bf16 / int8) against the
JAX package's on the CPU, for a mini ResNet + FCGGNN head (random BN
statistics) and ``vit_tiny`` + head, built from the JAX package's own
parameter trees.  The port's decoded weights must be bit-equal, leaf by
leaf, to ``from_jax(_dequantize_tree(_quantize_tree(tree, w)))`` of the
JAX package's serving (every floating leaf of ndim >= 2 encoded in the
JAX layout: the q/k/v kernels' scale shared by the heads, their (heads,
dh) biases, the position embedding and the CLS token; 1-D leaves f32).
The artifacts' sizes fall f32 > bf16 > int8, and their logits stay within
the JAX package's bounds of the f32 artifact's (``tests/test_serving.py``:
bf16 1%, int8 3% of max |logit|; equal verb ids where the f32 top-2
margin exceeds 2·tol·max).  At depth, with BN statistics from one batch,
the int8 drift of the features is the JAX package's own."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from situation_recognition_tpu.models.fcggnn import FCGGNNHead as JaxHead
from situation_recognition_tpu.models.resnet import ResNet as JaxResNet
from situation_recognition_tpu.models.vit import vit_tiny as jax_vit_tiny
from situation_recognition_tpu.serving import (
    _dequantize_tree, _quantize_tree)
from situation_recognition_tpu_torch import convert
from situation_recognition_tpu_torch.data.encoder import ImsituEncoder
from situation_recognition_tpu_torch.models import resnet as tr
from situation_recognition_tpu_torch.serving import (
    SituationModel, decode_tree, decode_weights, encode_tree,
    export_inference, load_inference)

HIDDEN = 64
BOUNDS = {"bf16": 0.01, "int8": 0.03}
BACKBONES = ("mini", "vit_tiny")
ENCODINGS = ("f32", "bf16", "int8")


def _jax_tree(backbone, enc):
    """The JAX serving's weight tree ``{"backbone": vars, "head":
    {"params"}}`` of random numpy f32 leaves."""
    rng = np.random.default_rng(7)
    if backbone == "mini":
        net = JaxResNet(stage_sizes=(1, 1, 1, 1), base_width=HIDDEN // 32)
        v = net.init(jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3)),
                     train=False)
        bvars = {"params": jax.tree.map(np.asarray, v["params"]),
                 "batch_stats": jax.tree.map(
                     lambda s: rng.uniform(0.5, 1.5, s.shape).astype(
                         np.float32), v["batch_stats"])}
    else:
        params = jax_vit_tiny().init(jax.random.PRNGKey(0),
                                     jnp.zeros((1, 224, 224, 3)))["params"]
        bvars = {"params": jax.tree.map(
            lambda a: (np.asarray(a) + rng.standard_normal(a.shape) * 0.02)
            .astype(np.float32), params)}
    head = JaxHead(enc.get_num_verbs(), enc.get_num_roles(),
                   enc.get_num_labels(), enc.max_role_count, hidden=HIDDEN)
    hparams = jax.tree.map(np.asarray, head.init(
        jax.random.PRNGKey(1), jnp.zeros((2, HIDDEN)),
        jnp.zeros((2,), jnp.int32), jnp.asarray(enc.role_ids),
        jnp.asarray(enc.role_mask))["params"])
    return {"backbone": bvars, "head": {"params": hparams}}


def _port_states(tree):
    """A JAX weight tree (numpy or decoded) → the port's state dicts."""
    tree = jax.tree.map(lambda x: np.asarray(x, np.float32), tree)
    b = tree["backbone"]
    backbone = (convert.vit_state_from_jax(b["params"])
                if "cls_token" in b["params"]
                else convert.resnet_state_from_jax(b["params"],
                                                   b["batch_stats"]))
    return backbone, convert.head_state_from_jax(tree["head"]["params"])


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """Each backbone's JAX tree and its artifact in each encoding (the
    portable programs, f32 compute, batch 2)."""
    enc = ImsituEncoder.synthetic_full(0)
    out = {}
    for backbone in BACKBONES:
        tree = _jax_tree(backbone, enc)
        model = SituationModel(enc, backbone=backbone, hidden=HIDDEN)
        bsd, hsd = _port_states(tree)
        model.backbone.load_state_dict(bsd, strict=True)
        model.head.load_state_dict(hsd, strict=True)
        paths = {}
        for w in ENCODINGS:
            paths[w] = str(tmp_path_factory.mktemp(f"enc_{backbone}") / w)
            export_inference(model, paths[w], batch_size=2, weights=w)
        out[backbone] = (tree, paths)
    return out


@pytest.mark.parametrize("weights", ENCODINGS)
@pytest.mark.parametrize("backbone", BACKBONES)
def test_decoded_weights_equal_the_jax_encoding(exported, backbone,
                                                weights):
    tree, paths = exported[backbone]
    want = _port_states(_dequantize_tree(_quantize_tree(tree, weights)))
    got = decode_weights(paths[weights])
    for g_sd, w_sd in zip(got, want):
        assert set(g_sd) == set(w_sd)
        for k, w in w_sd.items():
            g = g_sd[k]
            if k.endswith("num_batches_tracked"):
                continue
            assert g.dtype == w.dtype == torch.float32, k
            assert torch.equal(g, w), (weights, k)
    if weights != "f32":
        # something was encoded: the largest matrices are not f32 exact
        head = got[1]["nouns_classifier.1.weight"]
        assert not torch.equal(head, _port_states(tree)[1][
            "nouns_classifier.1.weight"])


@pytest.mark.parametrize("backbone", BACKBONES)
def test_sizes_and_logits_within_the_jax_bounds(exported, backbone):
    _, paths = exported[backbone]
    sizes = {w: os.path.getsize(os.path.join(paths[w], "weights.pt"))
             for w in ENCODINGS}
    assert sizes["int8"] < sizes["bf16"] < sizes["f32"], sizes
    rng = np.random.default_rng(2)
    images = rng.integers(0, 256, (3, 256, 256, 3), dtype=np.uint8)
    verbs = np.array([4, 300, 77])
    outs, gts = {}, {}
    for w in ENCODINGS:
        fn = load_inference(paths[w], device="cpu")
        assert fn.meta["weights"] == w
        outs[w] = [o.numpy().astype(np.float32) for o in fn(images)]
        gts[w] = fn.gt(images, verbs).numpy()
    for w, tol in BOUNDS.items():
        for i in (0, 2):
            d = np.abs(outs[w][i] - outs["f32"][i]).max()
            assert d <= tol * np.abs(outs["f32"][i]).max(), (w, i, d)
        vl = outs["f32"][0]
        top2 = np.sort(vl, axis=1)[:, -2:]
        stable = (top2[:, 1] - top2[:, 0]) > 2 * tol * np.abs(vl).max()
        np.testing.assert_array_equal(outs[w][1][stable],
                                      outs["f32"][1][stable])
        assert np.abs(gts[w] - gts["f32"]).max() <= \
            tol * np.abs(gts["f32"]).max()


def test_unknown_encoding_is_refused(exported, tmp_path):
    enc = ImsituEncoder.synthetic_full(0)
    model = SituationModel(enc, backbone="mini", hidden=HIDDEN)
    with pytest.raises(ValueError, match="weights"):
        export_inference(model, str(tmp_path / "bad"), weights="int4")


@pytest.mark.parametrize("stages", [(1, 1, 1, 1), (3, 8, 36, 3)],
                         ids=["mini", "resnet152_depth"])
def test_int8_drift_of_a_deep_random_resnet_is_the_jax_packages(stages):
    """The int8 drift of a random ResNet whose BN statistics come from one
    batch (as the card's flagship's do) is the JAX package's own, at one
    block a stage and at ResNet-152's block counts (width cut to base 2,
    64 px): the port's features from its decoded int8 weights equal JAX's
    from ``_dequantize_tree(_quantize_tree(...))`` within 2^-10 of their
    largest (the depth amplifies the f32 sums' order too), so the two
    drifts from the f32 features agree within 2^-10.  The drifts are
    printed; they grow with depth."""
    net = JaxResNet(stage_sizes=stages, base_width=2)
    v = jax.jit(net.init, static_argnames="train")(
        jax.random.PRNGKey(3), jnp.zeros((1, 64, 64, 3)), train=False)
    params = jax.tree.map(np.asarray, v["params"])
    port = tr.ResNet(stages, base_width=2)
    port.load_state_dict(convert.resnet_state_from_jax(
        params, jax.tree.map(np.asarray, v["batch_stats"])), strict=True)
    rng = np.random.default_rng(5)
    # running statistics = one batch's (momentum 1)
    for bn in port.modules():
        if isinstance(bn, torch.nn.BatchNorm2d):
            bn.momentum = 1.0
    with torch.no_grad():
        port.train()(torch.from_numpy(
            rng.standard_normal((16, 64, 64, 3)).astype(np.float32)))
    sd = port.state_dict()
    tree = {"params": convert.resnet_params_to_jax(sd),
            "batch_stats": convert.resnet_stats_to_jax(sd)}
    x = rng.standard_normal((4, 64, 64, 3)).astype(np.float32)
    apply = jax.jit(net.apply, static_argnames="train")
    f32 = np.asarray(apply(tree, jnp.asarray(x), train=False))
    want = np.asarray(apply(_dequantize_tree(_quantize_tree(tree, "int8")),
                            jnp.asarray(x), train=False))
    dec = decode_tree(encode_tree(tree, "int8"))
    port.load_state_dict(convert.resnet_state_from_jax(
        dec["params"], dec["batch_stats"]), strict=True)
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x)).numpy()
    top = np.abs(f32).max()
    drift_jax = np.abs(want - f32).max() / top
    drift_port = np.abs(got - f32).max() / top
    print(f"int8 drift of the features at {stages}: JAX {drift_jax:.6f}, "
          f"port {drift_port:.6f} of max |f32 feature|")
    assert np.abs(got - want).max() <= 2 ** -10 * np.abs(want).max()
    assert abs(drift_port - drift_jax) <= 2 ** -10
