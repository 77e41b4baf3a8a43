"""The serving slice as a whole on the CPU: export → load → serve through
the port, against the JAX package's eval_transform + ResNet.apply +
FCGGNNHead.predict_verb / predict_nouns on the same weights; then the
DynamicBatcher and the HTTP handler over the loaded artifact."""

import concurrent.futures as cf
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from situation_recognition_tpu.data.transforms import eval_transform as jax_eval
from situation_recognition_tpu.models.fcggnn import FCGGNNHead as JaxHead
from situation_recognition_tpu.models.resnet import ResNet as JaxResNet
from situation_recognition_tpu_torch import convert
from situation_recognition_tpu_torch.data.encoder import ImsituEncoder
from situation_recognition_tpu_torch.ops import ggnn_kernel
from situation_recognition_tpu_torch.server import DynamicBatcher, _Handler
from situation_recognition_tpu_torch.serving import (
    SituationModel, _over_chunks, export_inference, load_inference)

HIDDEN = 64
# f32 on both sides through a 13-layer ResNet and the head
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def jax_model():
    """JAX mini ResNet + FCGGNN head at f32 with random BN statistics,
    and the full synthetic vocabulary."""
    enc = ImsituEncoder.synthetic_full(0)
    backbone = JaxResNet(stage_sizes=(1, 1, 1, 1), base_width=HIDDEN // 32)
    bvars = backbone.init(jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3)),
                          train=False)
    bparams = jax.tree.map(np.asarray, bvars["params"])
    rng = np.random.default_rng(0)
    bstats = jax.tree.map(
        lambda s: (rng.uniform(0.5, 1.5, s.shape) if s.ndim else s)
        .astype(np.float32), jax.tree.map(np.asarray, bvars["batch_stats"]))
    head = JaxHead(enc.get_num_verbs(), enc.get_num_roles(),
                   enc.get_num_labels(), enc.max_role_count, hidden=HIDDEN)
    hparams = jax.tree.map(np.asarray, head.init(
        jax.random.PRNGKey(1), jnp.zeros((2, HIDDEN)),
        jnp.zeros((2,), jnp.int32), jnp.asarray(enc.role_ids),
        jnp.asarray(enc.role_mask))["params"])
    return enc, backbone, bparams, bstats, head, hparams


def _jax_serve(jax_model, images, gt_verbs=None):
    enc, backbone, bparams, bstats, head, hparams = jax_model
    x = jax_eval(jnp.asarray(images))
    feats = backbone.apply({"params": bparams, "batch_stats": bstats}, x,
                           train=False)
    v = {"params": hparams}
    tables = (jnp.asarray(enc.role_ids), jnp.asarray(enc.role_mask))
    verb_logits = head.apply(v, feats, method=head.predict_verb)
    verb_ids = jnp.argmax(verb_logits, axis=1) if gt_verbs is None \
        else jnp.asarray(gt_verbs)
    nouns = head.apply(v, feats, verb_ids, *tables,
                       method=head.predict_nouns)
    return np.asarray(verb_logits), np.asarray(verb_ids), np.asarray(nouns)


@pytest.fixture(scope="module")
def artifact(jax_model, tmp_path_factory):
    enc, _, bparams, bstats, _, hparams = jax_model
    model = SituationModel(enc, backbone="mini", hidden=HIDDEN)
    backbone_sd, head_sd = convert.from_jax(bparams, bstats, hparams)
    model.backbone.load_state_dict(backbone_sd, strict=True)
    model.head.load_state_dict(head_sd, strict=True)
    path = str(tmp_path_factory.mktemp("torch_artifact") / "art")
    export_inference(model, path, batch_size=2)
    return path


def _images(b, seed):
    return np.random.default_rng(seed).integers(0, 256, (b, 256, 256, 3),
                                                dtype=np.uint8)


def test_export_meta_has_the_jax_keys(artifact):
    with open(os.path.join(artifact, "meta.json")) as f:
        meta = json.load(f)
    for key in ("format_version", "entries", "batch_size", "image_size",
                "verb_list", "label_list", "roles_per_verb", "backbone",
                "hidden", "num_verbs", "num_labels", "max_role_count"):
        assert key in meta, key
    assert set(meta["entries"]) == {"argmax", "gt"}
    assert meta["batch_size"] == 2 and meta["num_labels"] == 2001


def test_served_batch_of_3_matches_jax(jax_model, artifact):
    """Batch 3 through an artifact baked at 2: two chunks, the second
    zero-padded (_over_chunks)."""
    fn = load_inference(artifact, device="cpu")
    assert fn.batch_size == 2
    images = _images(3, 1)
    verb_logits, verb_ids, nouns = fn(images)
    assert verb_logits.shape == (3, 504) and nouns.shape == (3, 6, 2001)
    jv, jids, jn = _jax_serve(jax_model, images)
    np.testing.assert_allclose(verb_logits.numpy(), jv, **TOL)
    np.testing.assert_array_equal(verb_ids.numpy(), jids)
    np.testing.assert_allclose(nouns.numpy(), jn, **TOL)


def test_gt_entry_matches_jax(jax_model, artifact):
    fn = load_inference(artifact, device="cpu")
    images = _images(3, 2)
    verbs = np.array([5, 400, 77], np.int32)
    got = fn.gt(images, verbs)
    _, _, jn = _jax_serve(jax_model, images, gt_verbs=verbs)
    np.testing.assert_allclose(got.numpy(), jn, **TOL)


def test_over_chunks_equals_exact_batches(artifact):
    fn = load_inference(artifact, device="cpu")
    images = _images(5, 3)
    whole = fn(images)
    parts = [fn(images[i:i + 2]) for i in (0, 2)] + [fn(images[4:5])]
    for k in range(3):
        cat = torch.cat([p[k] for p in parts])
        np.testing.assert_allclose(whole[k].numpy(), cat.numpy(),
                                   rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError):
        _over_chunks(lambda *a: a, 2, (torch.zeros(3), torch.zeros(2)))


def test_kernel_impl_serves_through_the_twin_on_cpu(artifact):
    """ggnn_impl='kernel' on the CPU runs the kernel's plain twin (bf16
    inside); it must stay close to the f32 masked path and launch
    nothing."""
    masked = load_inference(artifact, device="cpu")
    kernel = load_inference(artifact, device="cpu", ggnn_impl="kernel")
    assert kernel.model.head.ggsnn.impl == "kernel"
    before = ggnn_kernel.folded_rows.launches
    images = _images(2, 4)
    a, b = masked(images), kernel(images)
    assert ggnn_kernel.folded_rows.launches == before
    np.testing.assert_allclose(b[0].numpy(), a[0].numpy(), atol=0.1)


def test_dynamic_batcher_matches_direct_call(artifact):
    fn = load_inference(artifact, device="cpu")
    images = _images(4, 5)
    direct = fn(images)
    batcher = DynamicBatcher(fn, max_batch=4, max_wait_ms=200)
    try:
        with cf.ThreadPoolExecutor(4) as pool:
            futs = list(pool.map(batcher.submit, images))
        rows = [f.result(timeout=60) for f in futs]
        gt = batcher.submit_gt(images[0], 9).result(timeout=60)
    finally:
        batcher.close()
    for i, row in enumerate(rows):
        np.testing.assert_allclose(row["verb_logits"],
                                   direct[0][i].numpy(), rtol=1e-5,
                                   atol=1e-5)
        assert row["verb_id"] == int(direct[1][i])
        np.testing.assert_allclose(row["noun_logits"],
                                   direct[2][i].numpy(), rtol=1e-5,
                                   atol=1e-5)
    want_gt = fn.gt(images[:1], np.array([9]))[0].numpy()
    np.testing.assert_allclose(gt["noun_logits"], want_gt, rtol=1e-5,
                               atol=1e-5)
    assert batcher.stats["requests"] == 5


def test_http_handler_predicts(artifact):
    import io

    from PIL import Image

    fn = load_inference(artifact, device="cpu")
    batcher = DynamicBatcher(fn, max_wait_ms=0)
    try:
        logic = _Handler(batcher, fn.meta)
        buf = io.BytesIO()
        Image.fromarray(_images(1, 6)[0]).save(buf, format="PNG")
        status, body = logic.predict(buf.getvalue())
        assert status == 200
        assert body["verb"] in fn.meta["verb_list"]
        status, body = logic.predict(buf.getvalue(), verb="v3")
        assert status == 200 and body["verb_prob"] == 1.0
        assert len(body["roles"]) == len(fn.meta["roles_per_verb"]["v3"])
        assert logic.get("/healthz")[0] == 200
    finally:
        batcher.close()


def test_served_bf16_resnet_keeps_batchnorm_in_f32(tmp_path):
    """A bf16 ResNet artifact runs its convolutions in bf16 and normalises
    with f32 BatchNorm, as the JAX serving (every 1-D leaf f32) and the
    port's Trainer do: its BN tensors stay f32, and its features equal the
    frozen Trainer's eval features on the same weights and images (the
    same casts and layout on the CPU, so bit for bit).  Running means of
    σ = 3 make a bf16 cast of the statistics visible."""
    from situation_recognition_tpu_torch.train import Trainer, TrainerConfig

    enc = ImsituEncoder.synthetic_full(0)
    model = SituationModel(enc, backbone="mini", hidden=HIDDEN,
                           dtype=torch.bfloat16)
    gen = torch.Generator().manual_seed(3)
    model.backbone.reset_parameters(gen)
    model.head.reset_parameters(gen)
    rng = np.random.default_rng(3)
    bns = [m for m in model.backbone.modules()
           if isinstance(m, torch.nn.BatchNorm2d)]
    assert bns
    with torch.no_grad():
        for bn in bns:
            c = bn.num_features
            for t, draw in ((bn.running_mean, rng.normal(0.0, 3.0, c)),
                            (bn.running_var, rng.uniform(0.5, 1.5, c)),
                            (bn.weight, rng.uniform(0.5, 1.5, c)),
                            (bn.bias, rng.normal(0.0, 0.5, c))):
                t.copy_(torch.from_numpy(draw))
    path = str(tmp_path / "art")
    export_inference(model, path, batch_size=2)
    fn = load_inference(path, device="cpu")
    served = [m for m in fn.model.backbone.modules()
              if isinstance(m, torch.nn.BatchNorm2d)]
    assert len(served) == len(bns)
    for bn in served:
        for t in (bn.weight, bn.bias, bn.running_mean, bn.running_var):
            assert t.dtype == torch.float32
    convs = [m for m in fn.model.backbone.modules()
             if isinstance(m, torch.nn.Conv2d)]
    assert convs and all(m.weight.dtype == torch.bfloat16 for m in convs)

    state = torch.load(os.path.join(path, "weights.pt"), weights_only=True)
    trainer = Trainer(enc, TrainerConfig(
        hidden=HIDDEN, batch_size=2, backbone="mini",
        compute_dtype=torch.bfloat16), device="cpu",
        backbone_state=state["backbone"], head_state=state["head"])
    images = torch.from_numpy(_images(2, 7))
    want = trainer._features(images, None, False)
    with torch.inference_mode():
        got = fn.model.features(images)
    assert got.dtype == want.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=0, atol=0)
