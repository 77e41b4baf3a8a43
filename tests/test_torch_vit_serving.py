"""The ViT slice as a whole on the CPU: a ``vit_tiny`` serving artifact
(export → load → serve / gt) against the JAX package's eval transform +
ViT + FCGGNN head on the same weights, and the port's ``Trainer`` with a
``vit_tiny`` backbone in lockstep with the JAX ``Trainer`` (f32, dropout
0, masked GGNN, batch 8)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from situation_recognition_tpu.data.encoder import (
    ImsituEncoder as JaxEncoder)
from situation_recognition_tpu.data.transforms import eval_transform as jax_eval
from situation_recognition_tpu.models.fcggnn import FCGGNNHead as JaxHead
from situation_recognition_tpu.models.vit import vit_tiny as jax_vit_tiny
from situation_recognition_tpu.train import (
    Trainer as JaxTrainer, TrainerConfig as JaxConfig)
from situation_recognition_tpu_torch import convert
from situation_recognition_tpu_torch.data.encoder import ImsituEncoder
from situation_recognition_tpu_torch.serving import (
    SituationModel, export_inference, load_inference)
from situation_recognition_tpu_torch.train import Trainer, TrainerConfig

HIDDEN = 64
# f32 on both sides through the resize, 2 encoder blocks and the head
TOL = dict(rtol=1e-4, atol=1e-4)
# the lockstep bounds of tests/test_torch_train.py
LOSS_TOL = dict(rtol=2e-4, atol=1e-6)
PARAM_TOL = dict(rtol=2e-3, atol=2e-5)
B = 8


@pytest.fixture(scope="module")
def jax_model():
    enc = ImsituEncoder.synthetic_full(0)
    vit = jax_vit_tiny()
    rng = np.random.default_rng(0)
    vparams = jax.tree.map(
        lambda a: (np.asarray(a) + rng.standard_normal(a.shape) * 0.02)
        .astype(np.float32),
        vit.init(jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3)))
        ["params"])
    head = JaxHead(enc.get_num_verbs(), enc.get_num_roles(),
                   enc.get_num_labels(), enc.max_role_count, hidden=HIDDEN)
    hparams = jax.tree.map(np.asarray, head.init(
        jax.random.PRNGKey(1), jnp.zeros((2, HIDDEN)),
        jnp.zeros((2,), jnp.int32), jnp.asarray(enc.role_ids),
        jnp.asarray(enc.role_mask))["params"])
    return enc, vit, vparams, head, hparams


def _jax_serve(jax_model, images, gt_verbs=None):
    enc, vit, vparams, head, hparams = jax_model
    feats = vit.apply({"params": vparams}, jax_eval(jnp.asarray(images)))
    v = {"params": hparams}
    tables = (jnp.asarray(enc.role_ids), jnp.asarray(enc.role_mask))
    verb_logits = head.apply(v, feats, method=head.predict_verb)
    verb_ids = jnp.argmax(verb_logits, axis=1) if gt_verbs is None \
        else jnp.asarray(gt_verbs)
    nouns = head.apply(v, feats, verb_ids, *tables,
                       method=head.predict_nouns)
    return np.asarray(verb_logits), np.asarray(verb_ids), np.asarray(nouns)


def test_vit_artifact_round_trip_matches_jax(jax_model, tmp_path):
    enc, _, vparams, _, hparams = jax_model
    model = SituationModel(enc, backbone="vit_tiny", hidden=HIDDEN)
    model.backbone.load_state_dict(convert.vit_state_from_jax(vparams),
                                   strict=True)
    model.head.load_state_dict(convert.head_state_from_jax(hparams),
                               strict=True)
    path = str(tmp_path / "art")
    export_inference(model, path, batch_size=2)
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    assert (meta["backbone"], meta["hidden"], meta["image_size"]) == (
        "vit_tiny", HIDDEN, 224)
    fn = load_inference(path, device="cpu")
    assert fn.model.backbone.resolved_impl("cpu") == "plain"
    images = np.random.default_rng(3).integers(0, 256, (3, 256, 256, 3),
                                               dtype=np.uint8)
    verb_logits, verb_ids, nouns = (x.numpy() for x in fn(images))
    want = _jax_serve(jax_model, images)
    np.testing.assert_allclose(verb_logits, want[0], **TOL)
    np.testing.assert_array_equal(verb_ids, want[1])
    np.testing.assert_allclose(nouns, want[2], **TOL)
    gt = np.array([5, 17, 400])
    np.testing.assert_allclose(fn.gt(images, gt).numpy(),
                               _jax_serve(jax_model, images, gt)[2], **TOL)
    # a forced kernel path at f32 is refused at load
    with pytest.raises(ValueError, match="forced"):
        load_inference(path, device="cpu", block_impl="kernel")


def _batch(enc, n, seed):
    rng = np.random.default_rng(seed)
    verbs = rng.integers(0, enc.get_num_verbs(), n)
    n_labels = enc.get_num_labels()
    labels = rng.integers(0, n_labels, (n, 3, enc.max_role_count))
    real = np.arange(enc.max_role_count)[None, None, :] \
        < enc.role_counts[verbs][:, None, None]
    return {"images": rng.integers(0, 256, (n, 256, 256, 3),
                                   dtype=np.uint8),
            "flip": rng.random(n) < 0.5,
            "verbs": verbs.astype(np.int32),
            "labels": np.where(real, labels, n_labels).astype(np.int32)}


def test_vit_trainer_lockstep_with_jax():
    """Two train steps (the second on a short batch wrapped to B rows) and
    an eval step: losses, top-k and head parameters as the JAX trainer's;
    the ViT stays frozen."""
    jenc = JaxEncoder.synthetic_full(0)
    tenc = ImsituEncoder.synthetic_full(0)
    common = dict(hidden=HIDDEN, batch_size=B, backbone="vit_tiny",
                  lr=0.002, dropout_rate=0.0, ggnn_impl="masked")
    jtr = JaxTrainer(jenc, JaxConfig(compute_dtype=jnp.float32, **common))
    vstate = convert.vit_state_from_jax(jax.tree.map(np.asarray,
                                                     jtr.backbone_params))
    ttr = Trainer(tenc, TrainerConfig(compute_dtype=torch.float32, **common),
                  device="cpu", backbone_state=vstate,
                  head_state=convert.head_state_from_jax(
                      jax.tree.map(np.asarray, jtr.head_params)))
    assert ttr.backbone.resolved_impl(ttr.device) == "plain"
    assert ttr.backbone.dtype == torch.float32
    for i, n in enumerate((B, 5)):
        batch = _batch(jenc, n, seed=20 + i)
        arrays, valid, n_real = jtr._pad_batch(batch)
        dev = {k: jax.device_put(v, jtr._bsh) for k, v in arrays.items()}
        key = jax.random.fold_in(jtr._dropout_base, jtr.step_count)
        (jtr.head_params, jtr.opt_state, jtr.backbone_stats, jl,
         jk) = jtr._train_step(
            jtr.head_params, jtr.opt_state, jtr.backbone_params,
            jtr.backbone_stats, key, dev["images"], dev["flip"],
            dev["verbs"], dev["labels"], jax.device_put(valid, jtr._bsh))
        jtr.step_count += 1
        args, _ = ttr._upload(batch)
        tl, tk = ttr.train_step(*args)
        ttr.step_count += 1
        np.testing.assert_allclose(tl.numpy(), [float(x) for x in jl],
                                   **LOSS_TOL, err_msg=f"losses, step {i}")
        for a, b in zip(tk, jk):
            np.testing.assert_array_equal(a.numpy()[:n_real],
                                          np.asarray(b)[:n_real])
    got = jax.tree_util.tree_leaves_with_path(
        convert.head_params_to_jax(ttr.head.state_dict()))
    want = dict(jax.tree_util.tree_leaves_with_path(
        jax.tree.map(np.asarray, jtr.head_params)))
    for path, leaf in got:
        np.testing.assert_allclose(leaf, want[path], **PARAM_TOL,
                                   err_msg=str(path))
    for k, v in ttr.backbone.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), vstate[k].numpy())

    batch = _batch(jenc, B, seed=30)
    arrays, valid, _ = jtr._pad_batch(batch)
    jl, _ = jtr._eval_step(jtr.head_params, jtr.backbone_params,
                           jtr.backbone_stats, arrays["images"],
                           arrays["verbs"], arrays["labels"], valid)
    (imgs, _, verbs, labels, tvalid), _ = ttr._upload(batch)
    tl, _ = ttr.eval_step(imgs, verbs, labels, tvalid)
    np.testing.assert_allclose(tl.numpy(), [float(x) for x in jl],
                               **LOSS_TOL)


def test_trainer_image_size_checks():
    enc = ImsituEncoder.synthetic_full(0)
    with pytest.raises(ValueError, match="not divisible"):
        Trainer(enc, TrainerConfig(hidden=HIDDEN, batch_size=2,
                                   backbone="vit_tiny", image_size=200),
                device="cpu")
    with pytest.raises(ValueError, match=">= 32"):
        Trainer(enc, TrainerConfig(hidden=HIDDEN, batch_size=2,
                                   backbone="mini", image_size=16),
                device="cpu")
