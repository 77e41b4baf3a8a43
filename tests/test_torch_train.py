"""The port's Trainer in lockstep with the JAX Trainer on the CPU: mini
backbone, f32, dropout 0, masked GGNN, train-mode BN, batch 8, the same
weights (carried across by ``convert.py``) and the same numpy batches.
Bounds are those of ``tests/test_composed_parity.py``'s lockstep test:
losses rtol 2e-4, head parameters rtol 2e-3 / atol 2e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from situation_recognition_tpu.data.encoder import (
    ImsituEncoder as JaxEncoder)
from situation_recognition_tpu.train import (
    Trainer as JaxTrainer, TrainerConfig as JaxConfig)
from situation_recognition_tpu_torch import convert
from situation_recognition_tpu_torch.data.encoder import ImsituEncoder
from situation_recognition_tpu_torch.train import (
    Trainer, TrainerConfig, make_lr_fn)

B = 8
LOSS_TOL = dict(rtol=2e-4, atol=1e-6)
PARAM_TOL = dict(rtol=2e-3, atol=2e-5)
# f32 BN statistics of the same features, reduced in other orders, blended
# by the same EMA
STATS_TOL = dict(rtol=1e-5, atol=1e-5)


class ListLoader(list):
    """The loader interface the JAX trainer's epoch loop reads."""

    start_batch = 0

    def set_epoch(self, epoch):
        pass


def _batch(enc, n, seed):
    rng = np.random.default_rng(seed)
    verbs = rng.integers(0, enc.get_num_verbs(), n)
    n_labels = enc.get_num_labels()
    labels = rng.integers(0, n_labels, (n, 3, enc.max_role_count))
    real = np.arange(enc.max_role_count)[None, None, :] \
        < enc.role_counts[verbs][:, None, None]
    # ignore outside each verb's roles, and now and then inside them
    labels = np.where(real & (rng.random(labels.shape) > 0.1), labels,
                      n_labels)
    return {"images": rng.integers(0, 256, (n, 256, 256, 3),
                                   dtype=np.uint8),
            "flip": rng.random(n) < 0.5,
            "verbs": verbs.astype(np.int32),
            "labels": labels.astype(np.int32)}


@pytest.fixture(scope="module")
def pair():
    jenc = JaxEncoder.synthetic_full(0)
    tenc = ImsituEncoder.synthetic_full(0)
    common = dict(hidden=64, batch_size=B, backbone="mini", lr=0.002,
                  dropout_rate=0.0, ggnn_impl="masked")
    jtr = JaxTrainer(jenc, JaxConfig(compute_dtype=jnp.float32, **common))
    tree = jax.tree.map(np.asarray, (jtr.backbone_params, jtr.backbone_stats,
                                     jtr.head_params))
    bstate, hstate = convert.from_jax(*tree)
    ttr = Trainer(tenc, TrainerConfig(compute_dtype=torch.float32, **common),
                  device="cpu", backbone_state=bstate, head_state=hstate)
    return jenc, jtr, ttr


def _jax_step(jtr, batch):
    arrays, valid, n = jtr._pad_batch(batch)
    dev = {k: jax.device_put(v, jtr._bsh) for k, v in arrays.items()}
    key = jax.random.fold_in(jtr._dropout_base, jtr.step_count)
    (jtr.head_params, jtr.opt_state, jtr.backbone_stats, losses,
     topk) = jtr._train_step(
        jtr.head_params, jtr.opt_state, jtr.backbone_params,
        jtr.backbone_stats, key, dev["images"], dev["flip"], dev["verbs"],
        dev["labels"], jax.device_put(valid, jtr._bsh))
    jtr.step_count += 1
    return np.array([float(x) for x in losses]), [
        np.asarray(x)[:n] for x in topk]


def _port_step(ttr, batch):
    args, n = ttr._upload(batch)
    losses, topk = ttr.train_step(*args)
    ttr.step_count += 1
    return losses.numpy(), [x.numpy()[:n] for x in topk]


def _assert_trees_close(got, want, tol, what):
    gl = jax.tree_util.tree_leaves_with_path(got)
    wl = dict(jax.tree_util.tree_leaves_with_path(want))
    assert len(gl) == len(wl), what
    for path, g in gl:
        np.testing.assert_allclose(g, np.asarray(wl[path]), **tol,
                                   err_msg=f"{what} {path}")


def test_lockstep_train_eval_and_scores(pair):
    jenc, jtr, ttr = pair
    # 3 train steps, the last on a short batch wrapped to B rows
    for i, n in enumerate((B, B, 5)):
        batch = _batch(jenc, n, seed=10 + i)
        jl, jk = _jax_step(jtr, batch)
        tl, tk = _port_step(ttr, batch)
        np.testing.assert_allclose(tl, jl, **LOSS_TOL,
                                   err_msg=f"losses at step {i}")
        for name, a, b in zip(("verb top-5", "noun top-5", "gt top-1"),
                              tk, jk):
            np.testing.assert_array_equal(a, b, err_msg=f"{name}, step {i}")

    _assert_trees_close(convert.head_params_to_jax(ttr.head.state_dict()),
                        jax.tree.map(np.asarray, jtr.head_params),
                        PARAM_TOL, "head params")
    _assert_trees_close(convert.resnet_stats_to_jax(
        ttr.backbone.state_dict()),
        jax.tree.map(np.asarray, jtr.backbone_stats), STATS_TOL,
        "BN statistics")

    # the eval step: eval-mode BN on the updated statistics, 3 branches
    batch = _batch(jenc, 6, seed=20)
    arrays, valid, n = jtr._pad_batch(batch)
    jl, jk = jtr._eval_step(jtr.head_params, jtr.backbone_params,
                            jtr.backbone_stats, arrays["images"],
                            arrays["verbs"], arrays["labels"], valid)
    (imgs, _, verbs, labels, tvalid), tn = ttr._upload(batch)
    tl, tk = ttr.eval_step(imgs, verbs, labels, tvalid)
    np.testing.assert_allclose(tl.numpy(), [float(x) for x in jl],
                               **LOSS_TOL)
    for a, b in zip(tk, jk):
        np.testing.assert_array_equal(a.numpy()[:tn], np.asarray(b)[:n])

    # evaluate: the same score dict, losses and mean of eight
    loader = ListLoader([_batch(jenc, B, seed=30), _batch(jenc, 3, seed=31)])
    j1, j5, jlosses, javg = jtr.evaluate(loader, logging=True)
    t1, t5, tlosses, tavg = ttr.evaluate(loader, logging=True)
    assert t1.get_average_results_both() == j1.get_average_results_both()
    assert t5.get_average_results_both() == j5.get_average_results_both()
    assert len(t1) == len(j1) == B + 3
    assert tavg == javg
    for k in jlosses:
        np.testing.assert_allclose(tlosses[k], jlosses[k], **LOSS_TOL)

    # train_epoch: the same mean losses and scores over an epoch
    loader = ListLoader([_batch(jenc, B, seed=40), _batch(jenc, 7, seed=41)])
    j1, j5, jmean = jtr.train_epoch(loader, 1)
    t1, t5, tmean = ttr.train_epoch(loader, 1)
    np.testing.assert_allclose(tmean, jmean, **LOSS_TOL)
    assert t1.get_average_results_both() == j1.get_average_results_both()
    assert t5.get_average_results_both() == j5.get_average_results_both()
    assert ttr.step_count == jtr.step_count == 5


@pytest.mark.parametrize("kw", [
    {}, {"warmup_steps": 3},
    {"lr_schedule": "cosine", "total_steps": 10},
    {"lr_schedule": "linear", "total_steps": 10, "warmup_steps": 2,
     "min_lr": 1e-4}])
def test_lr_schedule_matches_jax(kw):
    from situation_recognition_tpu.train import make_lr_fn as jax_lr_fn

    tfn = make_lr_fn(TrainerConfig(**kw))
    jfn = jax_lr_fn(JaxConfig(**kw))
    if not kw:
        assert tfn is None and jfn is None
        return
    for c in range(12):
        np.testing.assert_allclose(tfn(c), float(jfn(c)), rtol=1e-6)


def test_trainer_runs_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(ImsituEncoder.synthetic_full(0),
                TrainerConfig(hidden=64, batch_size=2, backbone="mini"))
