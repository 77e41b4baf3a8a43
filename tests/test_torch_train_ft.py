"""The port's ``Trainer`` with ``train_backbone`` (fine-tuning) on the
CPU: in lockstep with the JAX ``Trainer``'s ``train_step_ft`` (mini and
vit_tiny, f32, dropout 0, masked GGNN, train-mode BN, batch 8, with and
without ``remat_backbone``), and the fine-tuning semantics that
``tests/test_train_backbone.py`` pins for the JAX package: the backbone
moves and its forward is the frozen one's, ``backbone_lr=0`` freezes it
exactly, ``backbone_lr`` scales Adamax exactly, and ``backbone_lr`` with
``lr=0`` raises.

Bounds: losses rtol 2e-4 and head parameters rtol 2e-3 / atol 2e-5 (the
lockstep bounds of ``tests/test_torch_train.py``), BN statistics rtol /
atol 1e-5.  The backbone's parameters are held to the head's bound too,
with two exceptions that Adamax makes: it moves an element by about
``lr`` a step whatever its gradient's size, so an element whose gradient
is near zero moves by an amount that rounding decides.  The key bias's
gradient is exactly zero in truth (softmax does not see a per-query shift
of the scores), so both sides move it by cancellation noise; and a few
other elements (at most 0.1% of a tensor) have gradients near zero.
Those are held to 2·lr, what two steps can move an element."""

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
from situation_recognition_tpu_torch.train import Trainer, TrainerConfig

B, HIDDEN, LR = 8, 64, 0.002
LOSS_TOL = dict(rtol=2e-4, atol=1e-6)
PARAM_TOL = dict(rtol=2e-3, atol=2e-5)
STATS_TOL = dict(rtol=1e-5, atol=1e-5)
STATS = ("running_mean", "running_var")


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


def _config(**kw):
    base = dict(hidden=HIDDEN, batch_size=B, backbone="mini", lr=LR,
                dropout_rate=0.0, ggnn_impl="masked", train_backbone=True,
                compute_dtype=torch.float32)
    base.update(kw)
    return TrainerConfig(**base)


def _trainer(**kw):
    return Trainer(ImsituEncoder.synthetic_full(0), _config(**kw),
                   device="cpu")


def _port_state(jtr, backbone):
    """The JAX trainer's backbone (and BN statistics) in the port's
    layout."""
    params, stats = jax.tree.map(
        np.asarray, (jtr.backbone_params, jtr.backbone_stats))
    if backbone == "mini":
        return convert.resnet_state_from_jax(params, stats)
    return convert.vit_state_from_jax(params)


def _step(tr, batch):
    args, _ = tr._upload(batch)
    losses, topk = tr.train_step(*args)
    tr.step_count += 1
    return losses.numpy(), topk


def _assert_backbone_close(got, want, width):
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        g, w = got[k].float().numpy(), w.float().numpy()
        if k.endswith(STATS):
            np.testing.assert_allclose(g, w, **STATS_TOL, err_msg=k)
            continue
        diff = np.abs(g - w)
        assert diff.max() <= 2 * LR, (k, diff.max())
        close = diff <= PARAM_TOL["atol"] + PARAM_TOL["rtol"] * np.abs(w)
        if k.endswith("in_proj_bias"):
            close = np.delete(close, np.s_[width:2 * width])   # the key bias
        assert close.mean() >= 0.999, (k, 1 - close.mean())


@pytest.mark.parametrize("backbone,remat", [
    ("mini", False), ("mini", True), ("vit_tiny", False),
    ("vit_tiny", True)])
def test_ft_trainer_lockstep_with_jax(backbone, remat):
    """Two fine-tuning steps (the second on a short batch wrapped to B
    rows) from the same weights and batches as the JAX trainer's
    ``train_step_ft``: losses, top-k, head and backbone parameters and BN
    statistics."""
    jenc = JaxEncoder.synthetic_full(0)
    common = dict(hidden=HIDDEN, batch_size=B, backbone=backbone, lr=LR,
                  dropout_rate=0.0, ggnn_impl="masked", train_backbone=True,
                  remat_backbone=remat)
    jtr = JaxTrainer(jenc, JaxConfig(compute_dtype=jnp.float32, **common))
    ttr = Trainer(ImsituEncoder.synthetic_full(0),
                  TrainerConfig(compute_dtype=torch.float32, **common),
                  device="cpu", backbone_state=_port_state(jtr, backbone),
                  head_state=convert.head_state_from_jax(
                      jax.tree.map(np.asarray, jtr.head_params)))
    assert ttr.backbone.remat == remat
    for i, n in enumerate((B, 5)):
        batch = _batch(jenc, n, seed=10 + i)
        arrays, valid, n_real = jtr._pad_batch(batch)
        key = jax.random.fold_in(jtr._dropout_base, jtr.step_count)
        tp, jtr.opt_state, jtr.backbone_stats, jl, jk = jtr._train_step_ft(
            jtr._trainable(), jtr.opt_state, jtr.backbone_stats, key,
            arrays["images"], arrays["flip"], arrays["verbs"],
            arrays["labels"], valid)
        jtr.head_params, jtr.backbone_params = tp["head"], tp["backbone"]
        jtr.step_count += 1
        tl, tk = _step(ttr, batch)
        np.testing.assert_allclose(tl, [float(x) for x in jl], **LOSS_TOL,
                                   err_msg=f"losses, step {i}")
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
    _assert_backbone_close(ttr.backbone.state_dict(),
                           _port_state(jtr, backbone), HIDDEN)


def _max_delta(a: dict, b: dict) -> float:
    return max((a[k].float() - b[k].float()).abs().max().item()
               for k in a if not k.endswith(STATS + ("num_batches_tracked",)))


def _state(module) -> dict:
    return {k: v.clone() for k, v in module.state_dict().items()}


def test_ft_step_moves_the_backbone_and_its_forward_is_the_frozen_one():
    """One step: the losses are the frozen trainer's (the same forward
    until the update lands), the backbone moves, and by at most lr (the
    first Adamax step moves every weight with a gradient by lr)."""
    ft, frozen = _trainer(), _trainer(train_backbone=False)
    assert all(p.requires_grad for p in ft.backbone.parameters())
    assert not any(p.requires_grad for p in frozen.backbone.parameters())
    assert all(p.dtype == torch.float32 for p in ft.backbone.parameters())
    before = _state(ft.backbone)
    batch = _batch(JaxEncoder.synthetic_full(0), B, seed=3)
    np.testing.assert_allclose(_step(ft, batch)[0], _step(frozen, batch)[0],
                               rtol=1e-6)
    d = _max_delta(_state(ft.backbone), before)
    assert 1e-4 < d <= LR + 1e-6, d
    assert _max_delta(_state(frozen.backbone), before) == 0.0


def test_backbone_lr_zero_freezes_the_backbone_exactly():
    tr = _trainer(backbone_lr=0.0)
    before = _state(tr.backbone)
    head = _state(tr.head)
    _step(tr, _batch(JaxEncoder.synthetic_full(0), B, seed=4))
    assert _max_delta(_state(tr.backbone), before) == 0.0
    assert _max_delta(_state(tr.head), head) > 1e-4


def test_backbone_lr_is_exact_adamax_scaling():
    """backbone_lr = q·lr: on the first step Adamax moves every weight
    with a gradient by its group's rate, so the backbone's largest move is
    q·lr and the head's lr; the groups' rates are ``current_lr()`` times
    1 and q."""
    q = 0.25
    tr = _trainer(backbone_lr=q * LR)
    assert [g["lr"] for g in tr.optimizer.param_groups] == [LR, q * LR]
    bb, head = _state(tr.backbone), _state(tr.head)
    _step(tr, _batch(JaxEncoder.synthetic_full(0), B, seed=5))
    np.testing.assert_allclose(_max_delta(_state(tr.backbone), bb), q * LR,
                               rtol=1e-4)
    np.testing.assert_allclose(_max_delta(_state(tr.head), head), LR,
                               rtol=1e-4)


def test_backbone_lr_needs_a_nonzero_lr():
    with pytest.raises(ValueError, match="lr != 0"):
        _trainer(lr=0.0, backbone_lr=1e-3)
    # equal rates need no ratio; a frozen backbone has no group
    assert len(_trainer(lr=0.0, backbone_lr=0.0).optimizer.param_groups) == 2
    assert len(_trainer(train_backbone=False, backbone_lr=1e-3)
               .optimizer.param_groups) == 1


def test_current_lr_follows_the_schedule_in_both_groups():
    """With a warmup the two groups follow the schedule at the
    optimizer-step count (JAX ``current_lr``), the backbone's scaled by
    backbone_lr/lr."""
    from situation_recognition_tpu_torch.train import make_lr_fn

    q = 0.5
    tr = _trainer(backbone_lr=q * LR, warmup_steps=4)
    fn = make_lr_fn(tr.config)
    enc = JaxEncoder.synthetic_full(0)
    for step in range(2):
        assert tr.current_lr() == pytest.approx(fn(step))
        _step(tr, _batch(enc, B, seed=6 + step))
        head_lr, bb_lr = (g["lr"] for g in tr.optimizer.param_groups)
        assert head_lr == pytest.approx(fn(step))
        assert bb_lr == pytest.approx(q * fn(step))
    assert tr.current_lr() == pytest.approx(LR * 3 / 4)


@pytest.mark.parametrize("backbone", ["mini", "vit_tiny"])
def test_remat_backbone_keeps_the_trajectory_and_statistics(backbone):
    """Per-block checkpointing recomputes the same forward: two steps with
    and without ``remat_backbone`` give the same parameters and BN
    statistics, bit for bit (each statistic updated once per step)."""
    trs = [_trainer(backbone=backbone, remat_backbone=r)
           for r in (False, True)]
    assert [t.backbone.remat for t in trs] == [False, True]
    enc = JaxEncoder.synthetic_full(0)
    for step in range(2):
        batch = _batch(enc, B, seed=20 + step)
        losses = [_step(t, batch)[0] for t in trs]
        np.testing.assert_array_equal(*losses)
    for get in (lambda t: t.backbone.state_dict(),
                lambda t: t.head.state_dict()):
        a, b = (get(t) for t in trs)
        for k in a:
            assert torch.equal(a[k], b[k]), k
