"""Gradient accumulation in the port's ``Trainer`` (``grad_accum``) on the
CPU at f32, mini backbone at 64², dropout 0, masked GGNN:

* in lockstep with the JAX ``Trainer``: a group of two microbatches
  through JAX's ``_grad_accum_step`` + ``_grad_accum_final`` (frozen) and
  their ft pair (``train_backbone``), and an epoch whose last group is
  short (JAX ``_apply_pending``), fed the same converted weights and
  batches — losses, head and backbone parameters and BN statistics within
  the lockstep bounds of ``tests/test_torch_train.py``;
* the contract of ``tests/test_grad_accum.py`` and
  ``tests/test_train_backbone.py``, on the port alone: on balanced
  microbatches (every row the same situation; eval-mode BN) accumulation
  equals the big batch, frozen and fine-tuned; an epoch's tail group still
  steps; the schedule ticks once per group;
* a snapshot taken at a group boundary (the only place one is taken)
  resumes to the uninterrupted run bit for bit;
* the folded-weight cache hits between a group's microbatches and misses
  after its step, and the K2/K3 route's parameter gradients add into
  ``.grad`` across microbatches as autograd's do."""

import threading

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
    Preempted, Trainer, TrainerConfig, make_lr_fn)
from tests.test_torch_fit import EpochLoader, _assert_state_equal
from tests.test_torch_train import (
    LOSS_TOL, PARAM_TOL, STATS_TOL, ListLoader, _assert_trees_close,
    _batch)

B, HIDDEN = 8, 64
ENC = ImsituEncoder.synthetic_full(0)
# accumulation against the big batch on balanced data, as
# tests/test_grad_accum.py holds the JAX package: the same f32 gradients
# summed in another order, divided, then Adamax
BIG_LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
BIG_PARAM_TOL = dict(rtol=1e-4, atol=1e-6)


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One torch thread while this module runs (several worker processes
    share each core)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _common(**kw):
    base = dict(hidden=HIDDEN, batch_size=B, backbone="mini", lr=0.002,
                dropout_rate=0.0, ggnn_impl="masked", image_size=64,
                grad_accum=2)
    base.update(kw)
    return base


def _trainer(**kw):
    return Trainer(ENC, TrainerConfig(compute_dtype=torch.float32,
                                      **_common(**kw)), device="cpu")


def _pair(**kw):
    """A JAX trainer and the port's, on the JAX trainer's weights."""
    common = _common(**kw)
    jtr = JaxTrainer(JaxEncoder.synthetic_full(0),
                     JaxConfig(compute_dtype=jnp.float32, **common))
    bstate, hstate = convert.from_jax(*jax.tree.map(
        np.asarray, (jtr.backbone_params, jtr.backbone_stats,
                     jtr.head_params)))
    ttr = Trainer(ENC, TrainerConfig(compute_dtype=torch.float32, **common),
                  device="cpu", backbone_state=bstate, head_state=hstate)
    return jtr, ttr


def _jax_args(jtr, batch):
    arrays, valid, n = jtr._pad_batch(batch)
    dev = {k: jax.device_put(v, jtr._bsh) for k, v in arrays.items()}
    return (dev["images"], dev["flip"], dev["verbs"], dev["labels"],
            jax.device_put(valid, jtr._bsh)), n


def _assert_like_jax(jtr, ttr):
    _assert_trees_close(convert.head_params_to_jax(ttr.head.state_dict()),
                        jax.tree.map(np.asarray, jtr.head_params),
                        PARAM_TOL, "head params")
    _assert_trees_close(convert.resnet_stats_to_jax(
        ttr.backbone.state_dict()),
        jax.tree.map(np.asarray, jtr.backbone_stats), STATS_TOL,
        "BN statistics")


@pytest.mark.parametrize("ft", [False, True])
def test_group_of_two_matches_jax(ft):
    """One group: the JAX trainer's accumulating step, then its fused
    final step (grads + sum + mean + clip + Adamax), against the port's
    ``accum_step`` twice and ``apply_step(2)``."""
    jtr, ttr = _pair(train_backbone=ft)
    batches = [_batch(JaxEncoder.synthetic_full(0), n, seed=50 + i)
               for i, n in enumerate((B, 6))]
    acc = jtr._zero_grads(jtr._trainable())
    for i, batch in enumerate(batches):
        args, n = _jax_args(jtr, batch)
        key = jax.random.fold_in(jtr._dropout_base, jtr.step_count)
        if ft and i == 0:
            acc, jtr.backbone_stats, jl, _ = jtr._grad_accum_step_ft(
                jtr._trainable(), acc, jtr.backbone_stats, key, *args)
        elif ft:
            (tp, jtr.opt_state, acc, jtr.backbone_stats, jl,
             _) = jtr._grad_accum_final_ft(
                jtr._trainable(), jtr.opt_state, acc, jtr.backbone_stats,
                key, *args)
            jtr.head_params, jtr.backbone_params = tp["head"], tp["backbone"]
        elif i == 0:
            acc, jtr.backbone_stats, jl, _ = jtr._grad_accum_step(
                jtr.head_params, acc, jtr.backbone_params,
                jtr.backbone_stats, key, *args)
        else:
            (jtr.head_params, jtr.opt_state, acc, jtr.backbone_stats, jl,
             _) = jtr._grad_accum_final(
                jtr.head_params, jtr.opt_state, acc, jtr.backbone_params,
                jtr.backbone_stats, key, *args)
        jtr.step_count += 1
        targs, _ = ttr._upload(batch)
        tl, _ = ttr.accum_step(*targs, first=i == 0)
        ttr.step_count += 1
        np.testing.assert_allclose(tl.numpy(), [float(x) for x in jl],
                                   **LOSS_TOL, err_msg=f"microbatch {i}")
    ttr.apply_step(2)
    assert ttr.opt_steps == 1
    _assert_like_jax(jtr, ttr)
    if ft:
        from tests.test_torch_train_ft import _assert_backbone_close

        _assert_backbone_close(
            ttr.backbone.state_dict(), convert.resnet_state_from_jax(
                *jax.tree.map(np.asarray, (jtr.backbone_params,
                                           jtr.backbone_stats))), HIDDEN)


def test_epoch_with_a_short_last_group_matches_jax():
    """``train_epoch`` over 3 microbatches at ``grad_accum`` 2: a group
    and a part group of one (JAX ``_apply_pending``) on both sides."""
    jtr, ttr = _pair()
    jenc = JaxEncoder.synthetic_full(0)
    loader = ListLoader([_batch(jenc, n, seed=60 + i)
                         for i, n in enumerate((B, B, 5))])
    j1, j5, jmean = jtr.train_epoch(loader, 0)
    t1, t5, tmean = ttr.train_epoch(loader, 0)
    np.testing.assert_allclose(tmean, jmean, **LOSS_TOL)
    assert t1.get_average_results_both() == j1.get_average_results_both()
    assert t5.get_average_results_both() == j5.get_average_results_both()
    assert ttr.step_count == jtr.step_count == 3
    assert ttr.opt_steps == 2
    _assert_like_jax(jtr, ttr)


def _balanced(n, seed):
    """``n`` rows of one situation (a verb with all its roles labelled),
    random images: every split of them has the same loss denominators."""
    rng = np.random.default_rng(seed)
    verb = int(np.argmax(ENC.role_counts))
    r = ENC.role_counts[verb]
    labels = np.full((1, 3, ENC.max_role_count), ENC.get_num_labels())
    labels[:, :, :r] = rng.integers(0, ENC.get_num_labels(), (1, 3, r))
    return {"images": rng.integers(0, 256, (n, 256, 256, 3), np.uint8),
            "flip": rng.random(n) < 0.5,
            "verbs": np.full(n, verb, np.int32),
            "labels": np.repeat(labels, n, 0).astype(np.int32)}


def _flat(trainer):
    return torch.cat([p.detach().flatten() for p in trainer._trainable])


@pytest.mark.parametrize("ft", [False, True])
def test_accum_equals_the_big_batch_on_balanced_data(ft):
    """``grad_accum`` 2 at microbatch 8 against one step at batch 16 on
    the same rows, for 3 steps: the losses and every trainable parameter
    (the backbone's too when fine-tuned), as ``tests/test_grad_accum.py``
    and ``tests/test_train_backbone.py`` hold the JAX package."""
    kw = dict(frozen_backbone_bn="eval", train_backbone=ft)
    big = _trainer(batch_size=16, grad_accum=1, **kw)
    acc = _trainer(batch_size=8, grad_accum=2, **kw)
    assert torch.equal(_flat(big), _flat(acc))
    for e in range(3):
        rows = _balanced(16, seed=70 + e)
        halves = [{k: v[i * 8:(i + 1) * 8] for k, v in rows.items()}
                  for i in range(2)]
        _, _, big_losses = big.train_epoch([rows], e)
        _, _, acc_losses = acc.train_epoch(halves, e)
        np.testing.assert_allclose(acc_losses, big_losses, **BIG_LOSS_TOL,
                                   err_msg=f"step {e} losses")
        np.testing.assert_allclose(_flat(acc).numpy(), _flat(big).numpy(),
                                   **BIG_PARAM_TOL,
                                   err_msg=f"step {e} parameters")
    assert acc.opt_steps == big.opt_steps == 3
    assert acc.step_count == 6 and big.step_count == 3


def test_the_tail_group_still_steps():
    """2 microbatches at ``grad_accum`` 4: the epoch ends inside its only
    group, which still takes its optimizer step, on the mean of 2."""
    tr = _trainer(grad_accum=4)
    before = _flat(tr).clone()
    tr.train_epoch([_batch(ENC, B, seed=80), _batch(ENC, B, seed=81)], 0)
    assert tr.opt_steps == 1 and tr.step_count == 2
    assert not torch.equal(before, _flat(tr))


def test_the_schedule_ticks_once_per_group():
    """5 microbatches at ``grad_accum`` 2 under a cosine schedule: 3
    optimizer steps (the last a part group) at the schedule's rates of
    optimizer steps 0, 1 and 2."""
    kw = dict(lr_schedule="cosine", total_steps=4, warmup_steps=1)
    tr = _trainer(**kw)
    rates = []
    step = tr.optimizer.step

    def record():
        rates.append(tr.optimizer.param_groups[0]["lr"])
        step()

    tr.optimizer.step = record
    tr.train_epoch([_batch(ENC, B, seed=90 + i) for i in range(5)], 0)
    fn = make_lr_fn(TrainerConfig(**_common(**kw)))
    np.testing.assert_allclose(rates, [fn(c) for c in range(3)], rtol=1e-12)
    assert tr.opt_steps == 3 and tr.current_lr() == fn(3)


def test_a_snapshot_at_a_group_boundary_resumes_exactly():
    """Snapshots wait for a group's end: with ``save_every`` 1 at
    ``grad_accum`` 2 the callback fires after batches 2 and 4 only, and a
    stop flagged inside the first group stops after it.  Resumed from that
    snapshot, the epoch ends where the uninterrupted one does, bit for
    bit."""
    sizes = (B, B, B, 5)
    whole = _trainer(dropout_rate=0.5)
    w1, _, wloss = whole.train_epoch(EpochLoader(7, sizes=sizes), 0)

    seen = []
    every = _trainer(dropout_rate=0.5)
    every.train_epoch(EpochLoader(7, sizes=sizes), 0, save_every=1,
                      save_callback=lambda mid: seen.append(
                          mid["batch_in_epoch"]))
    assert seen == [2, 4]

    saved = {}
    stop = threading.Event()
    cut = _trainer(dropout_rate=0.5)

    def callback(mid):
        saved.update(cut.model_state_dict(), mid=mid)

    loader = EpochLoader(7, sizes=sizes,
                         hook=lambda i: i == 1 and stop.set())
    with pytest.raises(Preempted) as info:
        cut.train_epoch(loader, 0, save_every=3, save_callback=callback,
                        preempt=stop)
    assert info.value.saved and info.value.batch_in_epoch == 2
    assert saved["mid"]["batch_in_epoch"] == 2 and cut.opt_steps == 1

    resumed = _trainer(dropout_rate=0.5)
    resumed.load_model_state(saved)
    r1, _, rloss = resumed.train_epoch(EpochLoader(7, sizes=sizes), 0,
                                       mid_state=saved["mid"])
    assert rloss == wloss
    assert r1.get_average_results_both() == w1.get_average_results_both()
    _assert_state_equal(resumed.model_state_dict(),
                        whole.model_state_dict())


def test_folded_weights_are_kept_within_a_group(monkeypatch):
    """Under ``ggnn_impl='kernel'`` (the twins on the CPU) the gt branch's
    folded weights are built at a group's first microbatch, reused by the
    next, and rebuilt after the group's optimizer step."""
    from situation_recognition_tpu_torch.models import fcggnn

    folds = []
    real = fcggnn.fold_gate_weights

    def counting(params, bias_mult, *args, **kwargs):
        folds.append(bias_mult)
        return real(params, bias_mult, *args, **kwargs)

    monkeypatch.setattr(fcggnn, "fold_gate_weights", counting)
    tr = _trainer(ggnn_impl="kernel")
    batches = [_batch(ENC, B, seed=100 + i) for i in range(4)]
    counts = []
    for i, batch in enumerate(batches):
        args, _ = tr._upload(batch)
        tr.accum_step(*args, first=i % 2 == 0)
        counts.append(len(folds))
        if i % 2:
            tr.apply_step(2)
    # the gt branch folds at R; the first microbatch of each group misses
    assert counts == [1, 1, 2, 2], counts


def test_k2_k3_route_sums_parameter_gradients_across_microbatches(
        monkeypatch):
    """``SRTPU_GGNN_BWD=pallas`` (K2/K3 and ``param_grads``, their twins
    on the CPU): after two microbatches ``.grad`` is the sum of what each
    gives alone, as autograd's accumulation is."""
    monkeypatch.setenv("SRTPU_GGNN_BWD", "pallas")
    a, b = _batch(ENC, B, seed=110), _batch(ENC, B, seed=111)

    def grads(*batches):
        tr = _trainer(ggnn_impl="kernel")
        for i, batch in enumerate(batches):
            args, _ = tr._upload(batch)
            tr.accum_step(*args, first=i == 0)
        return [p.grad.clone() for p in tr.head.parameters()]

    both, ga, gb = grads(a, b), grads(a), grads(b)
    for g, x, y in zip(both, ga, gb):
        torch.testing.assert_close(g, x + y, rtol=1e-6, atol=1e-7)
