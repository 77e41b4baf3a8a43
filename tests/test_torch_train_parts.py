"""The parts of the port's train path against the JAX package on the CPU:
losses, the scorer, train-mode BatchNorm, the head's train-mode branches
and dropout, the GGNN routes of differentiated calls, and the folded-weight
cache across optimizer steps."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from situation_recognition_tpu.metrics import scorer as jscorer
from situation_recognition_tpu.models import fcggnn as jf
from situation_recognition_tpu.models.resnet import ResNet as JaxResNet
from situation_recognition_tpu_torch import convert
from situation_recognition_tpu_torch.data.encoder import ImsituEncoder
from situation_recognition_tpu_torch.metrics import scorer as tscorer
from situation_recognition_tpu_torch.models import fcggnn as tf
from situation_recognition_tpu_torch.models import resnet as tr
from situation_recognition_tpu_torch.ops import ggnn_train
from tests.test_torch_fcggnn import _features, _heads

L = 2001


def _nouns_case(b, seed, all_ignored=None):
    rng = np.random.default_rng(seed)
    pred = rng.standard_normal((b, 6, L)).astype(np.float32) * 3
    labels = rng.integers(0, L + 1, (b, 3, 6)).astype(np.int32)
    if all_ignored is not None:
        labels[:, all_ignored, :] = L
    valid = (np.arange(b) < b - 1).astype(np.float32)
    return pred, labels, valid


@pytest.mark.parametrize("all_ignored", [None, 1])
def test_nouns_losses_match_jax(all_ignored):
    """Including the reference's NaN when an annotation has no
    non-ignored position, and the masked variant's guard to 0."""
    pred, labels, valid = _nouns_case(5, 0, all_ignored)
    want = float(jf.nouns_loss(jnp.asarray(pred), jnp.asarray(labels), L))
    got = float(tf.nouns_loss(torch.from_numpy(pred),
                              torch.from_numpy(labels), L))
    if all_ignored is None:
        np.testing.assert_allclose(got, want, rtol=1e-6)
    else:
        assert np.isnan(got) and np.isnan(want)
    want = float(jf.nouns_loss_masked(jnp.asarray(pred), jnp.asarray(labels),
                                      L, jnp.asarray(valid)))
    got = float(tf.nouns_loss_masked(torch.from_numpy(pred),
                                     torch.from_numpy(labels), L,
                                     torch.from_numpy(valid)))
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    jt = jf.nouns_ce_terms(jnp.asarray(pred), jnp.asarray(labels), L)
    tt = tf.nouns_ce_terms(torch.from_numpy(pred), torch.from_numpy(labels),
                           L)
    for (jn, jd), (tn, td) in zip(jt, tt):
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        assert float(td) == float(jd)


def test_verb_losses_match_jax():
    rng = np.random.default_rng(1)
    pred = rng.standard_normal((7, 504)).astype(np.float32) * 4
    gt = rng.integers(0, 504, 7).astype(np.int32)
    valid = np.array([1, 1, 1, 0, 1, 0, 1], np.float32)
    jp_, tp = jnp.asarray(pred), torch.from_numpy(pred)
    np.testing.assert_allclose(
        float(tf.verb_loss(tp, torch.from_numpy(gt))),
        float(jf.verb_loss(jp_, jnp.asarray(gt))), rtol=1e-6)
    np.testing.assert_allclose(
        float(tf.verb_loss_masked(tp, torch.from_numpy(gt),
                                  torch.from_numpy(valid))),
        float(jf.verb_loss_masked(jp_, jnp.asarray(gt), jnp.asarray(valid))),
        rtol=1e-6)
    tn, td = tf.verb_ce_term(tp, torch.from_numpy(gt),
                             torch.from_numpy(valid))
    jn, jd = jf.verb_ce_term(jp_, jnp.asarray(gt), jnp.asarray(valid))
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    assert float(td) == float(jd) == 5.0


@pytest.mark.parametrize("keep_cards", [False, True])
def test_scorer_cards_equal_jax(keep_cards):
    from situation_recognition_tpu.data.encoder import (
        ImsituEncoder as JaxEncoder)

    jenc, tenc = JaxEncoder.synthetic_full(0), ImsituEncoder.synthetic_full(0)
    rng = np.random.default_rng(2)
    scorers = [(jscorer.ImsituScorer(jenc, k, 3, keep_cards=keep_cards),
                tscorer.ImsituScorer(tenc, k, 3, keep_cards=keep_cards))
               for k in (1, 5)]
    for _ in range(3):
        b = 9
        verbs = rng.integers(0, 504, b)
        labels = rng.integers(0, 30, (b, 3, 6))
        # logits drawn so that hits happen: few label and verb classes
        pv = rng.standard_normal((b, 504))
        pv[np.arange(b), verbs] += rng.random(b) * 3
        pn = rng.standard_normal((b, 6, L))
        pn[:, :, :30] += 2
        gtn = rng.standard_normal((b, 6, L))
        gtn[:, :, :30] += 2
        for js, ts in scorers:
            js.add_point_both(pv, verbs, pn, labels, gtn)
            ts.add_point_both(pv, verbs, pn, labels, gtn)
    for js, ts in scorers:
        assert ts.get_average_results_both() == js.get_average_results_both()
        assert ts.score_cards == js.score_cards
        assert ts.state_dict() == js.state_dict()
    a1, a5 = (s[1].get_average_results_both() for s in scorers)
    assert tscorer.mean_of_eight(a1, a5) == jscorer.mean_of_eight(
        *(s[0].get_average_results_both() for s in scorers))
    logits = rng.standard_normal((4, 50))
    logits[:, 7] = logits[:, 3] = 9.0                     # a tie
    np.testing.assert_array_equal(tscorer.topk_indices(logits, 5),
                                  jscorer.topk_indices(logits, 5))


def test_train_mode_bn_matches_flax():
    """mini at f32: features with batch statistics and the updated
    running statistics (one EMA update) against flax mutable=['batch_stats'],
    starting from random running statistics."""
    from tests.test_torch_resnet import _jax_mini

    jmodel, params, stats = _jax_mini(64, 3)
    x = np.random.default_rng(4).standard_normal((3, 64, 64, 3)).astype(
        np.float32)
    want, upd = jmodel.apply({"params": params, "batch_stats": stats},
                             jnp.asarray(x), train=True,
                             mutable=["batch_stats"])
    model = tr.mini(64).train()
    model.load_state_dict(convert.resnet_state_from_jax(params, stats),
                          strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    # f32 convolutions summed in other orders through 13 layers, as the
    # eval-mode test (test_torch_resnet)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-4)
    got_stats = convert.resnet_stats_to_jax(model.state_dict())
    want_stats = jax.tree.map(np.asarray, upd["batch_stats"])
    flat = jax.tree_util.tree_leaves_with_path(want_stats)
    assert len(flat) == len(jax.tree_util.tree_leaves(got_stats))
    for path, w in flat:
        g = got_stats
        for k in path:
            g = g[k.key]
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5,
                                   err_msg=str(path))
    # eval mode is untouched: running statistics, no update
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with torch.no_grad():
        model.eval()(torch.from_numpy(x))
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_head_forward_matches_jax_call_f32():
    """``forward`` (predict_train + the gt branch) against the JAX head's
    ``__call__`` in eval mode at f32, masked GGNN."""
    enc, jhead, params, head = _heads(64, "masked", "masked", seed=8)
    feats = _features(5, 64, 9)
    verbs = np.array([3, 100, 250, 503, 7], np.int32)
    want = jhead.apply({"params": params}, jnp.asarray(feats),
                       jnp.asarray(verbs), jnp.asarray(enc.role_ids),
                       jnp.asarray(enc.role_mask))
    with torch.no_grad():
        got = head(torch.from_numpy(feats), torch.from_numpy(verbs),
                   torch.as_tensor(enc.role_ids, dtype=torch.long),
                   torch.as_tensor(enc.role_mask))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5)


def test_dropout_rate_scale_and_generator():
    x = torch.ones(200, 300)
    a = tf.dropout(x, 0.5, torch.Generator().manual_seed(5))
    b = tf.dropout(x, 0.5, torch.Generator().manual_seed(5))
    c = tf.dropout(x, 0.5, torch.Generator().manual_seed(6))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert set(a.unique().tolist()) == {0.0, 2.0}
    # 60,000 draws: the dropped share is 0.5 within 5 standard deviations
    assert abs(float((a == 0).float().mean()) - 0.5) < 5 * 0.5 / 60000 ** 0.5
    assert torch.equal(tf.dropout(x, 0.0, None), x)
    # the head: train=True drops before each classifier, drawn in the
    # order verb, nouns, nouns from the one generator; train=False not
    enc, _, _, head = _heads(64, "masked", "masked", seed=10)
    feats = torch.from_numpy(_features(4, 64, 11))
    verbs = torch.tensor([1, 2, 3, 4])
    tables = (torch.as_tensor(enc.role_ids, dtype=torch.long),
              torch.as_tensor(enc.role_mask))
    with torch.no_grad():
        ev = head(feats, verbs, *tables)
        t1 = head(feats, verbs, *tables, train=True,
                  generator=torch.Generator().manual_seed(0))
        t2 = head(feats, verbs, *tables, train=True,
                  generator=torch.Generator().manual_seed(0))
        pv = head.predict_verb(feats, train=True,
                               generator=torch.Generator().manual_seed(0))
    for a_, b_, e in zip(t1, t2, ev):
        assert torch.equal(a_, b_) and not torch.equal(a_, e)
    assert torch.equal(pv, t1[0])


def _loss(head, feats, enc):
    tables = (torch.as_tensor(enc.role_ids, dtype=torch.long),
              torch.as_tensor(enc.role_mask))
    pv, pn = head.predict_train(feats, *tables)
    return pv.square().mean() + pn.square().mean()


def test_differentiated_calls_route_as_jax(monkeypatch):
    """kernel impl under autograd: masked-sum autograd by default (the
    same gradients as the masked impl, exactly), the K2/K3 Function with
    SRTPU_GGNN_BWD=pallas (bf16-class agreement); K1 never."""
    enc, _, _, kernel_head = _heads(64, "masked", "kernel", seed=12)
    _, _, _, masked_head = _heads(64, "masked", "masked", seed=12)
    feats = torch.from_numpy(_features(6, 64, 13))
    calls = []
    real = ggnn_train.folded_rows_res
    monkeypatch.setattr(ggnn_train, "folded_rows_res",
                        lambda *a: calls.append(a[0].shape) or real(*a))

    def refuse(*a, **k):
        raise AssertionError("K1 under autograd")

    grads = {}
    for route in ("xla", "pallas", "masked"):
        monkeypatch.setenv("SRTPU_GGNN_BWD", route)
        head = masked_head if route == "masked" else kernel_head
        head.zero_grad()
        monkeypatch.setattr(tf, "ggnn_propagate_folded", refuse)
        _loss(head, feats, enc).backward()
        grads[route] = [p.grad.clone() for p in head.parameters()]
    # the pallas route ran K2 twice: the verb (6 rows, r=1), the nouns
    assert calls == [(6, 64), (36, 64)]
    for x, m in zip(grads["xla"], grads["masked"]):
        assert torch.equal(x, m)
    for p, m in zip(grads["pallas"], grads["masked"]):
        scale = float(m.abs().max()) + 1e-12
        assert float((p - m).abs().max()) / scale < 2e-2


def test_folded_weights_refold_after_optimizer_step():
    _, _, _, head = _heads(64, "masked", "kernel", seed=14)
    g = head.ggsnn
    before = g.folded(6.0)
    opt = torch.optim.Adamax(head.parameters(), lr=0.002)
    for p in head.parameters():
        p.grad = torch.ones_like(p)
    opt.step()
    after = g.folded(6.0)
    assert after is not before
    assert not torch.equal(after[0], before[0])
    fresh = ggnn_train.fold_gate_weights(g.params(), 6.0)
    for a, f in zip(after, fresh):
        assert torch.equal(a, f)
