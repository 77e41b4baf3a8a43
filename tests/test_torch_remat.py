"""``TrainerConfig.ggnn_remat`` on the CPU: each GGNN step of a
differentiated propagate is recomputed in the backward
(``torch.utils.checkpoint``), which changes no number — the head's
gradients equal the un-rematted ones and JAX's with
``TrainerConfig(ggnn_remat=True)`` (``jax.checkpoint`` a step) at f32 —
and a remat request keeps differentiated propagates off the K2/K3 route
under ``SRTPU_GGNN_BWD=pallas``, as JAX's leaves its Pallas kernel."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from situation_recognition_tpu.models.fcggnn import (
    FCGGNNHead as JaxHead, nouns_loss_masked as jax_nouns_loss,
    verb_loss_masked as jax_verb_loss)
from situation_recognition_tpu.train import TrainerConfig as JaxConfig
from situation_recognition_tpu_torch import convert
from situation_recognition_tpu_torch.data.encoder import ImsituEncoder
from situation_recognition_tpu_torch.models import fcggnn
from situation_recognition_tpu_torch.models.fcggnn import (
    FCGGNNHead, nouns_loss_masked, verb_loss_masked)
from situation_recognition_tpu_torch.ops.ggnn import (
    GGNNParams, ggnn_propagate, ggnn_propagate_verb)

D, B = 64, 6
GRAD_TOL = dict(rtol=1e-5, atol=1e-7)


def _inputs(enc, seed=0):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((B, D)).astype(np.float32)
    verbs = rng.integers(0, enc.get_num_verbs(), B)
    labels = rng.integers(0, enc.get_num_labels(),
                          (B, 3, enc.max_role_count))
    return feats, verbs, labels


def _port_grads(head, enc, feats, verbs, labels):
    head.zero_grad(set_to_none=True)
    valid = torch.ones(B)
    f = torch.from_numpy(feats).requires_grad_(True)
    pv, pn = head.predict_train(f, torch.as_tensor(enc.role_ids),
                                torch.as_tensor(enc.role_mask))
    loss = (verb_loss_masked(pv, torch.as_tensor(verbs), valid)
            + nouns_loss_masked(pn, torch.as_tensor(labels),
                                enc.get_num_labels(), valid))
    loss.backward()
    return {"features": f.grad.clone(),
            **{n: p.grad.clone() for n, p in head.named_parameters()}}


def _head(enc, remat, impl="masked"):
    head = FCGGNNHead(enc.get_num_verbs(), enc.get_num_roles(),
                      enc.get_num_labels(), enc.max_role_count, hidden=D,
                      dropout_rate=0.0, ggnn_impl=impl, ggnn_remat=remat)
    head.reset_parameters(torch.Generator().manual_seed(1))
    return head


def test_remat_ops_match_the_plain_steps():
    g = torch.Generator().manual_seed(0)
    p = GGNNParams(*(torch.randn((D, D) if i % 2 == 0 else (D,),
                                 generator=g) * D ** -0.5
                     for i in range(14)))
    h = torch.randn(3, 4, D, generator=g)
    mask = (torch.rand(3, 4, generator=g) < 0.7).float()
    for remat in (False, True):
        x = h.clone().requires_grad_(True)
        ggnn_propagate(p, x, mask, 4, remat=remat).square().sum().backward()
        y = h[:, 0].clone().requires_grad_(True)
        ggnn_propagate_verb(p, y, 4, remat=remat).square().sum().backward()
        if not remat:
            want = (x.grad, y.grad)
        else:
            assert torch.equal(x.grad, want[0])
            assert torch.equal(y.grad, want[1])


@pytest.mark.parametrize("impl", ["masked", "kernel"])
def test_remat_gradients_equal_the_plain_ones_and_jax(impl):
    """Both branches differentiated (the train step's), f32: remat
    recomputes the same operations, so the gradients are bit-equal, and
    JAX's remat head (its ``TrainerConfig(ggnn_remat=True)``) gives the
    same within f32 rounding."""
    enc = ImsituEncoder.synthetic_full(0)
    feats, verbs, labels = _inputs(enc)
    plain = _port_grads(_head(enc, False, impl), enc, feats, verbs, labels)
    remat = _port_grads(_head(enc, True, impl), enc, feats, verbs, labels)
    for k in plain:
        assert torch.equal(remat[k], plain[k]), k

    jcfg = JaxConfig(hidden=D, ggnn_remat=True, ggnn_impl="masked",
                     dropout_rate=0.0, compute_dtype=jnp.float32)
    jhead = JaxHead(enc.get_num_verbs(), enc.get_num_roles(),
                    enc.get_num_labels(), enc.max_role_count,
                    hidden=jcfg.hidden, dropout_rate=jcfg.dropout_rate,
                    dtype=jcfg.compute_dtype, ggnn_impl=jcfg.ggnn_impl,
                    ggnn_remat=jcfg.ggnn_remat)
    assert jhead.ggnn_remat
    params = jax.tree.map(jnp.asarray, convert.head_params_to_jax(
        _head(enc, True, impl).state_dict()))
    role_ids, role_mask = jnp.asarray(enc.role_ids), jnp.asarray(
        enc.role_mask)
    valid = jnp.ones(B)

    def loss(p, f):
        pv, pn = jhead.apply({"params": p}, f, role_ids, role_mask,
                             method=jhead.predict_train)
        return (jax_verb_loss(pv, jnp.asarray(verbs), valid)
                + jax_nouns_loss(pn, jnp.asarray(labels),
                                 enc.get_num_labels(), valid))

    gp, gf = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(feats))
    want = jax.tree.map(np.asarray, convert.head_state_from_jax(
        jax.tree.map(np.asarray, gp)))
    np.testing.assert_allclose(remat["features"].numpy(), np.asarray(gf),
                               **GRAD_TOL)
    for k, w in want.items():
        np.testing.assert_allclose(remat[k].numpy(), np.asarray(w),
                                   **GRAD_TOL, err_msg=k)


def test_remat_keeps_the_k2_k3_route_out(monkeypatch):
    """Under ``SRTPU_GGNN_BWD=pallas`` a kernel-impl head sends its
    differentiated propagates to K2/K3 unless ``ggnn_remat`` is set; its
    forward-only propagates take K1 either way."""
    enc = ImsituEncoder.synthetic_full(0)
    feats, verbs, labels = _inputs(enc)
    monkeypatch.setenv("SRTPU_GGNN_BWD", "pallas")
    calls = {"train_kernel": 0, "kernel": 0}
    train_route = fcggnn.ggnn_propagate_train
    kernel_route = fcggnn.ggnn_propagate_folded

    def counted(name, fn):
        def call(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return call

    monkeypatch.setattr(fcggnn, "ggnn_propagate_train",
                        counted("train_kernel", train_route))
    monkeypatch.setattr(fcggnn, "ggnn_propagate_folded",
                        counted("kernel", kernel_route))
    for remat, want in ((True, 0), (False, 2)):
        calls.update(train_kernel=0, kernel=0)
        head = _head(enc, remat, "kernel")
        _port_grads(head, enc, feats, verbs, labels)
        with torch.no_grad():
            head.predict_nouns(torch.from_numpy(feats),
                               torch.as_tensor(verbs),
                               torch.as_tensor(enc.role_ids),
                               torch.as_tensor(enc.role_mask))
        assert calls == {"train_kernel": want, "kernel": 1}, (remat, calls)


def test_trainer_config_reaches_the_head():
    from situation_recognition_tpu_torch.train import Trainer, TrainerConfig

    enc = ImsituEncoder.synthetic_full(0)
    tr = Trainer(enc, TrainerConfig(hidden=D, batch_size=2, backbone="mini",
                                    compute_dtype=torch.float32,
                                    ggnn_remat=True), device="cpu")
    assert tr.head.ggsnn.remat is True
    assert TrainerConfig().ggnn_remat is False
