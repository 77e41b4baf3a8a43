"""The port's FCGGNN head against the JAX head, weights carried across by
``convert.py``: the masked path at f32, and the kernel path (the plain
twin on the CPU) against the JAX Pallas kernel in interpret mode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from situation_recognition_tpu.models.fcggnn import FCGGNNHead as JaxHead
from situation_recognition_tpu_torch import convert
from situation_recognition_tpu_torch.data.encoder import ImsituEncoder
from situation_recognition_tpu_torch.models.fcggnn import (
    FCGGNNHead, resolve_ggnn_impl)
from situation_recognition_tpu_torch.ops import ggnn_kernel


def _heads(hidden, jax_impl, port_impl, seed=0):
    enc = ImsituEncoder.synthetic_full(0)
    dims = (enc.get_num_verbs(), enc.get_num_roles(), enc.get_num_labels(),
            enc.max_role_count)
    jhead = JaxHead(*dims, hidden=hidden, ggnn_impl=jax_impl)
    params = jhead.init(jax.random.PRNGKey(seed), jnp.zeros((2, hidden)),
                        jnp.zeros((2,), jnp.int32), jnp.asarray(enc.role_ids),
                        jnp.asarray(enc.role_mask))["params"]
    params = jax.tree.map(np.asarray, params)
    head = FCGGNNHead(*dims, hidden=hidden, ggnn_impl=port_impl).eval()
    head.load_state_dict(convert.head_state_from_jax(params), strict=True)
    return enc, jhead, params, head


def _features(b, hidden, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, hidden)).astype(np.float32)


def _run_both(enc, jhead, params, head, feats, verbs):
    tables = (jnp.asarray(enc.role_ids), jnp.asarray(enc.role_mask))
    v = {"params": params}
    jv = np.asarray(jhead.apply(v, jnp.asarray(feats),
                                method=jhead.predict_verb))
    jn = np.asarray(jhead.apply(v, jnp.asarray(feats), jnp.asarray(verbs),
                                *tables, method=jhead.predict_nouns))
    role_ids = torch.as_tensor(enc.role_ids, dtype=torch.long)
    role_mask = torch.as_tensor(enc.role_mask)
    with torch.no_grad():
        tv = head.predict_verb(torch.from_numpy(feats)).numpy()
        tn = head.predict_nouns(torch.from_numpy(feats),
                                torch.from_numpy(verbs), role_ids,
                                role_mask).numpy()
    return jv, jn, tv, tn


def test_masked_head_matches_jax_f32():
    enc, jhead, params, head = _heads(64, "masked", "masked")
    feats = _features(5, 64, 1)
    verbs = np.array([0, 17, 250, 503, 88], np.int32)
    jv, jn, tv, tn = _run_both(enc, jhead, params, head, feats, verbs)
    assert tv.shape == (5, 504) and tn.shape == (5, 6, 2001)
    # f32 on both sides, other summation orders over 4 GGNN steps
    np.testing.assert_allclose(tv, jv, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tn, jn, rtol=1e-4, atol=1e-5)


def test_kernel_head_matches_jax_pallas_interpret():
    """ggnn_impl='pallas' in JAX runs the Pallas kernel in interpret mode
    for >= 128 rows at d % 128 == 0: B=24 nouns (144 rows) and B=128
    verbs.  The port's 'kernel' impl runs the twin on the CPU."""
    enc, jhead, params, head = _heads(128, "pallas", "kernel", seed=3)
    feats = _features(128, 128, 4)
    verbs = np.random.default_rng(5).integers(0, 504, 128).astype(np.int32)
    jv, _, tv, _ = _run_both(enc, jhead, params, head, feats, verbs)
    _, jn, _, tn = _run_both(enc, jhead, params, head, feats[:24],
                             verbs[:24])
    # the twin agrees with the interpret kernel to bf16 last-bit flips of
    # h (<= 2^-7, test_torch_ggnn); through a classifier of 128 inputs of
    # weights below 1/sqrt(128) that is at most 2^-7 * sqrt(128) / 4 in
    # the logits for a few flips
    np.testing.assert_allclose(tv, jv, rtol=0, atol=2e-2)
    np.testing.assert_allclose(tn, jn, rtol=0, atol=2e-2)
    assert np.array_equal(tv.argmax(1), jv.argmax(1))


def test_kernel_impl_is_forward_only():
    _, _, _, head = _heads(64, "masked", "kernel")
    with pytest.raises(RuntimeError, match="forward-only"):
        head.predict_verb(torch.zeros(2, 64))


def test_folded_weights_follow_weight_updates():
    _, _, _, head = _heads(64, "masked", "kernel")
    g = head.ggsnn
    first = g.folded(6.0)
    assert g.folded(6.0) is first
    with torch.no_grad():
        g.W_p.weight.mul_(0.5)
    second = g.folded(6.0)
    assert second is not first
    assert not torch.equal(second[0], first[0])


def test_resolve_ggnn_impl():
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert resolve_ggnn_impl("auto", torch.bfloat16, cuda) == "kernel"
    assert resolve_ggnn_impl("auto", torch.float32, cuda) == "masked"
    assert resolve_ggnn_impl("auto", torch.bfloat16, cpu) == "masked"
    assert resolve_ggnn_impl("kernel", torch.float32, cpu) == "kernel"
    with pytest.raises(ValueError):
        resolve_ggnn_impl("pallas", torch.float32, cpu)


def test_head_state_is_reference_layout():
    from situation_recognition_tpu.utils.torch_export import (
        export_reference_state_dict)

    _, _, params, head = _heads(64, "masked", "masked", seed=6)
    backbone = {"conv1": {"kernel": np.zeros((7, 7, 3, 2), np.float32)},
                "bn1": {"scale": np.ones(2, np.float32),
                        "bias": np.zeros(2, np.float32)}}
    stats = {"bn1": {"mean": np.zeros(2, np.float32),
                     "var": np.ones(2, np.float32)}}
    # the JAX exporter needs at least one layer; give it a minimal one
    blk = {f"conv{c}": {"kernel": np.zeros((1, 1, 2, 2), np.float32)}
           for c in (1, 2, 3)}
    blk.update({f"bn{c}": {"scale": np.ones(2, np.float32),
                           "bias": np.zeros(2, np.float32)}
                for c in (1, 2, 3)})
    backbone["layer1_0"] = blk
    stats["layer1_0"] = {f"bn{c}": {"mean": np.zeros(2, np.float32),
                                    "var": np.ones(2, np.float32)}
                         for c in (1, 2, 3)}
    ref = export_reference_state_dict(backbone, stats, params)
    _, head_sd = convert.from_reference(ref)
    assert list(head_sd) == list(head.state_dict())
    head.load_state_dict(head_sd, strict=True)
    for k, v in convert.head_state_from_jax(params).items():
        np.testing.assert_array_equal(np.asarray(head_sd[k]), v.numpy())


def test_kernel_counter_untouched_on_cpu():
    enc, _, _, head = _heads(64, "masked", "kernel")
    before = ggnn_kernel.folded_rows.launches
    with torch.no_grad():
        head.predict_verb(torch.ones(3, 64))
    assert ggnn_kernel.folded_rows.launches == before
