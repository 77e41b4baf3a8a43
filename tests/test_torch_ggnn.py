"""GGNN math and the folded kernel's plain twin: the port against the JAX
package on the CPU, same inputs from a numpy seed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from situation_recognition_tpu.ops import ggnn as jg
from situation_recognition_tpu.ops import ggnn_pallas as jp
from situation_recognition_tpu_torch.ops import ggnn as tg
from situation_recognition_tpu_torch.ops import ggnn_kernel as tk

# f32 math on both sides, summed in other orders: agreement to f32
# rounding accumulated over 4 steps
F32_TOL = dict(rtol=1e-5, atol=1e-5)


def _params(d, seed):
    rng = np.random.default_rng(seed)
    bound = 1.0 / np.sqrt(d)
    arrs = []
    for _ in range(7):
        arrs.append(rng.uniform(-bound, bound, (d, d)).astype(np.float32))
        arrs.append(rng.uniform(-bound, bound, (d,)).astype(np.float32))
    return (jg.GGNNParams(*(jnp.asarray(a) for a in arrs)),
            tg.GGNNParams(*(torch.from_numpy(a) for a in arrs)))


def _inputs(b, r, d, seed):
    rng = np.random.default_rng(seed + 100)
    h = (rng.standard_normal((b, r, d)) * 0.5).astype(np.float32)
    counts = rng.integers(1, r + 1, b)
    mask = (np.arange(r)[None, :] < counts[:, None]).astype(np.float32)
    return h, mask


@pytest.mark.parametrize("steps", [1, 4])
def test_masked_propagate_matches_jax(steps):
    jpar, tpar = _params(64, 0)
    h, mask = _inputs(5, 6, 64, 0)
    want = jg.ggnn_propagate(jpar, jnp.asarray(h), jnp.asarray(mask), steps)
    got = tg.ggnn_propagate(tpar, torch.from_numpy(h),
                            torch.from_numpy(mask), steps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def test_dense_propagate_matches_jax_and_masked():
    from situation_recognition_tpu_torch.data.encoder import ImsituEncoder

    enc = ImsituEncoder.synthetic_full(0)
    jpar, tpar = _params(64, 1)
    h, _ = _inputs(7, 6, 64, 1)
    verbs = np.arange(7) * 31
    adj = enc.get_adj_matrix_noself(verbs)
    mask = enc.role_mask[verbs]
    want = jg.ggnn_propagate_dense(jpar, jnp.asarray(h), jnp.asarray(adj))
    got = tg.ggnn_propagate_dense(tpar, torch.from_numpy(h),
                                  torch.from_numpy(adj))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    masked = tg.ggnn_propagate(tpar, torch.from_numpy(h),
                               torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), masked.numpy(), **F32_TOL)


def test_verb_propagate_matches_jax():
    jpar, tpar = _params(64, 2)
    h, _ = _inputs(9, 1, 64, 2)
    want = jg.ggnn_propagate_verb(jpar, jnp.asarray(h[:, 0]))
    got = tg.ggnn_propagate_verb(tpar, torch.from_numpy(h[:, 0]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


@pytest.mark.parametrize("bias_mult", [1.0, 6.0])
def test_fold_gate_weights_matches_jax(bias_mult):
    jpar, tpar = _params(128, 3)
    want = jp.fold_gate_weights(jpar, bias_mult, dtype=jnp.float32)
    got = tk.fold_gate_weights(tpar, bias_mult, dtype=torch.float32)
    for w, g in zip(want, got):
        # f32 products of the same operands; the d-long sums may be
        # ordered differently
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   rtol=1e-5, atol=1e-6)


def _fused_jax(jpar, h_rows, mask_rows, r, steps):
    """The Pallas kernel in interpret mode, one block holding all rows."""
    m = h_rows.shape[0]
    out = jp.ggnn_propagate_fused(
        jpar, jnp.asarray(h_rows, jnp.bfloat16),
        jnp.asarray(mask_rows[:, None]), r=r, steps=steps,
        bias_mult=float(r), bm=m, m_padded=m, interpret=True)
    return np.asarray(out.astype(jnp.float32))


# (B, R): the noun shape with B*R >= 128 rows and mixed role counts, and
# the verb shape (r=1, mask 0)
@pytest.mark.parametrize("b,r", [(24, 6), (128, 1)])
def test_twin_matches_pallas_interpret(b, r):
    d, steps = 128, 4
    jpar, tpar = _params(d, 4)
    h, mask = _inputs(b, r, d, 4)
    if r == 1:
        mask = np.zeros_like(mask)
    h_rows = h.reshape(b * r, d)
    mask_rows = mask.reshape(b * r)
    want = _fused_jax(jpar, h_rows, mask_rows, r, steps)
    weights = tk.fold_gate_weights(tpar, float(r))
    got = tk.folded_reference(
        torch.from_numpy(h_rows).to(torch.bfloat16),
        torch.from_numpy(mask_rows), weights, r, steps).float().numpy()
    # the same bf16 operands and f32 sums on both sides, in other orders:
    # a rare last-bit flip of a bf16 intermediate propagates through the
    # steps; bf16 has 8 bits of mantissa, so 2 ulp at |h| <= 1 is 2^-7
    np.testing.assert_allclose(got, want, rtol=0, atol=2 ** -7)
    assert np.mean(got == want) > 0.95


def test_folded_propagate_matches_jax_pallas_wrapper():
    """The (B, R, D) entry against ggnn_propagate_pallas (interpret): the
    row flattening, the bias multiplier R and the output cast."""
    d, b, r = 128, 25, 6
    jpar, tpar = _params(d, 5)
    h, mask = _inputs(b, r, d, 5)
    want = jp.ggnn_propagate_pallas(jpar, jnp.asarray(h), jnp.asarray(mask),
                                    3, True)
    got = tk.ggnn_propagate_folded(tpar, torch.from_numpy(h),
                                   torch.from_numpy(mask), 3)
    assert got.dtype == torch.float32 and got.shape == (b, r, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2 ** -7)


def test_twin_is_close_to_f32_masked_math():
    """The folded bf16 twin stays within bf16-class error of the f32
    masked-sum oracle (the JAX kernel's documented bound is 0.15)."""
    d, b, r = 64, 6, 6
    _, tpar = _params(d, 6)
    h, mask = _inputs(b, r, d, 6)
    ref = tg.ggnn_propagate(tpar, torch.from_numpy(h), torch.from_numpy(mask))
    got = tk.ggnn_propagate_folded(tpar, torch.from_numpy(h),
                                   torch.from_numpy(mask))
    assert float((got - ref).abs().max()) < 0.15


def test_wrapper_takes_cpu_twin_and_counts_no_launch():
    d, b, r = 64, 3, 6
    _, tpar = _params(d, 7)
    h, mask = _inputs(b, r, d, 7)
    before = tk.folded_rows.launches
    weights = tk.fold_gate_weights(tpar, float(r))
    rows = torch.from_numpy(h.reshape(b * r, d)).to(torch.bfloat16)
    mrows = torch.from_numpy(mask.reshape(-1))
    out = tk.folded_rows(rows, mrows, weights, r, 2)
    ref = tk.folded_reference(rows, mrows, weights, r, 2)
    assert torch.equal(out, ref)
    assert tk.folded_rows.launches == before


def test_block_adjacency_matches_encoder_tables():
    from situation_recognition_tpu_torch.data.encoder import ImsituEncoder

    enc = ImsituEncoder.synthetic_full(0)
    verbs = np.arange(0, 504, 7)
    e = tk.block_adjacency(torch.from_numpy(enc.role_mask[verbs].reshape(-1)),
                           6)
    np.testing.assert_array_equal(e.numpy(), enc.adjacency[verbs])
