"""The GGNN backward pair on the CPU: the plain twins of K2 and K3 and the
autograd route built on them, against the JAX package's Pallas kernels in
interpret mode, on the same numpy-seeded inputs."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from situation_recognition_tpu.ops import ggnn_pallas as jp
from situation_recognition_tpu_torch.ops import ggnn as tg
from situation_recognition_tpu_torch.ops import ggnn_kernel as tk
from situation_recognition_tpu_torch.ops import ggnn_train as tt
from tests.test_torch_ggnn import _inputs, _params

# the same bf16 operands and f32 sums on both sides in other orders: as
# for K1 (test_torch_ggnn), a rare last-bit flip of a bf16 intermediate
# moves an element by a few bf16 ulp
ULP_TOL = 2 ** -7
# the backward's bf16 outputs (da, dh), relative to the largest element:
# a flipped bf16 da or dagg element (2^-8 relative) propagates through the
# reverse steps (measured at d=128: dh 1.2e-3, da 9.5e-4, 99.8% of the
# elements bit-equal)
BWD_REL_TOL = 2 ** -8
# parameter gradients: sums over steps*M rows of products of bf16 values,
# in f32; a few flipped da elements move them by a small fraction of the
# largest gradient (measured: 6.6e-4)
PARAM_REL_TOL = 4e-3

SHAPES = [(24, 6), (128, 1)]     # noun shape, verb shape (r=1, mask 0)


def _case(b, r, d, seed):
    jpar, tpar = _params(d, seed)
    h, mask = _inputs(b, r, d, seed)
    if r == 1:
        mask = np.zeros_like(mask)
    g = np.random.default_rng(seed + 7).standard_normal(
        (b, r, d)).astype(np.float32)
    return jpar, tpar, h, mask, g


def _bf16_rows(x, d):
    return torch.from_numpy(x.reshape(-1, d)).to(torch.bfloat16)


def _rel(a, b):
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-12))


def _jax_bwd_kernel(jpar, g_rows, mask_rows, resids, r, steps):
    """``_folded_kernel_bwd`` alone, interpret mode, one block holding all
    rows: its (dh, da) outputs, which ``_pallas_bwd`` keeps inside."""
    m, d = g_rows.shape
    wa, uzr, uh, _ = jp.fold_gate_weights(jpar, float(r))
    wts = jp._transpose_folded(wa, uzr, uh)
    kernel = functools.partial(jp._folded_kernel_bwd, bm=m, d=d, r=r,
                               steps=steps)
    bf = jnp.bfloat16
    dh, da = pl.pallas_call(
        kernel, grid=(1,),
        out_shape=[jax.ShapeDtypeStruct((m, d), bf),
                   jax.ShapeDtypeStruct((steps, m, 3 * d), bf)],
        scratch_shapes=[pltpu.VMEM((m, m), bf)],
        interpret=True,
    )(jnp.asarray(g_rows, bf), jnp.asarray(mask_rows[:, None]),
      *resids, *wts)
    return dh, da


@pytest.mark.parametrize("b,r", SHAPES)
def test_k2_twin_matches_pallas_interpret(b, r):
    d, steps = 128, 4
    jpar, tpar, h, mask, _ = _case(b, r, d, 11)
    m = b * r
    want_out, want_res = jp._propagate_fwd_res_impl(
        jpar, jnp.asarray(h), jnp.asarray(mask), steps, True)
    weights = tk.fold_gate_weights(tpar, float(r))
    got_out, got_res = tk.folded_reference_res(
        _bf16_rows(h, d), torch.from_numpy(mask.reshape(-1)), weights, r,
        steps)
    np.testing.assert_allclose(got_out.float().numpy().reshape(b, r, d),
                               np.asarray(want_out), rtol=0, atol=ULP_TOL)
    for name, got, want in zip("hzrc", got_res, want_res):
        want = np.asarray(want[:, :m].astype(jnp.float32))
        got = got.float().numpy()
        assert got.shape == (steps, m, d), name
        np.testing.assert_allclose(got, want, rtol=0, atol=ULP_TOL,
                                   err_msg=name)
        assert np.mean(got == want) > 0.95, name
    # the K1 twin is K2's output without the residuals
    np.testing.assert_array_equal(
        tk.folded_reference(_bf16_rows(h, d),
                            torch.from_numpy(mask.reshape(-1)), weights, r,
                            steps).float().numpy(),
        got_out.float().numpy())


@pytest.mark.parametrize("b,r", SHAPES)
def test_k3_twin_matches_pallas_interpret(b, r):
    d, steps = 128, 4
    jpar, tpar, h, mask, g = _case(b, r, d, 12)
    m = b * r
    mask_rows = mask.reshape(-1)
    # both backward kernels read the same residuals: JAX's, from K2
    _, jres = jp._propagate_fwd_res_impl(jpar, jnp.asarray(h),
                                         jnp.asarray(mask), steps, True)
    jres = tuple(x[:, :m] for x in jres)
    want_dh, want_da = _jax_bwd_kernel(jpar, g.reshape(m, d), mask_rows,
                                       jres, r, steps)
    tres = tuple(torch.from_numpy(np.array(x.astype(jnp.float32))).to(
        torch.bfloat16) for x in jres)
    weights = tk.fold_gate_weights(tpar, float(r))
    got_dh, got_da = tk.folded_bwd_reference(
        _bf16_rows(g, d), torch.from_numpy(mask_rows), tres,
        tk.transpose_folded(weights), r, steps)
    assert got_dh.dtype == torch.bfloat16 and got_dh.shape == (m, d)
    assert got_da.dtype == torch.bfloat16 and got_da.shape == (
        steps, m, 3 * d)
    want_dh = np.asarray(want_dh.astype(jnp.float32))
    want_da = np.asarray(want_da.astype(jnp.float32))
    assert _rel(got_dh.float().numpy(), want_dh) < BWD_REL_TOL
    assert _rel(got_da.float().numpy(), want_da) < BWD_REL_TOL
    assert np.mean(got_da.float().numpy() == want_da) > 0.9

    # the parameter gradients against _pallas_bwd end to end (its own
    # residual padding, fold and stacked einsums)
    want_dp, want_dh2 = jp._pallas_bwd(
        jpar, jnp.asarray(mask),
        jp._propagate_fwd_res_impl(jpar, jnp.asarray(h), jnp.asarray(mask),
                                   steps, True)[1],
        jnp.asarray(g), steps, True)
    np.testing.assert_allclose(np.asarray(want_dh2).reshape(m, d),
                               want_dh, rtol=0, atol=ULP_TOL)
    got_dp = tt.param_grads(tpar, torch.from_numpy(mask_rows), tres,
                            got_da, r)
    for name, a, w in zip(tg.GGNNParams._fields, got_dp, want_dp):
        assert _rel(a.numpy(), np.asarray(w)) < PARAM_REL_TOL, name


def _loss_weights(b, r, d, seed):
    return np.random.default_rng(seed).standard_normal(
        (b, r, d)).astype(np.float32)


@pytest.mark.parametrize("b,r", SHAPES)
def test_function_grads_match_jax_pallas_route(monkeypatch, b, r):
    """jax.grad of ggnn_propagate_pallas with SRTPU_GGNN_BWD=pallas
    (interpret) against the port's FoldedPropagate on the twins."""
    monkeypatch.setenv("SRTPU_GGNN_BWD", "pallas")
    d, steps = 128, 4
    jpar, tpar, h, mask, _ = _case(b, r, d, 13)
    w = _loss_weights(b, r, d, 14)
    assert jp.train_kernel_supported(d, r, steps) and b * r >= jp._MIN_ROWS

    def jloss(p, hh):
        out = jp.ggnn_propagate_pallas(p, hh, jnp.asarray(mask), steps, True)
        return jnp.sum(jnp.sin(out) * w)

    jdp, jdh = jax.grad(jloss, argnums=(0, 1))(jpar, jnp.asarray(h))

    tpar = tg.GGNNParams(*(p.clone().requires_grad_() for p in tpar))
    th = torch.from_numpy(h).requires_grad_()
    out = tt.ggnn_propagate_train(tpar, th, torch.from_numpy(mask), steps)
    assert out.dtype == torch.float32 and out.shape == (b, r, d)
    (torch.sin(out) * torch.from_numpy(w)).sum().backward()
    assert _rel(th.grad.numpy(), np.asarray(jdh)) < BWD_REL_TOL
    for name, p, jg_ in zip(tg.GGNNParams._fields, tpar, jdp):
        assert _rel(p.grad.numpy(), np.asarray(jg_)) < PARAM_REL_TOL, name


def test_function_grads_close_to_masked_autograd():
    """The kernel route (bf16 inside) against autograd over the f32
    masked-sum math: bf16-class agreement, the bound the JAX package's
    own test of its backward kernel uses (2e-2 of the largest gradient)."""
    d, b, r, steps = 64, 6, 6, 4
    _, tpar, h, mask, _ = _case(b, r, d, 15)
    w = torch.from_numpy(_loss_weights(b, r, d, 16))
    grads = []
    for fn in (tt.ggnn_propagate_train, tg.ggnn_propagate):
        p = tg.GGNNParams(*(x.clone().requires_grad_() for x in tpar))
        hh = torch.from_numpy(h).requires_grad_()
        (torch.sin(fn(p, hh, torch.from_numpy(mask), steps)) * w
         ).sum().backward()
        grads.append([hh.grad] + [x.grad for x in p])
    for a, m_ in zip(*grads):
        assert _rel(a.numpy(), m_.numpy()) < 2e-2


def test_wrappers_take_cpu_twins_and_count_no_launch():
    d, b, r, steps = 64, 3, 6, 2
    _, tpar, h, mask, g = _case(b, r, d, 17)
    weights = tk.fold_gate_weights(tpar, float(r))
    rows, mrows = _bf16_rows(h, d), torch.from_numpy(mask.reshape(-1))
    before = (tk.folded_rows_res.launches, tk.folded_bwd_rows.launches)
    out, res = tk.folded_rows_res(rows, mrows, weights, r, steps)
    ref_out, ref_res = tk.folded_reference_res(rows, mrows, weights, r,
                                               steps)
    assert torch.equal(out, ref_out)
    assert all(torch.equal(a, b_) for a, b_ in zip(res, ref_res))
    wt = tk.transpose_folded(weights)
    dh, da = tk.folded_bwd_rows(_bf16_rows(g, d), mrows, res, wt, r, steps)
    rdh, rda = tk.folded_bwd_reference(_bf16_rows(g, d), mrows, res, wt, r,
                                       steps)
    assert torch.equal(dh, rdh) and torch.equal(da, rda)
    assert (tk.folded_rows_res.launches,
            tk.folded_bwd_rows.launches) == before


def test_wrappers_have_no_fallback_off_cpu():
    h = torch.zeros(6, 64, dtype=torch.bfloat16, device="meta")
    m = torch.zeros(6, device="meta")
    with pytest.raises(ValueError, match="no GGNN kernel"):
        tk.folded_rows_res(h, m, (None,) * 4, 6, 1)
    with pytest.raises(ValueError, match="no GGNN kernel"):
        tk.folded_bwd_rows(h, m, (None,) * 4, (None,) * 3, 6, 1)


@pytest.mark.parametrize("value,route", [(None, "xla"), ("xla", "xla"),
                                         ("pallas", "pallas"),
                                         ("auto", "xla"), ("bogus", "xla")])
def test_resolve_ggnn_bwd_reads_the_jax_variable(monkeypatch, value, route):
    if value is None:
        monkeypatch.delenv("SRTPU_GGNN_BWD", raising=False)
    else:
        monkeypatch.setenv("SRTPU_GGNN_BWD", value)
    assert tt.resolve_ggnn_bwd() == route == jp.resolve_ggnn_bwd()
