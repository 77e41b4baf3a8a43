"""The ViT kernels' plain twins (``ops/vit.py``) and the port's encoder
paths (``ops/vit_kernel.py``, which run the twins on the CPU) against the
JAX package's Pallas kernels in interpret mode, on the same numpy-seeded
inputs, at ``tests/test_vit_pallas.py``'s smallest supported shape (width
128, 2 heads of 64, more than 1024 token rows).

Tolerances: the twins and the interpret-mode kernels multiply the same
bf16 operands in f32 and sum in f32 in other orders, so a bf16 output may
differ in its last bit now and then (2^-7 of its size at most); the K6
twin's GELU uses torch's erf where the TPU kernel has a 1.5e-7
approximation, which also flips a last bit now and then.  So each output
is held to 2^-6 of its largest element at most and 2^-10 of it on average.
Through a whole block or stack those flips feed the next products, so the
encoder paths are held to 2^-5 and 2^-9."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.special
import torch
from jax.experimental import pallas as pl

from situation_recognition_tpu.ops import vit_pallas as jv
from situation_recognition_tpu_torch.ops import vit as tv
from situation_recognition_tpu_torch.ops import vit_kernel as vk

B, N, D, HEADS = 8, 129, 128, 2
N8 = -(-N // 8) * 8
HID = 4 * D
MAX_REL, MEAN_REL = 2 ** -6, 2 ** -10
PATH_MAX_REL, PATH_MEAN_REL = 2 ** -5, 2 ** -9


def _params(seed):
    """The JAX kernels' 16 arguments after x, numpy f32, (in, out)."""
    rng = np.random.default_rng(seed)

    def w(*shape, scale=0.05, base=0.0):
        return (base + rng.standard_normal(shape) * scale).astype(np.float32)

    return dict(wq=w(D, D), bq=w(D), wk=w(D, D), bk=w(D), wv=w(D, D),
                bv=w(D), wo=w(D, D), bo=w(D), g1=w(D, base=1.0), bb1=w(D),
                g2=w(D, base=1.0), bb2=w(D), w1=w(D, HID), b1=w(HID),
                w2=w(HID, D), b2=w(D))


def _jax_args(p):
    return tuple(jnp.asarray(p[k]) for k in (
        "wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo", "g1", "bb1", "g2",
        "bb2", "w1", "b1", "w2", "b2"))


def _port_weights(p) -> tv.BlockWeights:
    """The same parameters in the port's layout, as the kernels take them
    (bf16 matrices (out, in), f32 vectors)."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    return vk.kernel_weights(tv.BlockWeights(
        t(p["g1"]), t(p["bb1"]),
        t(np.concatenate([p["wq"].T, p["wk"].T, p["wv"].T])),
        t(np.concatenate([p["bq"], p["bk"], p["bv"]])), t(p["wo"].T),
        t(p["bo"]), t(p["g2"]), t(p["bb2"]), t(p["w1"].T), t(p["b1"]),
        t(p["w2"].T), t(p["b2"])))


def _bf16(shape, seed):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    j = jnp.asarray(a, jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        torch.bfloat16)


def _np(t):
    return t.float().numpy() if torch.is_tensor(t) \
        else np.asarray(jnp.asarray(t, jnp.float32))


def _close(got, want, max_rel=MAX_REL, mean_rel=MEAN_REL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    diff = np.abs(got - want)
    assert diff.max() <= max_rel * scale, (diff.max(), scale)
    assert diff.mean() <= mean_rel * scale, (diff.mean(), scale)


def _call(kernel, args, out_shapes, grid=(1,), block=None):
    """``kernel`` as one interpret-mode pallas_call: each argument one
    whole block (or ``block`` rows of the first ones per grid step)."""
    def spec(a, blocked):
        if blocked:
            return pl.BlockSpec(block, lambda i: (i,) + (0,) * (
                len(block) - 1))
        return pl.BlockSpec(a.shape, lambda i: (0,) * a.ndim)

    n_blocked = 0 if block is None else len(args)
    in_specs = [spec(a, i < n_blocked) for i, a in enumerate(args)]
    outs = [jax.ShapeDtypeStruct(s, jnp.bfloat16) for s in out_shapes]
    out_specs = [spec(o, block is not None) for o in outs]
    single = len(outs) == 1
    return pl.pallas_call(
        kernel, grid=grid, in_specs=in_specs,
        out_specs=out_specs[0] if single else out_specs,
        out_shape=outs[0] if single else outs, interpret=True)(*args)


def _row(a):
    return jnp.asarray(a).reshape(1, -1).astype(jnp.float32)


def test_ln_and_gelu_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((64, D)).astype(np.float32) * 3 + 1
    g, b = (rng.standard_normal(D).astype(np.float32) for _ in range(2))
    want = np.asarray(jv._ln_f32(jnp.asarray(x), g, b, 1e-6))
    got = tv.ln_f32(torch.from_numpy(x), torch.from_numpy(g),
                    torch.from_numpy(b), 1e-6).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # exact GELU: the JAX formula with an exact erf, in float64 numpy
    # arithmetic.  JAX's own f32 erf was once off by up to 3e-4 below
    # x = -1.75 in one worker process of the suite (ROADMAP §3), where
    # 1 + erf cancels; QuickGELU has no erf and stays held to JAX's
    want = jv._gelu_exact_or_quick(x.astype(np.float64), False,
                                   scipy.special.erf)
    got = tv.gelu(torch.from_numpy(x), False).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    want = np.asarray(jv._gelu_exact_or_quick(jnp.asarray(x), True,
                                              jax.lax.erf))
    got = tv.gelu(torch.from_numpy(x), True).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_qkv_twin_matches_qkv_kernel():
    p = _params(1)
    xj, xt = _bf16((B * N8, D), 2)
    args = (xj, _row(p["g1"]), _row(p["bb1"]),
            *[a for k in "qkv" for a in (
                jnp.asarray(p["w" + k], jnp.bfloat16), _row(p["b" + k]))])
    want = _call(functools.partial(jv._qkv_kernel, eps=1e-6), args,
                 [(B * N8, D)] * 3)
    got = tv.qkv_reference(xt, _port_weights(p), 1e-6)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("folded", [True, False])
def test_attention_twin_matches_block_kernel(folded):
    """K5: the (B, N, D) per-block core, one example per grid step."""
    qkv = [_bf16((B, N, D), 10 + i) for i in range(3)]
    want = _call(functools.partial(jv._attn_core_kernel, heads=HEADS,
                                   scale=0.125, folded=folded),
                 [a for a, _ in qkv], [(B, N, D)], grid=(B,),
                 block=(1, N, D))
    got = tv.attn_core_reference(*(t.reshape(B * N, D) for _, t in qkv),
                                 HEADS, 0.125, folded, N, N)
    _close(got.reshape(B, N, D), want)
    # the port's K5 wrapper on the CPU is that twin
    got = vk.vit_attention_forward(*(t for _, t in qkv), HEADS, folded)
    _close(got, want)


@pytest.mark.parametrize("folded", [True, False])
def test_attention_twin_matches_stream_kernel(folded):
    """K7: the (B·n8, D) stream with N real rows per example; the pad rows
    come out zero."""
    qkv = [_bf16((B * N8, D), 20 + i) for i in range(3)]
    want = _call(functools.partial(jv._attn_core_stream_kernel, heads=HEADS,
                                   scale=0.125, folded=folded, n_valid=N),
                 [a for a, _ in qkv], [(B * N8, D)], grid=(B,),
                 block=(N8, D))
    got = vk.vit_attention_stream_forward(*(t for _, t in qkv), HEADS,
                                          folded, N8, N)
    _close(got, want)
    assert (got.reshape(B, N8, D)[:, N:] == 0).all()
    assert (_np(want).reshape(B, N8, D)[:, N:] == 0).all()


@pytest.mark.parametrize("quick", [False, True])
def test_out_mlp_twin_matches_out_mlp_kernel(quick):
    p = _params(3)
    xj, xt = _bf16((B * N8, D), 4)
    cj, ct = _bf16((B * N8, D), 5)
    bf = jnp.bfloat16
    args = (xj, cj, jnp.asarray(p["wo"], bf), _row(p["bo"]), _row(p["g2"]),
            _row(p["bb2"]), jnp.asarray(p["w1"], bf), _row(p["b1"]),
            jnp.asarray(p["w2"], bf), _row(p["b2"]))
    want = _call(functools.partial(jv._out_mlp_kernel, eps=1e-5,
                                   quick_gelu=quick), args, [(B * N8, D)])
    got = tv.out_mlp_reference(xt, ct, _port_weights(p), 1e-5, quick)
    _close(got, want)


@pytest.mark.parametrize("attn_core", ["exp2", "softmax"])
def test_encoder_block_matches_fused_block(attn_core):
    """The port's per-block path (K4 → K5 → K6) against
    ``fused_encoder_block(interpret=True)``."""
    p = _params(6)
    xj, xt = _bf16((B, N, D), 7)
    want = jv.fused_encoder_block(xj, *_jax_args(p), heads=HEADS, eps=1e-6,
                                  interpret=True, attn_core=attn_core)
    got = vk.encoder_block(xt, _port_weights(p), HEADS, 1e-6, False,
                           attn_core == "exp2")
    _close(got, want, PATH_MAX_REL, PATH_MEAN_REL)


@pytest.mark.parametrize("quick", [False, True])
def test_encoder_stack_matches_fused_stack(quick):
    """The port's stream stack (K4 → K7 → K6 per block, CLS rows) against
    ``fused_encoder_cls_stack(interpret=True)`` over two blocks."""
    ps = [_params(8), _params(9)]
    xj, xt = _bf16((B, N, D), 10)
    eps = 1e-5 if quick else 1e-6
    want = jv.fused_encoder_cls_stack(xj, [_jax_args(p) for p in ps],
                                      heads=HEADS, eps=eps,
                                      quick_gelu=quick, interpret=True)
    got = vk.encoder_cls_stack(xt, [_port_weights(p) for p in ps], HEADS,
                               eps, quick, True)
    assert got.shape == (B, D)
    _close(got, want, PATH_MAX_REL, PATH_MEAN_REL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_block_matches_jax_reference_block(dtype):
    """The plain path's block against ``_reference_block`` in the same
    type (f32: summation order only; bf16: both round every product)."""
    p = _params(11)
    xj, xt = _bf16((2, 17, D), 12)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jv._reference_block(xj.astype(jdt), *_jax_args(p), heads=HEADS,
                               eps=1e-6, quick_gelu=False)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    w = tv.BlockWeights(
        t(p["g1"]), t(p["bb1"]),
        t(np.concatenate([p["wq"].T, p["wk"].T, p["wv"].T])),
        t(np.concatenate([p["bq"], p["bk"], p["bv"]])), t(p["wo"].T),
        t(p["bo"]), t(p["g2"]), t(p["bb2"]), t(p["w1"].T), t(p["b1"]),
        t(p["w2"].T), t(p["b2"]))
    got = tv.reference_block(xt.to(tdt), w, HEADS, 1e-6, False)
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4,
                                   atol=1e-4)
    else:
        _close(got, want, PATH_MAX_REL, PATH_MEAN_REL)
