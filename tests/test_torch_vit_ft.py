"""The fine-tuning (ft) stream of the ViT on the CPU: the K8 twin
(``ops/vit.attn_bwd_reference``), the differentiable attention core
(``ops/vit_train.DiffAttention``, which runs the K7 and K8 twins on CPU
tensors) and the ft stack (``ops/vit_train.ft_cls_stack``) against the JAX
package's Pallas kernels in interpret mode under ``jax.grad``, on the same
numpy-seeded inputs; the ViT module's routing of differentiated calls;
and the ResNet's per-block checkpointing.

Tolerances:
* the K8 twin and the interpret kernel form the same bf16 casts from f32
  sums in other orders: each gradient within 2^-8 of its largest element
  (a last-bit flip of a bf16 ds or e element), pad rows exactly zero;
* ``DiffAttention`` against ``_make_diff_attn``: the same twins' casts
  of the same inputs (bit-equal at this shape), so the context and the
  gradients are held to the K8 twin's 2^-8, at heads of 64 and of 128;
* the ft stack against the JAX ft stream over two blocks and a squared
  loss: the bounds of ``tests/test_vit_pallas.py``'s ft test — x within
  0.03 and every weight within 0.08 of its largest element, and the key
  bias ``bk``, whose true gradient is exactly zero (softmax does not see a
  per-query shift of the scores), within 1e-2 of the largest weight
  gradient in absolute value on both sides;
* checkpointing (remat) recomputes the same forward: bitwise."""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from situation_recognition_tpu.ops import vit_pallas as jv
from situation_recognition_tpu_torch.models import vit as tvit
from situation_recognition_tpu_torch.models.resnet import build_resnet
from situation_recognition_tpu_torch.ops import vit as tv
from situation_recognition_tpu_torch.ops import vit_kernel as vk
from situation_recognition_tpu_torch.ops import vit_train as tt

D, HEADS = 128, 2
SCALE = 1.0 / math.sqrt(D // HEADS)
NAMES = ("wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo", "g1", "bb1", "g2",
         "bb2", "w1", "b1", "w2", "b2")


def _bf16(shape, seed, scale=1.0):
    a = (np.random.default_rng(seed).standard_normal(shape) * scale).astype(
        np.float32)
    j = jnp.asarray(a, jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        torch.bfloat16)


def _np(t):
    return t.detach().float().numpy() if torch.is_tensor(t) \
        else np.asarray(jnp.asarray(t, jnp.float32))


def _rel(got, want):
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("b,stride,n_valid", [(3, 16, 13), (2, 13, 13),
                                              (2, 136, 129)])
def test_attn_bwd_twin_matches_pallas_kernel(b, stride, n_valid):
    """K8's twin against ``_attn_bwd_stream_kernel`` run as one interpret
    ``pallas_call`` per example, with and without pad rows."""
    ins = [_bf16((b * stride, D), 40 + i) for i in range(5)]
    spec = pl.BlockSpec((stride, D), lambda i: (i, 0))
    want = pl.pallas_call(
        functools.partial(jv._attn_bwd_stream_kernel, heads=HEADS,
                          scale=SCALE, n_valid=n_valid),
        grid=(b,), in_specs=[spec] * 5, out_specs=[spec] * 3,
        out_shape=[jax.ShapeDtypeStruct((b * stride, D), jnp.bfloat16)] * 3,
        interpret=True)(*[j for j, _ in ins])
    got = tv.attn_bwd_reference(*[t for _, t in ins], HEADS, SCALE, stride,
                                n_valid)
    # the wrapper runs the twin for CPU tensors and does not count it
    before = vk.vit_attention_backward.launches
    again = vk.vit_attention_backward(*[t for _, t in ins], HEADS, stride,
                                      n_valid)
    assert vk.vit_attention_backward.launches == before
    for name, g, w, a in zip(("dq", "dk", "dv"), got, want, again):
        assert g.dtype == torch.bfloat16
        assert _rel(g, w) <= 2 ** -8, name
        assert torch.equal(g, a), name
        assert (g.reshape(b, stride, D)[:, n_valid:] == 0).all(), name
        assert (_np(w).reshape(b, stride, D)[:, n_valid:] == 0).all(), name


def _diff_attention_case(d, heads, folded):
    """``DiffAttention`` (the K7 and K8 twins) against ``jax.grad`` through
    ``_make_diff_attn(interpret=True)`` with a squared loss, at stride 16
    with 13 real rows (the pad rows' gradients exactly zero)."""
    b, stride, nv = 2, 16, 13
    scale = 1.0 / math.sqrt(d // heads)
    qkv = [_bf16((b * stride, d), 50 + i) for i in range(3)]
    attn = jv._make_diff_attn(heads, scale, stride, nv, folded, True)
    o_j = attn(*[j for j, _ in qkv])
    g_j = jax.grad(lambda q, k, v: jnp.sum(
        attn(q, k, v).astype(jnp.float32) ** 2), argnums=(0, 1, 2))(
        *[j for j, _ in qkv])
    leaves = [t.clone().requires_grad_() for _, t in qkv]
    o_t = tt.DiffAttention.apply(*leaves, heads, folded, stride, nv)
    (o_t.float() ** 2).sum().backward()
    assert _rel(o_t, o_j) <= 2 ** -8
    for name, leaf, want in zip("qkv", leaves, g_j):
        assert leaf.grad.dtype == torch.bfloat16
        assert _rel(leaf.grad, want) <= 2 ** -8, name
        assert (leaf.grad.reshape(b, stride, d)[:, nv:] == 0).all(), name


@pytest.mark.parametrize("folded", [True, False])
def test_diff_attention_grads_match_jax(folded):
    """``_diff_attention_case`` at width 128 in 2 heads of 64."""
    _diff_attention_case(D, HEADS, folded)


@pytest.mark.parametrize("folded", [True, False])
def test_diff_attention_grads_match_jax_heads_of_128(folded):
    """``_diff_attention_case`` at width 256 in 2 heads of 128 (scale
    1/sqrt(128)), a head width the JAX kernels take; the same 2^-8."""
    _diff_attention_case(256, 2, folded)


def test_attn_bwd_twin_matches_pallas_kernel_heads_of_128():
    """K8's twin and the port's wrapper (the twin on the CPU) against
    ``_attn_bwd_stream_kernel`` at width 256 in 2 heads of 128, 129 real
    rows of a 136-row stride; the same 2^-8, pad rows exactly zero."""
    b, stride, n_valid, d, heads = 2, 136, 129, 256, 2
    scale = 1.0 / math.sqrt(d // heads)
    ins = [_bf16((b * stride, d), 70 + i) for i in range(5)]
    spec = pl.BlockSpec((stride, d), lambda i: (i, 0))
    want = pl.pallas_call(
        functools.partial(jv._attn_bwd_stream_kernel, heads=heads,
                          scale=scale, n_valid=n_valid),
        grid=(b,), in_specs=[spec] * 5, out_specs=[spec] * 3,
        out_shape=[jax.ShapeDtypeStruct((b * stride, d), jnp.bfloat16)] * 3,
        interpret=True)(*[j for j, _ in ins])
    got = vk.vit_attention_backward(*[t for _, t in ins], heads, stride,
                                    n_valid)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert _rel(g, w) <= 2 ** -8, name
        assert (g.reshape(b, stride, d)[:, n_valid:] == 0).all(), name


def _block_params(seed):
    """The JAX stack's 16 f32 arrays of one block, (in, out) layout."""
    rng = np.random.default_rng(seed)

    def w(*shape, base=0.0):
        return (base + rng.standard_normal(shape) * 0.05).astype(np.float32)

    hid = 4 * D
    return dict(wq=w(D, D), bq=w(D), wk=w(D, D), bk=w(D), wv=w(D, D),
                bv=w(D), wo=w(D, D), bo=w(D), g1=w(D, base=1.0), bb1=w(D),
                g2=w(D, base=1.0), bb2=w(D), w1=w(D, hid), b1=w(hid),
                w2=w(hid, D), b2=w(D))


def _port_leaves(p):
    """The same parameters as f32 leaves in the port's layout."""
    t = lambda a: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(a)).requires_grad_()
    return tv.BlockWeights(
        t(p["g1"]), t(p["bb1"]),
        t(np.concatenate([p["wq"].T, p["wk"].T, p["wv"].T])),
        t(np.concatenate([p["bq"], p["bk"], p["bv"]])), t(p["wo"].T),
        t(p["bo"]), t(p["g2"]), t(p["bb2"]), t(p["w1"].T), t(p["b1"]),
        t(p["w2"].T), t(p["b2"]))


def _port_grads(w: tv.BlockWeights) -> dict:
    """The port's parameter gradients under the JAX stack's names and
    layout."""
    g = {k: getattr(w, k).grad.numpy() for k in w._fields}
    iw, ib = g["in_w"], g["in_b"]
    return dict(wq=iw[:D].T, bq=ib[:D], wk=iw[D:2 * D].T, bk=ib[D:2 * D],
                wv=iw[2 * D:].T, bv=ib[2 * D:], wo=g["out_w"].T,
                bo=g["out_b"], g1=g["ln1_w"], bb1=g["ln1_b"], g2=g["ln2_w"],
                bb2=g["ln2_b"], w1=g["fc1_w"].T, b1=g["fc1_b"],
                w2=g["fc2_w"].T, b2=g["fc2_b"])


def _port_stack(ps, x_t, quick, remat):
    blocks = [_port_leaves(p) for p in ps]
    x = x_t.clone().requires_grad_()
    eps = 1e-5 if quick else 1e-6
    out = tt.ft_cls_stack(x, blocks, HEADS, eps, quick, True, remat)
    (out.float() ** 2).sum().backward()
    return out, x.grad, [_port_grads(w) for w in blocks]


@pytest.mark.parametrize("quick", [False, True])
def test_ft_cls_stack_grads_match_jax(quick):
    """Two blocks (width 128, 2 heads, batch 2, 13 tokens: the JAX stream
    pads each example to 16 rows, the port's is unpadded): the CLS rows
    and the gradients with respect to x and all 16 weights of each block
    against ``jax.grad`` of ``fused_encoder_cls_stack(interpret=True)``,
    which runs the JAX ft stream; remat on and off bitwise."""
    ps = [_block_params(60), _block_params(61)]
    x_j, x_t = _bf16((2, 13, D), 62)
    eps = 1e-5 if quick else 1e-6
    flat = tuple(jnp.asarray(p[k]) for p in ps for k in NAMES)

    def loss(x, flat):
        blocks = [flat[i * 16:(i + 1) * 16] for i in range(len(ps))]
        return jnp.sum(jv.fused_encoder_cls_stack(
            x, blocks, heads=HEADS, eps=eps, quick_gelu=quick,
            interpret=True, attn_core="exp2").astype(jnp.float32) ** 2)

    out_j = jv.fused_encoder_cls_stack(
        x_j, [flat[:16], flat[16:]], heads=HEADS, eps=eps, quick_gelu=quick,
        interpret=True, attn_core="exp2")
    gx_j, gw_j = jax.grad(loss, argnums=(0, 1))(x_j, flat)
    out_t, gx_t, gw_t = _port_stack(ps, x_t, quick, remat=False)

    assert out_t.shape == (2, D)
    assert _rel(out_t, out_j) <= 2 ** -5
    assert _rel(gx_t, gx_j) <= 0.03
    gscale = max(np.abs(np.asarray(g, np.float64)).max() for g in gw_j)
    for i, want in enumerate(gw_j):
        blk, name = divmod(i, 16)
        got = gw_t[blk][NAMES[name]]
        assert got.shape == want.shape, (blk, NAMES[name])
        if NAMES[name] == "bk":
            for g in (got, want):
                assert np.abs(np.asarray(g, np.float64)).max() <= \
                    1e-2 * gscale, blk
        else:
            assert _rel(torch.from_numpy(got), want) <= 0.08, (
                blk, NAMES[name])

    out_r, gx_r, gw_r = _port_stack(ps, x_t, quick, remat=True)
    assert torch.equal(out_r, out_t) and torch.equal(gx_r, gx_t)
    for a, b in zip(gw_r, gw_t):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _count(monkeypatch, calls, name):
    fn = getattr(vk, name)

    def counted(*args):
        calls[name] += 1
        return fn(*args)

    monkeypatch.setattr(vk, name, counted)


@pytest.mark.parametrize("remat", [False, True])
def test_vit_ft_path_never_reads_kernel_weights(remat, monkeypatch):
    """A differentiated call of a bf16 ViT on the kernel path (the twins on
    the CPU) takes the ft stream: one K7 forward per block (two with
    remat) and one K8 backward per block, never ``kernel_weights()``
    (made without a gradient, it would cut every weight's); every block
    weight gets a nonzero gradient but the key bias, whose true gradient
    is zero.  The undifferentiated call after it takes the forward
    kernels' stream again."""
    monkeypatch.delenv("SRTPU_VIT_STREAM", raising=False)
    m = tvit.ViT(16, 128, 2, 2, image_size=48, dtype=torch.bfloat16,
                 block_impl="kernel", remat=remat)
    m.reset_parameters(torch.Generator().manual_seed(3))
    images = torch.rand(2, 48, 48, 3,
                        generator=torch.Generator().manual_seed(4))
    calls = {"vit_attention_stream_forward": 0,
             "vit_attention_backward": 0}
    for name in calls:
        _count(monkeypatch, calls, name)

    def refuse(self):
        raise AssertionError("kernel_weights() read under autograd")

    with monkeypatch.context() as mp:
        mp.setattr(tvit.EncoderLayer, "kernel_weights", refuse)
        assert m.path(m.tokens(images)) == "ft"
        (m(images).float() ** 2).sum().backward()
    assert calls == {"vit_attention_stream_forward": 2 * (1 + remat),
                     "vit_attention_backward": 2}
    for blk in m.encoder.layers:
        grads = {k: getattr(blk.weights(), k).grad
                 for k in tv.BlockWeights._fields}
        bk = grads["in_b"][128:256]
        for k, g in grads.items():
            g = torch.cat([g[:128], g[256:]]) if k == "in_b" else g
            assert (g != 0).float().mean() > 0.9, k
        assert bk.abs().max() <= 1e-2 * grads["in_b"].abs().max()
    for p in (m.class_token, m.encoder.pos_embedding, m.conv_proj.weight,
              m.encoder.ln.weight):
        assert p.grad is not None and p.grad.abs().max() > 0
    with torch.no_grad():
        assert m.path(m.tokens(images)) == "stream"
        m(images)
    assert calls["vit_attention_stream_forward"] == 2 * (1 + remat) + 2


def test_vit_per_block_path_differentiates_the_plain_blocks(monkeypatch):
    """Under ``SRTPU_VIT_STREAM=0`` a differentiated call runs
    ``reference_block`` under autograd, as JAX's per-block VJP does: no
    attention kernel and no ``kernel_weights()``; with ``remat`` each
    block is checkpointed and the gradients are bitwise the same."""
    monkeypatch.setenv("SRTPU_VIT_STREAM", "0")
    monkeypatch.setattr(tvit.EncoderLayer, "kernel_weights", None)
    calls = {"vit_attention_stream_forward": 0, "vit_attention_forward": 0}
    for name in calls:
        _count(monkeypatch, calls, name)
    images = torch.rand(2, 48, 48, 3,
                        generator=torch.Generator().manual_seed(5))
    grads = []
    for remat in (False, True):
        m = tvit.ViT(16, 128, 2, 2, image_size=48, dtype=torch.bfloat16,
                     block_impl="kernel", remat=remat)
        m.reset_parameters(torch.Generator().manual_seed(6))
        assert m.path(m.tokens(images)) == "plain"
        (m(images).float() ** 2).sum().backward()
        grads.append([p.grad for p in m.parameters()])
    assert calls == {"vit_attention_stream_forward": 0,
                     "vit_attention_forward": 0}
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_resnet_remat_updates_bn_statistics_once():
    """Checkpointed bottlenecks recompute their forward inside the
    backward; the BN running statistics are updated once per step as
    without remat (flax's ``nn.remat``), and the gradients are the same."""
    nets = []
    for remat in (False, True):
        net = build_resnet("mini", 64, remat=remat)
        net.reset_parameters(torch.Generator().manual_seed(7))
        net.train()
        nets.append(net)
    x = torch.rand(4, 64, 64, 3, generator=torch.Generator().manual_seed(8))
    for net in nets:
        for _ in range(2):
            net.zero_grad()
            (net(x) ** 2).sum().backward()
    sd = [n.state_dict() for n in nets]
    for k in sd[0]:
        assert torch.equal(sd[0][k], sd[1][k]), k
    assert int(sd[1]["bn1.num_batches_tracked"]) == 2
    assert int(sd[1]["layer1.0.bn2.num_batches_tracked"]) == 2
    for (name, a), b in zip(nets[0].named_parameters(),
                            nets[1].parameters()):
        assert torch.equal(a.grad, b.grad), name
