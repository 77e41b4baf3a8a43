"""The LayerNorm pair's CPU side (``ops/layernorm.py``): the wrapper on CPU
tensors is ``ln_f32`` exactly, in values and gradients; the twins against
autograd of the composition; the plan of the kernels at the widths the
fine-tuning paths run; and no launch counted on the CPU."""

import pytest
import torch

from situation_recognition_tpu_torch.ops import layernorm as ln
from situation_recognition_tpu_torch.ops.vit import ln_f32

#: every width the ViT-L/14 and Swin-L fine-tuning paths normalise
WIDTHS = (192, 384, 768, 1024, 1536, 3072)
#: rows that fill no block of 256 threads at any of those widths
ROWS = 7


def _case(rows, d, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(rows, d, generator=g) * 2 + 0.5).to(dtype)
    gamma = 1 + 0.1 * torch.randn(d, generator=g)
    beta = 0.1 * torch.randn(d, generator=g)
    dy = torch.randn(rows, d, generator=g)
    return x, gamma, beta, dy


def _ln64(x, g, b, eps):
    """``ln_f32``'s composition, op for op, at x's type (float64 here)."""
    mu = x.mean(dim=-1, keepdim=True)
    xc = x - mu
    var = (xc * xc).mean(dim=-1, keepdim=True)
    return xc * torch.rsqrt(var + eps) * g + b


@pytest.mark.parametrize("dtype,out_dtype", [
    (torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32),
    (torch.float32, torch.float32)])
@pytest.mark.parametrize("shape", [(5, 192), (2, 3, 4, 64), (ROWS, 1024)])
def test_the_wrapper_on_cpu_is_ln_f32_bitwise(dtype, out_dtype, shape):
    g0 = torch.Generator().manual_seed(sum(shape))
    x0 = torch.randn(shape, generator=g0).to(dtype)
    gamma0 = 1 + 0.1 * torch.randn(shape[-1], generator=g0)
    beta0 = 0.1 * torch.randn(shape[-1], generator=g0)
    dy = torch.randn(shape, generator=g0).to(out_dtype)

    def run(fn):
        x, g, b = (t.clone().requires_grad_() for t in (x0, gamma0, beta0))
        y = fn(x, g, b)
        y.backward(dy)
        return y.detach(), x.grad, g.grad, b.grad

    got = run(lambda x, g, b: ln.layer_norm(x, g, b, 1e-5, out_dtype))
    want = run(lambda x, g, b: ln_f32(x, g, b, 1e-5).to(out_dtype))
    assert got[0].dtype == out_dtype and got[1].dtype == dtype
    for a, w in zip(got, want):
        assert torch.equal(a, w)


@pytest.mark.parametrize("d", WIDTHS)
def test_the_forward_twin_is_ln_f32_with_its_statistics(d):
    x, g, b, _ = _case(ROWS, d, torch.bfloat16, d)
    y, mean, rstd = ln.ln_fwd_reference(x, g, b, 1e-5)
    assert y.dtype == torch.bfloat16 and mean.shape == rstd.shape == (ROWS,)
    assert torch.equal(y, ln_f32(x, g, b, 1e-5).to(torch.bfloat16))
    xf = x.double()
    assert torch.allclose(mean.double(), xf.mean(dim=1), rtol=0, atol=1e-6)
    assert torch.allclose(rstd.double(), (xf.var(dim=1, unbiased=False)
                                          + 1e-5).rsqrt(), rtol=1e-5)
    y32, _, _ = ln.ln_fwd_reference(x, g, b, 1e-5, torch.float32)
    assert torch.equal(y32, ln_f32(x, g, b, 1e-5))


@pytest.mark.parametrize("d", WIDTHS)
def test_the_backward_twin_matches_autograd_in_float64(d):
    x, g, b, dy = (t.double() for t in _case(ROWS, d, torch.float64,
                                             100 + d))
    xs, gs, bs = (t.clone().requires_grad_() for t in (x, g, b))
    _ln64(xs, gs, bs, 1e-5).backward(dy)
    _, mean, rstd = ln.ln_fwd_reference(x, g, b, 1e-5)
    assert mean.dtype == torch.float64
    dx, dg, db = ln.ln_bwd_reference(x, dy, g, mean, rstd)
    for got, want in ((dx, xs.grad), (dg, gs.grad), (db, bs.grad)):
        assert got.dtype == torch.float64
        assert torch.allclose(got, want, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("d", WIDTHS)
def test_the_backward_twin_matches_autograd_of_ln_f32(d):
    # the same f32 arithmetic summed in other orders: within a few f32
    # roundings of the largest element (a sum over D or the rows, ~2^-24 x
    # sqrt(D) relative)
    x, g, b, dy = _case(ROWS, d, torch.float32, 200 + d)
    xs, gs, bs = (t.clone().requires_grad_() for t in (x, g, b))
    ln_f32(xs, gs, bs, 1e-5).backward(dy)
    _, mean, rstd = ln.ln_fwd_reference(x, g, b, 1e-5)
    for got, want in zip(ln.ln_bwd_reference(x, dy, g, mean, rstd),
                         (xs.grad, gs.grad, bs.grad)):
        assert (got - want).abs().max() <= 1e-5 * want.abs().max()


@pytest.mark.parametrize("d", WIDTHS)
def test_the_twins_take_a_bf16_x_and_an_f32_cotangent(d):
    # the Swin's final norm: bf16 rows, an f32 output and its gradient;
    # dx is rounded once to bf16 from the f32 formula
    x, g, b, dy = _case(ROWS, d, torch.bfloat16, 300 + d)
    xs, gs, bs = (t.clone().requires_grad_() for t in (x, g, b))
    ln_f32(xs, gs, bs, 1e-5).backward(dy)
    _, mean, rstd = ln.ln_fwd_reference(x, g, b, 1e-5, torch.float32)
    dx, dg, db = ln.ln_bwd_reference(x, dy, g, mean, rstd)
    assert dx.dtype == torch.bfloat16
    assert (dx.float() - xs.grad.float()).abs().max() \
        <= 2 ** -8 * xs.grad.float().abs().max()
    for got, want in ((dg, gs.grad), (db, bs.grad)):
        assert (got - want).abs().max() <= 1e-5 * want.abs().max()


@pytest.mark.parametrize("d,want", [
    (192, (8, 3)), (384, (16, 3)), (768, (32, 3)), (1024, (32, 4)),
    (1536, (64, 3)), (3072, (128, 3)), (32, (1, 4)), (128, (4, 4)),
    (40, None), (4, None), (100, None), (16384, None)])
def test_the_plan_of_a_row(d, want):
    assert ln.plan(d) == want
    if want is not None:
        tpr, vpt = want
        assert tpr * vpt * 8 == d
        assert tpr <= ln.THREADS and 1 <= vpt <= ln.MAX_VPT


@pytest.mark.parametrize("d,want", [
    (192, (8, 3)), (384, (16, 3)), (768, (32, 3)), (1024, (64, 2)),
    (1536, (64, 3)), (3072, (128, 3)), (32, (2, 2)), (40, None)])
def test_the_backward_plan_holds_at_most_three_loads(d, want):
    assert ln.plan(d, ln.MAX_VPT_BWD) == want


def test_the_kernels_refuse_a_cpu_tensor():
    x, g, b, dy = _case(ROWS, 192, torch.bfloat16, 1)
    with pytest.raises(ValueError, match="no layernorm kernel"):
        ln.ln_forward(x, g, b, 1e-5)
    with pytest.raises(ValueError, match="no layernorm kernel"):
        ln.ln_backward(x, dy.to(torch.bfloat16), g, *ln.ln_fwd_reference(
            x, g, b, 1e-5)[1:])


@pytest.mark.parametrize("model", ["swin", "vit_ft"])
def test_no_launch_is_counted_on_the_cpu(model):
    from situation_recognition_tpu_torch.ops import vit as tv
    from situation_recognition_tpu_torch.ops.vit_train import ft_cls_stack

    before = (ln.layer_norm.launches, ln.layer_norm.bwd_launches)
    if model == "swin":
        from situation_recognition_tpu_torch.models.swin import build_swin

        net = build_swin("swin_micro", 64, remat=True)
        net.reset_parameters(torch.Generator().manual_seed(0))
        net(torch.rand(2, 64, 64, 3)).square().sum().backward()
        assert net.norm.weight.grad is not None
    else:
        g = torch.Generator().manual_seed(0)
        d = 64
        shapes = [(d,), (d,), (3 * d, d), (3 * d,), (d, d), (d,), (d,),
                  (d,), (4 * d, d), (4 * d,), (d, 4 * d), (d,)]
        w = tv.BlockWeights(*(
            (0.1 * torch.randn(s, generator=g)).requires_grad_()
            for s in shapes))
        x = torch.randn(2, 5, d, generator=g, requires_grad=True)
        ft_cls_stack(x, [w], 2, 1e-6, False, True, True).sum().backward()
        assert w.ln1_w.grad is not None
    assert (ln.layer_norm.launches, ln.layer_norm.bwd_launches) == before \
        == (0, 0)
