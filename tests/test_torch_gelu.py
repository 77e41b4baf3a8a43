"""The bias + GELU pair's CPU side (``ops/gelu.py``): the wrapper on CPU
tensors is the composition ``gelu(h + b)`` exactly, in values and
gradients; the twins against autograd of the composition; the plan of the
kernels at the widths the fine-tuning MLPs run; the wrappers' refusals;
and no launch counted on the CPU."""

import pytest
import torch

from situation_recognition_tpu_torch.ops import gelu as gk
from situation_recognition_tpu_torch.ops.vit import gelu

#: every fc1 width of the ViT-L/14 and Swin-L fine-tuning paths (ViT-B's
#: 3072 among Swin's)
WIDTHS = (768, 1536, 3072, 4096, 6144)
#: rows that fill no block of 256 threads at any of those widths
ROWS = 7


def _case(rows, d, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    h = (2 * torch.randn(rows, d, generator=g)).to(dtype)
    b = 0.5 * torch.randn(d, generator=g)
    dy = torch.randn(rows, d, generator=g).to(dtype)
    return h, b, dy


@pytest.mark.parametrize("quick", [False, True])
@pytest.mark.parametrize("d", WIDTHS)
def test_the_twins_match_autograd_of_the_composition_in_float64(d, quick):
    h, b, dy = (t.double() for t in _case(ROWS, d, torch.float64,
                                          d + quick))
    hs, bs = h.clone().requires_grad_(), b.clone().requires_grad_()
    y = gelu(hs + bs, quick)
    y.backward(dy)
    got = gk.gelu_fwd_reference(h, b, quick)
    dh, db = gk.gelu_bwd_reference(h, b, dy, quick)
    for a, w in ((got, y.detach()), (dh, hs.grad), (db, bs.grad)):
        assert a.dtype == torch.float64
        assert torch.allclose(a, w, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("quick", [False, True])
def test_the_twins_round_once_from_f32(quick):
    # bf16 h, an f32 bias: the twin's GELU in f32, rounded once to bf16;
    # db the f32 sum of the unrounded dh
    h, b, dy = _case(ROWS, 768, torch.bfloat16, 11 + quick)
    x = h.float() + b
    want = (x * torch.sigmoid(1.702 * x) if quick
            else 0.5 * x * (1 + torch.erf(x * 2.0 ** -0.5)))
    y = gk.gelu_fwd_reference(h, b, quick)
    assert y.dtype == torch.bfloat16
    assert torch.equal(y, want.to(torch.bfloat16))
    dh, db = gk.gelu_bwd_reference(h, b, dy, quick)
    assert dh.dtype == torch.bfloat16 and db.dtype == torch.float32
    xs = x.clone().requires_grad_()
    (xs * torch.sigmoid(1.702 * xs) if quick
     else 0.5 * xs * (1 + torch.erf(xs * 2.0 ** -0.5))).backward(dy.float())
    assert (dh.float() - xs.grad).abs().max() \
        <= 2 ** -8 * xs.grad.abs().max()
    assert (db - xs.grad.sum(dim=0)).abs().max() \
        <= 1e-5 * xs.grad.sum(dim=0).abs().max()


@pytest.mark.parametrize("quick", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(5, 768), (2, 3, 4, 64), (ROWS, 4096)])
def test_the_wrapper_on_cpu_is_the_composition_bitwise(shape, dtype, quick):
    g0 = torch.Generator().manual_seed(sum(shape) + quick)
    h0 = torch.randn(shape, generator=g0).to(dtype)
    b0 = 0.1 * torch.randn(shape[-1], generator=g0)
    dy = torch.randn(shape, generator=g0).to(dtype)

    def run(fn):
        h, b = h0.clone().requires_grad_(), b0.clone().requires_grad_()
        y = fn(h, b)
        y.backward(dy)
        return y.detach(), h.grad, b.grad

    got = run(lambda h, b: gk.bias_gelu(h, b, quick))
    want = run(lambda h, b: gelu(h + b.to(dtype), quick))
    assert got[0].dtype == dtype and got[2].dtype == torch.float32
    for a, w in zip(got, want):
        assert torch.equal(a, w)


@pytest.mark.parametrize("d,want", [
    (768, (32, 3)), (1536, (64, 3)), (3072, (128, 3)), (4096, (256, 2)),
    (6144, (256, 3)), (1024, (64, 2)), (64, (4, 2)), (40, None),
    (12288, None)])
def test_the_plan_of_a_row(d, want):
    assert gk.plan(d, gk.MAX_VPT) == want


def _misaligned(rows, d, dtype):
    """A contiguous (rows, d) view two bytes past a 16-byte boundary."""
    return torch.zeros(rows * d + 1, dtype=dtype)[1:].view(rows, d)


def test_the_wrappers_refuse_what_the_kernels_do_not_take():
    h, b, dy = _case(ROWS, 768, torch.bfloat16, 3)
    for args, match in (
            ((h.float(), b), "take non-empty rows of bf16"),
            ((h[:, :40].contiguous(), b[:40]), "take non-empty rows"),
            ((h[:0], b), "take non-empty rows"),
            ((h, b.to(torch.bfloat16)), r"bias must be \(768,\) f32"),
            ((h, b[:384]), r"bias must be \(768,\) f32"),
            ((h.t().contiguous().t(), b), "contiguous, 16-byte aligned"),
            ((_misaligned(ROWS, 768, torch.bfloat16), b),
             "contiguous, 16-byte aligned"),
            ((h, b), "no bias_gelu kernel for device cpu")):
        with pytest.raises(ValueError, match=match):
            gk.bias_gelu_forward(*args, False)
    for dy_bad, match in ((dy.float(), "dy must be bf16"),
                          (dy[:3], "dy must be bf16"),
                          (_misaligned(ROWS, 768, torch.bfloat16),
                           "contiguous, 16-byte aligned"),
                          (dy, "no bias_gelu kernel for device cpu")):
        with pytest.raises(ValueError, match=match):
            gk.bias_gelu_backward(h, b, dy_bad, True)


@pytest.mark.parametrize("model", ["swin", "vit_ft"])
def test_no_launch_is_counted_on_the_cpu(model):
    from situation_recognition_tpu_torch.ops import vit as tv
    from situation_recognition_tpu_torch.ops.vit_train import ft_cls_stack

    before = (gk.bias_gelu.launches, gk.bias_gelu.bwd_launches)
    if model == "swin":
        from situation_recognition_tpu_torch.models.swin import build_swin

        net = build_swin("swin_micro", 64, remat=True)
        net.reset_parameters(torch.Generator().manual_seed(0))
        net(torch.rand(2, 64, 64, 3)).square().sum().backward()
        assert net.layers[0].blocks[0].mlp.fc1.bias.grad is not None
    else:
        g = torch.Generator().manual_seed(0)
        d = 64
        shapes = [(d,), (d,), (3 * d, d), (3 * d,), (d, d), (d,), (d,),
                  (d,), (4 * d, d), (4 * d,), (d, 4 * d), (d,)]
        w = tv.BlockWeights(*(
            (0.1 * torch.randn(s, generator=g)).requires_grad_()
            for s in shapes))
        x = torch.randn(2, 5, d, generator=g, requires_grad=True)
        ft_cls_stack(x, [w], 2, 1e-6, True, True, True).sum().backward()
        assert w.fc1_b.grad is not None
    assert (gk.bias_gelu.launches, gk.bias_gelu.bwd_launches) == before \
        == (0, 0)
