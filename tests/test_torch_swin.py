"""The port's Swin Transformer (``models/swin.py``), its window-attention
core (``ops/swin.py``'s twins, ``ops/swin_kernel.py``'s wrappers and
autograd Function) and its place in the trainer, on the CPU at
``swin_micro`` in f32 on seeded weights:

* the module against the benchmark's plain reference
  (``benchmark/reference/backbones/swin.py``, loaded by its path; the port
  imports nothing of it): features, and the gradient of every parameter,
  the relative-position bias tables included, with and without remat;
* the twins against the published core under autograd: the context, dqkv
  and dbias, with and without a mask, and at bf16 against f32;
* the masks and the bias index against the published construction, and
  the published rule that a stage no larger than its window takes the
  whole map and does not shift;
* remat against no remat; the wrappers' calls (the CPU counts no
  launch);
* a fine-tuning ``Trainer`` step; the refusals (a wrong ``hidden``, the
  serving export).

Tolerances: f32 on both sides, the same equations summed in other orders
(batched matmuls against per-window ones, a hand backward against
autograd's): 1e-5 of the largest value."""

import importlib.util
import os

import numpy as np
import pytest
import torch

from situation_recognition_tpu_torch.models.backbone import build_backbone
from situation_recognition_tpu_torch.models.swin import (
    SWIN_CONFIGS, SWIN_WIDTHS, build_swin)
from situation_recognition_tpu_torch.ops import swin
from situation_recognition_tpu_torch.ops import swin_kernel as sk

BENCH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmark")
CFG = {"backbone": {"kind": "swin", "patch": 4, "embed": 32,
                    "depths": [2, 2, 2], "heads": [1, 2, 4], "window": 4,
                    "mlp_ratio": 4, "remat": False},
       "image": {"crop": 64}}
#: f32 against f32 in other summation orders, of the largest value
REL = 1e-5


@pytest.fixture
def reference(monkeypatch):
    """The benchmark's reference Swin, loaded from its file."""
    monkeypatch.syspath_prepend(BENCH)
    spec = importlib.util.spec_from_file_location(
        "bench_reference_swin",
        os.path.join(BENCH, "reference", "backbones", "swin.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    from reference.nets import Precision

    return mod, Precision("f32")


def _state(leaves, seed):
    """A state dict of the reference's leaves, each drawn by its init."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for name, shape, (kind, arg) in leaves:
        if kind == "normal":
            out[name] = torch.randn(shape, generator=g) * arg
        elif kind == "uniform":
            out[name] = (torch.rand(shape, generator=g) * 2 - 1) * arg
        else:
            # LayerNorms and biases drawn too, so that every gradient path
            # carries weight
            out[name] = torch.full(shape, float(arg)) + 0.1 * torch.randn(
                shape, generator=g)
    return out


def _images(n, seed):
    return torch.randn(n, 64, 64, 3, generator=torch.Generator().manual_seed(
        seed))


def _close(got, want, rel=REL):
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    assert err <= rel * scale, (err, scale)


@pytest.mark.parametrize("remat", [False, True])
def test_the_module_matches_the_reference(reference, remat):
    ref, p = reference
    sd = _state(ref.leaves(CFG), 1)
    model = build_swin("swin_micro", 64, remat=remat)
    assert set(model.state_dict()) == set(sd)
    model.load_state_dict(sd, strict=True)
    x = _images(3, 2)
    rsd = {k: v.clone().requires_grad_(True) for k, v in sd.items()}
    want = ref.features(CFG, rsd, x, p)
    got = model(x)
    assert got.shape == (3, SWIN_WIDTHS["swin_micro"])
    _close(got, want)
    w = torch.randn(want.shape, generator=torch.Generator().manual_seed(3))
    (want * w).sum().backward()
    (got * w).sum().backward()
    tables = 0
    for name, param in model.named_parameters():
        _close(param.grad, rsd[name].grad, 1e-4)
        tables += name.endswith("relative_position_bias_table")
    assert tables == sum(SWIN_CONFIGS["swin_micro"].depths)


def _core_case(bw, heads, window, masked, seed):
    g = torch.Generator().manual_seed(seed)
    n = window * window
    qkv = torch.randn(bw * n, 3 * 32 * heads, generator=g)
    bias = torch.randn(heads, n, n, generator=g)
    side = int(round((bw // 2) ** 0.5)) * window
    mask = swin.shift_mask(side, side, window, window // 2) if masked \
        else None
    dout = torch.randn(bw * n, 32 * heads, generator=g)
    return qkv, bias, mask, dout


def _published_core(qkv, bias, mask, heads, n, scale):
    """``WindowAttention.forward`` as published, from its qkv projection's
    output on: (BW·N, 3C) → (BW·N, C)."""
    c = qkv.shape[1] // 3
    x = qkv.reshape(-1, n, 3, heads, c // heads).permute(2, 0, 3, 1, 4)
    q, k, v = x[0] * scale, x[1], x[2]
    attn = q @ k.transpose(-2, -1) + bias.unsqueeze(0)
    if mask is not None:
        nw = mask.shape[0]
        attn = attn.view(-1, nw, heads, n, n) + mask.unsqueeze(1).unsqueeze(0)
        attn = attn.view(-1, heads, n, n)
    return (attn.softmax(dim=-1) @ v).transpose(1, 2).reshape(-1, c)


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("heads,window", [(2, 4), (3, 7)])
def test_the_twins_match_the_plain_composition(masked, heads, window):
    # two images of four windows
    qkv, bias, mask, dout = _core_case(8, heads, window, masked, heads)
    n, scale = window * window, 32 ** -0.5
    q = qkv.clone().requires_grad_(True)
    b = bias.clone().requires_grad_(True)
    want = _published_core(q, b, mask, heads, n, scale)
    want.backward(dout)
    got = swin.wattn_reference(qkv, bias, mask, heads, n, scale)
    dqkv, dbias = swin.wattn_bwd_reference(qkv, bias, mask, dout, heads, n,
                                           scale)
    _close(got, want.detach())
    _close(dqkv, q.grad)
    _close(dbias, b.grad)
    assert dbias.dtype == torch.float32
    # the forward twin is differentiable, and its autograd the backward's
    q.grad = b.grad = None
    swin.wattn_reference(q, b, mask, heads, n, scale).backward(dout)
    _close(dqkv, q.grad)
    _close(dbias, b.grad)


def test_the_twins_at_bf16_round_the_f32_ones():
    """At bf16 (the card's type) the twins round P, dS and their outputs
    to bf16: within a few bf16 steps of the f32 twins, dbias (f32 sums of
    f32 dS) closer."""
    qkv, bias, mask, dout = _core_case(8, 2, 4, True, 9)
    bf = torch.bfloat16
    args = (bias, mask)
    got = swin.wattn_reference(qkv.to(bf), *args, 2, 16, 32 ** -0.5)
    dqkv, dbias = swin.wattn_bwd_reference(qkv.to(bf), *args, dout.to(bf),
                                           2, 16, 32 ** -0.5)
    q32, k32 = (t.to(bf).float() for t in (qkv, dout))
    want = swin.wattn_reference(q32, *args, 2, 16, 32 ** -0.5)
    wdqkv, wdbias = swin.wattn_bwd_reference(q32, *args, k32, 2, 16,
                                             32 ** -0.5)
    assert got.dtype == dqkv.dtype == bf and dbias.dtype == torch.float32
    _close(got.float(), want, 2 ** -6)
    _close(dqkv.float(), wdqkv, 2 ** -6)
    _close(dbias, wdbias, 1e-5)


def test_the_function_gives_the_twins_gradients():
    qkv, bias, mask, dout = _core_case(8, 2, 4, True, 5)
    q = qkv.clone().requires_grad_(True)
    b = bias.clone().requires_grad_(True)
    out = sk.window_attention(q, b, mask, 2, 16)
    out.backward(dout)
    dqkv, dbias = swin.wattn_bwd_reference(qkv, bias, mask, dout, 2, 16,
                                           32 ** -0.5)
    assert torch.equal(q.grad, dqkv) and torch.equal(b.grad, dbias)


def _published_mask(h, w, window, shift):
    """``SwinTransformerBlock.__init__``'s ``attn_mask``, as published."""
    img_mask = torch.zeros((1, h, w, 1))
    cnt = 0
    for hs in (slice(0, -window), slice(-window, -shift),
               slice(-shift, None)):
        for ws in (slice(0, -window), slice(-window, -shift),
                   slice(-shift, None)):
            img_mask[:, hs, ws, :] = cnt
            cnt += 1
    x = img_mask.view(1, h // window, window, w // window, window, 1)
    windows = x.permute(0, 1, 3, 2, 4, 5).contiguous().view(
        -1, window * window)
    mask = windows.unsqueeze(1) - windows.unsqueeze(2)
    return mask.masked_fill(mask != 0, float(-100.0)).masked_fill(
        mask == 0, float(0.0))


def _published_index(window):
    coords = torch.stack(torch.meshgrid(
        [torch.arange(window), torch.arange(window)], indexing="ij"))
    flat = torch.flatten(coords, 1)
    rel = (flat[:, :, None] - flat[:, None, :]).permute(1, 2, 0).contiguous()
    rel[:, :, 0] += window - 1
    rel[:, :, 1] += window - 1
    rel[:, :, 0] *= 2 * window - 1
    return rel.sum(-1)


@pytest.mark.parametrize("res,window", [(56, 7), (28, 7), (14, 7), (16, 4),
                                        (8, 4)])
def test_masks_and_index_are_the_published_ones(res, window):
    got = swin.shift_mask(res, res, window, window // 2)
    assert torch.equal(got, _published_mask(res, res, window, window // 2))
    assert set(got.unique().tolist()) == {0.0, -100.0}
    assert got.shape == ((res // window) ** 2, window ** 2, window ** 2)
    assert torch.equal(swin.relative_position_index(window),
                       _published_index(window))


def _blocks(model):
    return [(i, blk) for i, layer in enumerate(model.layers)
            for blk in layer.blocks]


def test_a_stage_no_larger_than_its_window_does_not_shift():
    micro = build_swin("swin_micro", 64)
    got = [(i, blk.resolution, blk.window, blk.shift)
           for i, blk in _blocks(micro)]
    assert got == [(0, 16, 4, 0), (0, 16, 4, 2), (1, 8, 4, 0), (1, 8, 4, 2),
                   (2, 4, 4, 0), (2, 4, 4, 0)]
    assert all((blk.attn_mask is None) == (blk.shift == 0)
               for _, blk in _blocks(micro))
    # Swin-L at 224: 56, 28, 14 and 7 a side, the last stage one window
    cfg = SWIN_CONFIGS["swin_l"]
    shapes = [(i, blk.resolution, blk.window, blk.shift)
              for i, blk in _blocks(build_swin("swin_l", 224))]
    assert len(shapes) == sum(cfg.depths) == 24
    assert {s for s in shapes if s[0] == 3} == {(3, 7, 7, 0)}
    assert {s[1:] for s in shapes if s[0] == 2} == {(14, 7, 0), (14, 7, 3)}
    # a map smaller than the window takes it whole
    small = build_swin("swin_micro", 32)
    assert [(blk.resolution, blk.window, blk.shift)
            for i, blk in _blocks(small) if i == 2] == [(2, 2, 0)] * 2


def test_buffers_stay_out_of_the_state_dict():
    model = build_swin("swin_micro", 64)
    names = set(model.state_dict())
    assert names == {n for n, _ in model.named_parameters()}
    assert not any("relative_position_index" in n or "attn_mask" in n
                   for n in names)
    assert any(n.endswith("relative_position_index")
               for n, _ in model.named_buffers())


def _seeded(remat):
    model = build_swin("swin_micro", 64, remat=remat)
    model.reset_parameters(torch.Generator().manual_seed(4))
    return model


def test_remat_gives_the_same_numbers():
    x = _images(2, 6)
    outs = []
    for remat in (False, True):
        model = _seeded(remat)
        y = model(x)
        y.square().sum().backward()
        outs.append((y.detach(), [p.grad for p in model.parameters()]))
    assert torch.equal(outs[0][0], outs[1][0])
    for a, b in zip(outs[0][1], outs[1][1]):
        assert torch.equal(a, b)


@pytest.fixture
def calls(monkeypatch):
    """Calls of the two wrappers, counted by spies in their place; under
    ``"launches"`` the wrappers' own counters."""
    fns = (sk.wattn_forward, sk.wattn_backward)
    seen = {"forward": 0, "backward": 0,
            "launches": lambda: tuple(f.launches for f in fns)}
    for name, fn in zip(("forward", "backward"), fns):

        def spy(*a, _fn=fn, _name=name, **k):
            seen[_name] += 1
            return _fn(*a, **k)

        monkeypatch.setattr(sk, f"wattn_{name}", spy)
    return seen


@pytest.mark.parametrize("remat,grad,want", [(True, True, (12, 6)),
                                             (False, True, (6, 6)),
                                             (True, False, (6, 0))])
def test_the_launch_counters(calls, remat, grad, want):
    """A block a call of each: under remat a differentiated call runs
    every block's forward twice (Swin-L: 48 + 24 launches a fine-tuning
    step on the card).  On the CPU the calls run the twins and the
    ``launches`` counters stay where they were."""
    model = _seeded(remat)
    x = _images(2, 7)
    before = calls["launches"]()
    with torch.set_grad_enabled(grad):
        y = model(x)
        if grad:
            y.sum().backward()
    assert (calls["forward"], calls["backward"]) == want
    assert calls["launches"]() == before


def test_kernel_shapes_and_groups():
    bf, f32 = torch.bfloat16, torch.float32
    assert not sk.kernel_takes(64, 2, 49, f32)
    assert not sk.kernel_takes(64, 2, 65, bf)
    assert not sk.kernel_takes(128, 2, 49, bf)
    assert sk.kernel_takes(1536, 48, 49, bf)
    assert sk.groups(16384, 6) == 256 and sk.groups(256, 48) == 32
    assert sk.groups(3, 48) == 3


def test_a_fine_tuning_step_moves_every_parameter(calls):
    from situation_recognition_tpu_torch.data.encoder import ImsituEncoder
    from situation_recognition_tpu_torch.train import Trainer, TrainerConfig

    enc = ImsituEncoder.synthetic_full(0)
    tr = Trainer(enc, TrainerConfig(
        hidden=SWIN_WIDTHS["swin_micro"], batch_size=4,
        backbone="swin_micro", image_size=64, train_backbone=True,
        remat_backbone=True, compute_dtype=torch.float32), device="cpu")
    before = {n: p.detach().clone()
              for n, p in tr.backbone.named_parameters()}
    head = {n: p.detach().clone() for n, p in tr.head.named_parameters()}
    rng = np.random.default_rng(0)
    verbs = rng.integers(0, enc.get_num_verbs(), 4)
    real = np.arange(6)[None, None, :] < enc.role_counts[verbs][:, None,
                                                              None]
    labels = np.where(real, rng.integers(0, 2001, (4, 3, 6)), 2001)
    batch = {"images": rng.integers(0, 256, (4, 72, 72, 3), dtype=np.uint8),
             "flip": rng.random(4) < 0.5, "verbs": verbs, "labels": labels}
    _, _, losses = tr.train_epoch([batch], 0)
    assert np.isfinite(losses).all()
    assert (calls["forward"], calls["backward"]) == (12, 6)
    for n, p in tr.backbone.named_parameters():
        assert not torch.equal(p.detach(), before[n]), n
    moved = [not torch.equal(p.detach(), head[n])
             for n, p in tr.head.named_parameters()]
    assert all(moved)


def test_a_wrong_hidden_is_refused():
    with pytest.raises(ValueError, match="swin_l produces 1536-d features; "
                                         "set hidden=1536"):
        build_backbone("swin_l", 1024)
    model, has_bn = build_backbone("swin_micro", 128, 64)
    assert not has_bn and model.width == 128


def test_the_cli_and_the_export_name_swin(capsys):
    from situation_recognition_tpu_torch import export_serving
    from situation_recognition_tpu_torch.cli import _default_hidden

    assert _default_hidden("swin_l") == 1536
    with pytest.raises(SystemExit):
        export_serving.main(["ckpt", "out", "--backbone", "swin_l",
                             "--platform", "cpu"])
    assert "a Swin backbone cannot be exported" in capsys.readouterr().err
