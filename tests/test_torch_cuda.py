"""Card-only tests: the CUDA GGNN and ViT kernels against their plain
twins, the ViT's differentiable attention (K7 forward, K8 backward), and
the serving and training paths on the card.  Marked ``cuda``;
each test asks for the card in the ``cuda_device`` fixture and skips with
a reason where there is none (run them on the card with ``python -m
pytest tests/test_torch_cuda.py -m cuda``)."""

import numpy as np
import pytest
import torch

from situation_recognition_tpu_torch.ops import ggnn_kernel as tk
from situation_recognition_tpu_torch.ops.ggnn import GGNNParams

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(b, r, d, seed, verb=False):
    g = torch.Generator().manual_seed(seed)
    bound = 1.0 / d ** 0.5
    arrs = []
    for _ in range(7):
        arrs.append((torch.rand(d, d, generator=g) * 2 - 1) * bound)
        arrs.append((torch.rand(d, generator=g) * 2 - 1) * bound)
    params = GGNNParams(*arrs)
    h = torch.randn(b * r, d, generator=g).to(torch.bfloat16)
    counts = torch.randint(1, r + 1, (b,), generator=g)
    mask = (torch.arange(r)[None, :] < counts[:, None]).float().reshape(-1)
    if verb:
        mask.zero_()
    return params, h, mask


# bf16 outputs of the same bf16 operands with f32 sums in other orders:
# a last-bit flip of an intermediate can move |h| <= 1 by a few bf16 ulp
KERNEL_ATOL = 2 ** -5


@pytest.mark.parametrize("b,r,d,verb", [(24, 6, 256, False),
                                        (7, 6, 128, False),
                                        (130, 1, 192, True),
                                        (1, 1, 64, True)])
def test_kernel_matches_twin(cuda_device, b, r, d, verb):
    params, h, mask = _case(b, r, d, seed=b + d, verb=verb)
    weights = [w.to(cuda_device) for w in tk.fold_gate_weights(params,
                                                               float(r))]
    h, mask = h.to(cuda_device), mask.to(cuda_device)
    want = tk.folded_reference(h, mask, weights, r, 4)
    before = tk.folded_rows.launches
    got = tk.folded_rows(h, mask, weights, r, 4)
    torch.cuda.synchronize()
    assert tk.folded_rows.launches == before + 1
    err = (got.float() - want.float()).abs().max().item()
    assert err <= KERNEL_ATOL, err


def test_kernel_rejects_unsupported_shapes(cuda_device):
    params, h, mask = _case(2, 6, 96, seed=1)
    weights = [w.to(cuda_device) for w in tk.fold_gate_weights(params, 6.0)]
    with pytest.raises(ValueError, match="multiple of 64"):
        tk.folded_rows(h.to(cuda_device), mask.to(cuda_device), weights, 6, 1)
    params, h, mask = _case(2, 6, 64, seed=2)
    weights = [w.to(cuda_device) for w in tk.fold_gate_weights(params, 6.0)]
    with pytest.raises(ValueError, match="whole examples"):
        tk.folded_rows(h[:5].to(cuda_device), mask[:5].to(cuda_device),
                       weights, 6, 1)


def _card_case(b, r, d, seed, device, verb=False):
    """``_case`` on the card, folded there (f32 products without TF32)."""
    params, h, mask = _case(b, r, d, seed, verb)
    params = GGNNParams(*(p.to(device) for p in params))
    return (tk.fold_gate_weights(params, float(r)), h.to(device),
            mask.to(device))


def _check_folded(weights, h, mask, r, plan=None):
    """K1 and K2 (output and the four residual stacks) against their twins;
    ``plan``: the tiles, else ``tile_plan``'s."""
    want_out, want_res = tk.folded_reference_res(h, mask, weights, r, 4)
    got = tk._launch(h, mask, weights, r, 4, plan)
    got_out, got_res = tk._launch_res(h, mask, weights, r, 4, plan)
    torch.cuda.synchronize()
    for name, g, w in zip(("K1", "K2 out", "h", "z", "r", "c"),
                          (got, got_out) + got_res,
                          (want_out, want_out) + want_res):
        err = (g.float() - w.float()).abs().max().item()
        assert err <= KERNEL_ATOL, (name, err)


# K1/K2's tile edges: examples of r=6 and single rows (r=1) around the
# 64-row tiles of one consumer warpgroup and the 128-row tiles of two, at
# widths of one gate column group (64), three (192; only 64-column
# candidate tiles), the ViT head (1024) and the ResNet head (2048); ragged
# masks for r=6, and mask 0 (the verb branch: E = I) for r=1 and for some
# r=6 batches
FOLDED_EDGE_CASES = ([(b, 6, False) for b in (1, 10, 11, 21, 22, 43, 256)]
                     + [(b, 6, True) for b in (11, 43)]
                     + [(m, 1, True) for m in (1, 63, 64, 65, 127, 129,
                                               256)])


@pytest.mark.parametrize("d", (64, 192, 1024, 2048))
@pytest.mark.parametrize("b,r,verb", FOLDED_EDGE_CASES)
def test_folded_forward_tile_edges(cuda_device, b, r, verb, d):
    weights, h, mask = _card_case(b, r, d, b * r + d, cuda_device, verb)
    _check_folded(weights, h, mask, r)


@pytest.mark.parametrize("plan", [
    tk.TilePlan(gm, gn, cm, cn) for gm, cm in ((128, 64), (64, 128))
    for gn in (256, 128) for cn in (256, 128, 64)],
    ids=lambda p: "-".join(map(str, p)))
def test_folded_forward_every_tile_plan(cuda_device, plan):
    """Every instantiation of the gate and candidate GEMMs, whichever
    ``tile_plan`` would pick: 258 rows (a partial last tile of 64 and of
    128 rows), d = 512 (every gate and candidate width)."""
    weights, h, mask = _card_case(43, 6, 512, 5, cuda_device)
    _check_folded(weights, h, mask, 6, plan)


def test_folded_forward_is_deterministic(cuda_device):
    """Two launches of K1 and of K2 on the same inputs are bit-equal: each
    output element is summed by one warpgroup in a fixed order."""
    weights, h, mask = _card_case(43, 6, 1024, 7, cuda_device)
    first = tk.folded_rows(h, mask, weights, 6, 4)
    second = tk.folded_rows(h, mask, weights, 6, 4)
    assert torch.equal(first, second)
    first = tk.folded_rows_res(h, mask, weights, 6, 4)
    second = tk.folded_rows_res(h, mask, weights, 6, 4)
    assert torch.equal(first[0], second[0])
    for a, b in zip(first[1], second[1]):
        assert torch.equal(a, b)


def test_folded_forward_refuses_misaligned_operands(cuda_device):
    """h or a weight that TMA cannot read (a view one element into a
    buffer, so not 16-byte aligned; a transposed, non-contiguous one) is
    refused with ValueError before any launch."""
    m, d = 66, 128
    weights, h, mask = _card_case(11, 6, d, 8, cuda_device)
    buf = torch.zeros(m * d + 8, dtype=torch.bfloat16, device=cuda_device)
    shifted = buf[1:1 + m * d].view(m, d)
    strided = torch.zeros(d, m, dtype=torch.bfloat16, device=cuda_device).t()
    wbuf = torch.zeros(3 * d * d + 8, dtype=torch.bfloat16,
                       device=cuda_device)
    bad_wa = [wbuf[1:1 + 3 * d * d].view(d, 3 * d)] + list(weights[1:])
    bad_uh = list(weights[:2]) + [weights[2].t()] + [weights[3]]
    counts = (tk.folded_rows.launches, tk.folded_rows_res.launches)
    for fn in (tk.folded_rows, tk.folded_rows_res):
        for bad in (shifted, strided):
            with pytest.raises(ValueError, match="16-byte aligned"):
                fn(bad, mask, weights, 6, 4)
        for bad in (bad_wa, bad_uh):
            with pytest.raises(ValueError, match="16-byte aligned"):
                fn(h, mask, bad, 6, 4)
    torch.cuda.synchronize()
    assert (tk.folded_rows.launches, tk.folded_rows_res.launches) == counts


def test_serving_on_the_card_uses_the_kernel(cuda_device, tmp_path):
    from situation_recognition_tpu_torch.data.encoder import ImsituEncoder
    from situation_recognition_tpu_torch.serving import (
        SituationModel, export_inference, load_inference)

    enc = ImsituEncoder.synthetic_full(0)
    model = SituationModel(enc, backbone="mini", hidden=128,
                           dtype=torch.bfloat16)
    g = torch.Generator().manual_seed(0)
    model.backbone.reset_parameters(g)
    model.head.reset_parameters(g)
    export_inference(model, str(tmp_path / "art"), batch_size=4)
    fn = load_inference(str(tmp_path / "art"))
    plain = load_inference(str(tmp_path / "art"), ggnn_impl="masked")
    images = np.random.default_rng(0).integers(0, 256, (6, 256, 256, 3),
                                               dtype=np.uint8)
    before = tk.folded_rows.launches
    verb_logits, verb_ids, nouns = fn(images)
    torch.cuda.synchronize()
    # two chunks of the baked batch, two propagates each
    assert tk.folded_rows.launches == before + 4
    assert torch.isfinite(verb_logits).all() and torch.isfinite(nouns).all()
    pv, _, _ = plain(images)
    assert (verb_logits - pv).abs().max().item() < 0.25


# K3 against its twin, relative to the largest element of the twin's
# output: a flipped bf16 da or dagg element propagates through the reverse
# steps (the twin meets the JAX kernel to 2^-10 of it at d=128)
BWD_REL_ATOL = 2 ** -5


@pytest.mark.parametrize("b,r,d,verb", [(24, 6, 256, False),
                                        (7, 6, 128, False),
                                        (130, 1, 192, True),
                                        (43, 6, 1024, False),
                                        (256, 6, 2048, False)])
def test_backward_pair_matches_twins(cuda_device, b, r, d, verb):
    params, h, mask = _case(b, r, d, seed=b + d + 1, verb=verb)
    weights = [w.to(cuda_device) for w in tk.fold_gate_weights(params,
                                                               float(r))]
    h, mask = h.to(cuda_device), mask.to(cuda_device)
    before = (tk.folded_rows_res.launches, tk.folded_bwd_rows.launches)
    out, res = tk.folded_rows_res(h, mask, weights, r, 4)
    want_out, want_res = tk.folded_reference_res(h, mask, weights, r, 4)
    for got, want in zip((out,) + res, (want_out,) + want_res):
        assert (got.float() - want.float()).abs().max().item() <= KERNEL_ATOL
    g = torch.randn(h.shape, generator=torch.Generator().manual_seed(b)).to(
        torch.bfloat16).to(cuda_device)
    dh, da = tk.folded_bwd_rows(g, mask, res, weights, r, 4)
    want_dh, want_da = tk.folded_bwd_reference(g, mask, res, weights, r, 4)
    torch.cuda.synchronize()
    assert (tk.folded_rows_res.launches,
            tk.folded_bwd_rows.launches) == (before[0] + 1, before[1] + 1)
    for got, want in ((dh, want_dh), (da, want_da)):
        scale = want.float().abs().max().item()
        err = (got.float() - want.float()).abs().max().item()
        assert err <= BWD_REL_ATOL * scale, (err, scale)


# and the mean error, relative to the same scale: a wrong tile or fragment
# gives errors of the order of the largest element over whole tiles
BWD_REL_MEAN = 2 ** -10


def _check_bwd(weights, h, mask, r, plan=None, seed=0):
    """K3 (``plan``: its tiles, else ``bwd_tile_plan``'s) on K2's residuals
    against the twin on the same residuals: dh and da within BWD_REL_ATOL
    (max) and BWD_REL_MEAN (mean) of the twin's largest element."""
    _, res = tk._launch_res(h, mask, weights, r, 4)
    g = torch.randn(h.shape, generator=torch.Generator().manual_seed(seed))
    g = g.to(torch.bfloat16).to(h.device)
    got = tk._launch_bwd(g, mask, res, weights, r, 4, plan)
    want = tk.folded_bwd_reference(g, mask, res, weights, r, 4)
    torch.cuda.synchronize()
    for name, a, w in zip(("dh", "da"), got, want):
        assert a.shape == w.shape and a.dtype == torch.bfloat16, name
        scale = w.float().abs().max().item()
        diff = (a.float() - w.float()).abs()
        assert diff.max().item() <= BWD_REL_ATOL * scale, (name, diff.max())
        assert diff.mean().item() <= BWD_REL_MEAN * scale, (name,
                                                            diff.mean())


@pytest.mark.parametrize("d", (64, 192, 1024, 2048))
@pytest.mark.parametrize("b,r,verb", FOLDED_EDGE_CASES)
def test_folded_backward_tile_edges(cuda_device, b, r, verb, d):
    """K3 at K1/K2's tile edges: examples of r=6 and single rows around
    the 64- and 128-row tiles, widths of one, three, 16 and 32 column
    tiles of 64, ragged masks and mask 0 (E = I)."""
    weights, h, mask = _card_case(b, r, d, b * r + d + 3, cuda_device, verb)
    _check_bwd(weights, h, mask, r, seed=b + d)


@pytest.mark.parametrize("plan", [
    tk.BwdTilePlan(bm, bn, bm, bn, bm, bn) for bm in (128, 64)
    for bn in (256, 128, 64)] + [tk.BwdTilePlan(64, 64, 128, 256, 64, 128),
                                 tk.BwdTilePlan(128, 128, 64, 256, 128, 64)],
    ids=lambda p: "-".join(map(str, p)))
def test_folded_backward_every_tile_plan(cuda_device, plan):
    """Every instantiation of K3's three GEMMs, whichever
    ``bwd_tile_plan`` would pick, and plans that give the three GEMMs
    different tiles: 258 rows (a partial last tile of 64 and of 128 rows),
    d = 512."""
    weights, h, mask = _card_case(43, 6, 512, 9, cuda_device)
    _check_bwd(weights, h, mask, 6, plan, seed=9)


def test_folded_backward_is_deterministic(cuda_device):
    """Two launches of K3 on the same inputs are bit-equal: each output
    element is summed by one warpgroup in a fixed order."""
    weights, h, mask = _card_case(43, 6, 1024, 10, cuda_device)
    _, res = tk.folded_rows_res(h, mask, weights, 6, 4)
    g = torch.randn(h.shape, generator=torch.Generator().manual_seed(10))
    g = g.to(torch.bfloat16).to(cuda_device)
    first = tk.folded_bwd_rows(g, mask, res, weights, 6, 4)
    second = tk.folded_bwd_rows(g, mask, res, weights, 6, 4)
    assert torch.equal(first[0], second[0])
    assert torch.equal(first[1], second[1])


def test_folded_backward_refuses_misaligned_operands(cuda_device):
    """g, a residual stack or a folded weight that TMA cannot read (one
    element into a buffer; transposed) is refused with ValueError before
    any launch; so is a transposed weight of the right shape's
    transpose."""
    m, d = 66, 128
    weights, h, mask = _card_case(11, 6, d, 11, cuda_device)
    _, res = tk.folded_rows_res(h, mask, weights, 6, 4)
    g = h.clone()
    buf = torch.zeros(m * d + 8, dtype=torch.bfloat16, device=cuda_device)
    shifted = buf[1:1 + m * d].view(m, d)
    rbuf = torch.zeros(4 * m * d + 8, dtype=torch.bfloat16,
                       device=cuda_device)
    bad_res = (rbuf[1:1 + 4 * m * d].view(4, m, d),) + tuple(res[1:])
    wbuf = torch.zeros(3 * d * d + 8, dtype=torch.bfloat16,
                       device=cuda_device)
    bad_wa = [wbuf[1:1 + 3 * d * d].view(d, 3 * d)] + list(weights[1:])
    bad_uh = list(weights[:2]) + [weights[2].t()] + [weights[3]]
    before = tk.folded_bwd_rows.launches
    for args in ((shifted, res, weights), (g, bad_res, weights),
                 (g, res, bad_wa), (g, res, bad_uh)):
        with pytest.raises(ValueError, match="16-byte aligned"):
            tk.folded_bwd_rows(args[0], mask, args[1], args[2], 6, 4)
    with pytest.raises(ValueError, match="must be"):
        tk.folded_bwd_rows(g, mask, res, [weights[0].t().contiguous()]
                           + list(weights[1:]), 6, 4)
    torch.cuda.synchronize()
    assert tk.folded_bwd_rows.launches == before


def test_folded_backward_ring_fits_shared_memory(cuda_device):
    """The library's shared memory per GEMM tile is the ring that
    ``gemm_smem`` describes to the host and fits a block; its setmaxnreg
    split is K1/K2's."""
    lib = tk._lib("ggnn_folded_bwd.cu", "ggnn_folded_bwd_smem")
    tk._lib("ggnn_folded_bwd.cu", "ggnn_folded_bwd_maxnreg")
    for bm in (64, 128):
        for bn in (64, 128, 256):
            assert lib.ggnn_folded_bwd_smem(bm, bn) == tk.gemm_smem(bm, bn)
    assert lib.ggnn_folded_bwd_smem(32, 64) == 0
    assert (lib.ggnn_folded_bwd_maxnreg(0),
            lib.ggnn_folded_bwd_maxnreg(1)) == (40, 232)


@pytest.mark.parametrize("b,r,d,verb", [(43, 6, 1024, False),
                                        (256, 1, 2048, True)])
def test_param_products_on_the_card_match_f32(cuda_device, b, r, d, verb):
    """The route's parameter products on the tensor cores (bf16 operands,
    f32 accumulation and output) against f32 products of f32 copies: the
    same exact products summed in another order, within 1e-4 of each
    tensor's largest element; TF32 stays off."""
    from situation_recognition_tpu_torch.ops import ggnn_train as tt

    weights, h, mask = _card_case(b, r, d, b + d + 12, cuda_device, verb)
    _, res = tk.folded_rows_res(h, mask, weights, r, 4)
    g = torch.randn(h.shape, generator=torch.Generator().manual_seed(12))
    _, da = tk.folded_bwd_rows(g.to(torch.bfloat16).to(cuda_device), mask,
                               res, weights, r, 4)
    ops = tt.param_operands(mask, res, da, r)
    assert all(x.dtype == torch.bfloat16 for x in ops)
    got = tt.param_products(*ops)
    want = tt.param_products_f32(*ops)
    torch.cuda.synchronize()
    assert not torch.backends.cuda.matmul.allow_tf32
    for name, a, w in zip(("dWa", "dUzr", "dUh"), got, want):
        assert a.dtype == torch.float32 and a.shape == w.shape, name
        scale = w.abs().max().item()
        assert (a - w).abs().max().item() <= 1e-4 * scale, name


def test_served_resnet_keeps_batchnorm_in_f32_on_the_card(cuda_device,
                                                          tmp_path):
    """A bf16 ResNet artifact served on the card keeps its BatchNorm in
    f32 and matches the frozen Trainer's eval features on the same weights
    and images (both bf16 convolutions, f32 BN, channels-last; cuDNN may
    choose other algorithms for the two, so within 2^-6 of the largest
    feature)."""
    from situation_recognition_tpu_torch.data.encoder import ImsituEncoder
    from situation_recognition_tpu_torch.serving import (
        SituationModel, export_inference, load_inference)
    from situation_recognition_tpu_torch.train import Trainer, TrainerConfig

    enc = ImsituEncoder.synthetic_full(0)
    model = SituationModel(enc, backbone="mini", hidden=128,
                           dtype=torch.bfloat16)
    gen = torch.Generator().manual_seed(3)
    model.backbone.reset_parameters(gen)
    model.head.reset_parameters(gen)
    rng = np.random.default_rng(3)
    with torch.no_grad():
        for bn in model.backbone.modules():
            if isinstance(bn, torch.nn.BatchNorm2d):
                c = bn.num_features
                bn.running_mean.copy_(torch.from_numpy(rng.normal(0, 3, c)))
                bn.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, c)))
    path = str(tmp_path / "art")
    export_inference(model, path, batch_size=2)
    fn = load_inference(path)
    bns = [m for m in fn.model.backbone.modules()
           if isinstance(m, torch.nn.BatchNorm2d)]
    assert bns and all(t.dtype == torch.float32 for bn in bns for t in (
        bn.weight, bn.bias, bn.running_mean, bn.running_var))
    state = torch.load(f"{path}/weights.pt", weights_only=True)
    trainer = Trainer(enc, TrainerConfig(
        hidden=128, batch_size=2, backbone="mini",
        compute_dtype=torch.bfloat16), backbone_state=state["backbone"],
        head_state=state["head"])
    images = torch.from_numpy(np.random.default_rng(4).integers(
        0, 256, (2, 256, 256, 3), dtype=np.uint8)).to(cuda_device)
    want = trainer._features(images, None, False)
    with torch.inference_mode():
        got = fn.model.features(images)
    scale = want.abs().max().item()
    assert (got - want).abs().max().item() <= 2 ** -6 * scale


def test_train_step_on_the_card_launches_the_kernels(cuda_device,
                                                     monkeypatch):
    """A bf16 train step and an eval step of the mini trainer on the card:
    K1 once per train step (the gt branch) under both routes, K2 and K3
    twice each under SRTPU_GGNN_BWD=pallas; K1 three times per eval
    step."""
    from situation_recognition_tpu_torch.data.encoder import ImsituEncoder
    from situation_recognition_tpu_torch.train import Trainer, TrainerConfig

    enc = ImsituEncoder.synthetic_full(0)
    rng = np.random.default_rng(0)
    n = 4
    verbs = rng.integers(0, 504, n)
    labels = np.where(np.arange(6)[None, None, :]
                      < enc.role_counts[verbs][:, None, None],
                      rng.integers(0, 2001, (n, 3, 6)), 2001)
    batch = {"images": rng.integers(0, 256, (n, 256, 256, 3),
                                    dtype=np.uint8),
             "flip": rng.random(n) < 0.5, "verbs": verbs, "labels": labels}
    for route, k23 in (("xla", 0), ("pallas", 2)):
        monkeypatch.setenv("SRTPU_GGNN_BWD", route)
        tr = Trainer(enc, TrainerConfig(hidden=128, batch_size=n,
                                        backbone="mini"))
        assert tr.head.ggsnn.impl == "kernel"
        before = (tk.folded_rows.launches, tk.folded_rows_res.launches,
                  tk.folded_bwd_rows.launches)
        _, _, losses = tr.train_epoch([batch], 0)
        torch.cuda.synchronize()
        assert np.isfinite(losses).all()
        assert (tk.folded_rows.launches - before[0],
                tk.folded_rows_res.launches - before[1],
                tk.folded_bwd_rows.launches - before[2]) == (1, k23, k23)
        before = tk.folded_rows.launches
        _, _, val, _ = tr.evaluate([batch])
        assert tk.folded_rows.launches - before == 3
        assert all(np.isfinite(v) for v in val.values())


# ---------------------------------------------------------------- the ViT


def _vit_weights(d, hid, seed):
    from situation_recognition_tpu_torch.ops.vit import BlockWeights

    rng = np.random.default_rng(seed)

    def w(*shape, scale=0.05, base=0.0):
        return torch.from_numpy(
            (base + rng.standard_normal(shape) * scale).astype(np.float32))

    return BlockWeights(1.0 + w(d), w(d), w(3 * d, d), w(3 * d), w(d, d),
                        w(d), 1.0 + w(d), w(d), w(hid, d), w(hid),
                        w(d, hid), w(d))


# kernel vs twin on the same bf16 operands: f32 sums in other orders flip
# the last bit of a bf16 output now and then (2^-7 of its size at most);
# a wrong tile moves elements by the order of the largest one
VIT_MAX_REL = 2 ** -6
VIT_MEAN_REL = 2 ** -10


def _assert_close_rel(got, want):
    scale = want.float().abs().max().item()
    diff = (got.float() - want.float()).abs()
    assert diff.max().item() <= VIT_MAX_REL * scale, (diff.max(), scale)
    assert diff.mean().item() <= VIT_MEAN_REL * scale, (diff.mean(), scale)


def _check_qkv(device, m, d):
    from situation_recognition_tpu_torch.ops import vit as tv
    from situation_recognition_tpu_torch.ops import vit_kernel as vk

    w = [t.to(device) for t in vk.kernel_weights(_vit_weights(d, 4 * d, m))]
    w = tv.BlockWeights(*w)
    x = torch.randn(m, d, generator=torch.Generator().manual_seed(m)).to(
        torch.bfloat16).to(device)
    before = vk.vit_qkv_forward.launches
    got = vk.vit_qkv_forward(x, w, 1e-6)
    want = tv.qkv_reference(x, w, 1e-6)
    torch.cuda.synchronize()
    assert vk.vit_qkv_forward.launches == before + 1
    for g, t in zip(got, want):
        _assert_close_rel(g, t)


@pytest.mark.parametrize("m,d", [(1000, 128), (300, 192), (4 * 264, 1024)])
def test_vit_qkv_kernel_matches_twin(cuda_device, m, d):
    _check_qkv(cuda_device, m, d)


# the GEMM's tile edges: rows around its 128-row tiles (64 per consumer
# warpgroup, 16 per warp in two 8-row halves), and widths whose products
# (N = 3D for qkv, H = 4D for fc1, D for the out-projection and fc2) take
# 128-column tiles with a partial last one (N % 256 != 0) or 256-column
# tiles
GEMM_EDGE_ROWS = (1, 63, 64, 65, 127, 129, 4 * 257)
GEMM_EDGE_WIDTHS = (64, 192, 1024)


@pytest.mark.parametrize("d", GEMM_EDGE_WIDTHS)
@pytest.mark.parametrize("m", GEMM_EDGE_ROWS)
def test_vit_qkv_kernel_tile_edges(cuda_device, m, d):
    _check_qkv(cuda_device, m, d)


@pytest.mark.parametrize("b,n,stride,heads,folded", [
    (3, 257, 264, 2, True), (3, 257, 257, 2, False), (2, 50, 56, 1, True),
    (2, 17, 17, 3, False), (2, 129, 136, 16, False),
    # ViT-L/14 at 336² and a longer sequence: many key tiles
    (2, 577, 577, 2, True), (2, 577, 584, 1, False), (1, 1025, 1025, 1, True),
    # the tile boundaries of the 64-query tiles, 64-key tiles and 16-row
    # warps, through K5 (stride N) and K7 with pad rows, both flavours
    *[(2, n, n + pad, 2, folded) for n in (1, 63, 64, 65, 128)
      for folded, pad in ((True, 0), (False, 7))]])
def test_vit_attention_kernel_matches_twin(cuda_device, b, n, stride, heads,
                                           folded):
    from situation_recognition_tpu_torch.ops import vit as tv
    from situation_recognition_tpu_torch.ops import vit_kernel as vk

    g = torch.Generator().manual_seed(b * n + heads)
    d = 64 * heads
    q, k, v = (torch.randn(b * stride, d, generator=g).to(torch.bfloat16)
               .to(cuda_device) for _ in range(3))
    want = tv.attn_core_reference(q, k, v, heads, 0.125, folded, stride, n)
    if stride == n:
        before = vk.vit_attention_forward.launches
        got = vk.vit_attention_forward(
            q.reshape(b, n, d), k.reshape(b, n, d), v.reshape(b, n, d),
            heads, folded).reshape(b * n, d)
        count = vk.vit_attention_forward.launches - before
    else:
        before = vk.vit_attention_stream_forward.launches
        got = vk.vit_attention_stream_forward(q, k, v, heads, folded,
                                              stride, n)
        count = vk.vit_attention_stream_forward.launches - before
    torch.cuda.synchronize()
    assert count == 1
    _assert_close_rel(got, want)
    pad = got.reshape(b, stride, d)[:, n:]
    assert (pad == 0).all()


def _check_out_mlp(device, m, d, quick):
    from situation_recognition_tpu_torch.ops import vit as tv
    from situation_recognition_tpu_torch.ops import vit_kernel as vk

    w = tv.BlockWeights(*(t.to(device) for t in vk.kernel_weights(
        _vit_weights(d, 4 * d, m + 1))))
    g = torch.Generator().manual_seed(m + d)
    x, ctx = (torch.randn(m, d, generator=g).to(torch.bfloat16)
              .to(device) for _ in range(2))
    before = vk.vit_out_mlp_forward.launches
    got = vk.vit_out_mlp_forward(x, ctx, w, 1e-5, quick)
    want = tv.out_mlp_reference(x, ctx, w, 1e-5, quick)
    torch.cuda.synchronize()
    assert vk.vit_out_mlp_forward.launches == before + 1
    _assert_close_rel(got, want)


@pytest.mark.parametrize("m,d,quick", [(1000, 128, False), (300, 192, True),
                                       (4 * 264, 1024, False)])
def test_vit_out_mlp_kernel_matches_twin(cuda_device, m, d, quick):
    _check_out_mlp(cuda_device, m, d, quick)


@pytest.mark.parametrize("quick", [False, True])
@pytest.mark.parametrize("d", GEMM_EDGE_WIDTHS)
@pytest.mark.parametrize("m", GEMM_EDGE_ROWS)
def test_vit_out_mlp_kernel_tile_edges(cuda_device, m, d, quick):
    _check_out_mlp(cuda_device, m, d, quick)


def test_vit_block_kernels_are_deterministic(cuda_device):
    """Two launches of K4 and of K6 (both GELUs) on the same inputs give
    bit-equal outputs, at ViT-L/14 width with a partial last row tile: each
    output element is summed by one warpgroup in a fixed order."""
    from situation_recognition_tpu_torch.ops import vit as tv
    from situation_recognition_tpu_torch.ops import vit_kernel as vk

    m, d = 2 * 257, 1024
    w = tv.BlockWeights(*(t.to(cuda_device) for t in vk.kernel_weights(
        _vit_weights(d, 4 * d, 3))))
    g = torch.Generator().manual_seed(3)
    x, ctx = (torch.randn(m, d, generator=g).to(torch.bfloat16)
              .to(cuda_device) for _ in range(2))
    first = vk.vit_qkv_forward(x, w, 1e-6)
    second = vk.vit_qkv_forward(x, w, 1e-6)
    for name, a, b in zip("qkv", first, second):
        assert torch.equal(a, b), name
    for quick in (False, True):
        first = vk.vit_out_mlp_forward(x, ctx, w, 1e-6, quick)
        second = vk.vit_out_mlp_forward(x, ctx, w, 1e-6, quick)
        assert torch.equal(first, second), quick


def test_vit_block_kernels_refuse_misaligned_operands(cuda_device):
    """An operand that TMA cannot read (a view one element into a buffer,
    so not 16-byte aligned; a transposed, non-contiguous one) is refused
    with ValueError before any launch."""
    from situation_recognition_tpu_torch.ops import vit as tv
    from situation_recognition_tpu_torch.ops import vit_kernel as vk

    m, d = 64, 128
    w = tv.BlockWeights(*(t.to(cuda_device) for t in vk.kernel_weights(
        _vit_weights(d, 4 * d, 4))))
    buf = torch.zeros(m * d + 8, dtype=torch.bfloat16, device=cuda_device)
    ok = buf[:m * d].view(m, d)
    shifted = buf[1:1 + m * d].view(m, d)
    strided = torch.zeros(d, m, dtype=torch.bfloat16, device=cuda_device).t()
    counts = (vk.vit_qkv_forward.launches, vk.vit_out_mlp_forward.launches)
    for bad in (shifted, strided):
        with pytest.raises(ValueError, match="16-byte aligned"):
            vk.vit_qkv_forward(bad, w, 1e-6)
        with pytest.raises(ValueError, match="16-byte aligned"):
            vk.vit_out_mlp_forward(ok, bad, w, 1e-6, False)
    wbuf = torch.zeros(3 * d * d + 8, dtype=torch.bfloat16, device=cuda_device)
    bad_w = w._replace(in_w=wbuf[1:1 + 3 * d * d].view(3 * d, d))
    with pytest.raises(ValueError, match="16-byte aligned"):
        vk.vit_qkv_forward(ok, bad_w, 1e-6)
    torch.cuda.synchronize()
    assert (vk.vit_qkv_forward.launches,
            vk.vit_out_mlp_forward.launches) == counts


def test_vit_kernels_reject_unsupported_shapes(cuda_device):
    from situation_recognition_tpu_torch.ops import vit_kernel as vk

    q = torch.zeros(2 * 50, 96, dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(ValueError, match="multiple of 64"):
        vk.vit_attention_stream_forward(q, q, q, 3, True, 50, 50)
    q = torch.zeros(2 * 64, 128, dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(ValueError, match="heads of width 64"):
        vk.vit_attention_stream_forward(q, q, q, 4, True, 64, 64)
    q = torch.zeros(577, 64, dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(ValueError, match="whole examples"):
        vk.vit_attention_stream_forward(q, q, q, 1, True, 100, 50)
    x = torch.zeros(4, 128, dtype=torch.float32, device=cuda_device)
    w = vk.kernel_weights(_vit_weights(128, 512, 0))
    w = type(w)(*(t.to(cuda_device) for t in w))
    with pytest.raises(ValueError, match="bfloat16"):
        vk.vit_qkv_forward(x, w, 1e-6)


# K8 vs its twin: the same bf16 casts of f32 values summed in other
# orders; a last-bit flip of a bf16 e or ds element feeds the sums (the
# bound of K3, the other backward kernel)
BWD_MAX_REL = 2 ** -5
BWD_MEAN_REL = 2 ** -10


@pytest.mark.parametrize("b,n,stride,heads", [
    (2, 257, 257, 16), (2, 257, 264, 16), (3, 50, 56, 2), (2, 13, 16, 1),
    (1, 577, 577, 2)])
def test_vit_attention_backward_kernel_matches_twin(cuda_device, b, n,
                                                    stride, heads):
    """K8 at the ViT-L/14 head shape (16 heads, 257 tokens), with pad rows
    (stride 264), small and ragged tiles, and many key tiles."""
    from situation_recognition_tpu_torch.ops import vit as tv
    from situation_recognition_tpu_torch.ops import vit_kernel as vk

    g = torch.Generator().manual_seed(b * n + stride)
    d = 64 * heads
    q, k, v, do = (torch.randn(b * stride, d, generator=g).to(torch.bfloat16)
                   .to(cuda_device) for _ in range(4))
    o = vk.vit_attention_stream_forward(q, k, v, heads, True, stride, n)
    want = tv.attn_bwd_reference(q, k, v, o, do, heads, 0.125, stride, n)
    before = vk.vit_attention_backward.launches
    got = vk.vit_attention_backward(q, k, v, o, do, heads, stride, n)
    torch.cuda.synchronize()
    assert vk.vit_attention_backward.launches == before + 1
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        scale = w.float().abs().max().item()
        diff = (a.float() - w.float()).abs()
        assert diff.max().item() <= BWD_MAX_REL * scale, (name, diff.max())
        assert diff.mean().item() <= BWD_MEAN_REL * scale, (name, diff.mean())
        assert (a.reshape(b, stride, d)[:, n:] == 0).all(), name


@pytest.mark.parametrize("n", [1, 63, 64, 65, 128])
@pytest.mark.parametrize("folded", [True, False])
def test_vit_attention_backward_tile_boundaries(cuda_device, n, folded):
    """K8 at the tile boundaries (64-row tiles, 16-row warps), with pad
    rows, on the context of either forward flavour.  Errors are measured
    against the largest element of the three gradients: at N = 1 the one
    key's softmax is 1, so dq and dk are zero in exact arithmetic and both
    sides hold only rounding noise (dv is do there)."""
    from situation_recognition_tpu_torch.ops import vit as tv
    from situation_recognition_tpu_torch.ops import vit_kernel as vk

    b, heads, stride = 2, 2, n + 5
    g = torch.Generator().manual_seed(31 * n + folded)
    d = 64 * heads
    q, k, v, do = (torch.randn(b * stride, d, generator=g).to(torch.bfloat16)
                   .to(cuda_device) for _ in range(4))
    o = vk.vit_attention_stream_forward(q, k, v, heads, folded, stride, n)
    want = tv.attn_bwd_reference(q, k, v, o, do, heads, 0.125, stride, n)
    got = vk.vit_attention_backward(q, k, v, o, do, heads, stride, n)
    torch.cuda.synchronize()
    scale = max(w.float().abs().max().item() for w in want)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        diff = (a.float() - w.float()).abs()
        assert diff.max().item() <= BWD_MAX_REL * scale, (name, diff.max())
        assert diff.mean().item() <= BWD_MEAN_REL * scale, (name, diff.mean())
        assert (a.reshape(b, stride, d)[:, n:] == 0).all(), name


def test_vit_attention_kernels_are_deterministic(cuda_device):
    """Two launches on the same inputs give bit-equal outputs, forward (both
    flavours) and backward, at the ViT-L/14 head shape (16 heads, 257
    tokens): no atomics, a fixed order of sums."""
    from situation_recognition_tpu_torch.ops import vit_kernel as vk

    b, n, heads = 2, 257, 16
    d = 64 * heads
    g = torch.Generator().manual_seed(5)
    q, k, v, do = (torch.randn(b * n, d, generator=g).to(torch.bfloat16)
                   .to(cuda_device) for _ in range(4))
    for folded in (True, False):
        first = vk.vit_attention_stream_forward(q, k, v, heads, folded, n, n)
        second = vk.vit_attention_stream_forward(q, k, v, heads, folded, n, n)
        assert torch.equal(first, second), folded
    o = first
    first = vk.vit_attention_backward(q, k, v, o, do, heads, n, n)
    second = vk.vit_attention_backward(q, k, v, o, do, heads, n, n)
    for name, a, w in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, w), name


@pytest.mark.parametrize("folded", [True, False])
def test_diff_attention_on_the_card_matches_autograd(cuda_device, folded):
    """``DiffAttention`` (K7 forward, K8 backward) against autograd over the
    plain softmax attention at bf16, at ``tests/test_vit_pallas.py``'s
    bounds for the JAX pair against XLA's AD: the context within 0.03 and
    the gradients within 0.05 of their largest elements."""
    from situation_recognition_tpu_torch.ops import vit as tv
    from situation_recognition_tpu_torch.ops import vit_kernel as vk
    from situation_recognition_tpu_torch.ops.vit_train import DiffAttention

    b, n, heads = 3, 257, 4
    d = 64 * heads
    g = torch.Generator().manual_seed(11)
    base = [torch.randn(b * n, d, generator=g).to(torch.bfloat16)
            .to(cuda_device) for _ in range(3)]
    kernel = [t.clone().requires_grad_() for t in base]
    plain = [t.clone().requires_grad_() for t in base]
    counts = (vk.vit_attention_stream_forward.launches,
              vk.vit_attention_backward.launches)
    o_k = DiffAttention.apply(*kernel, heads, folded, n, n)
    (o_k.float() ** 2).sum().backward()
    o_p = tv.attn_core_reference(*plain, heads, 0.125, False, n, n)
    (o_p.float() ** 2).sum().backward()
    torch.cuda.synchronize()
    assert (vk.vit_attention_stream_forward.launches - counts[0],
            vk.vit_attention_backward.launches - counts[1]) == (1, 1)

    def rel(a, w):
        return ((a.float() - w.float()).abs().max()
                / w.float().abs().max()).item()

    assert rel(o_k, o_p) <= 0.03
    for name, a, w in zip("qkv", kernel, plain):
        assert rel(a.grad, w.grad) <= 0.05, name


def test_vit_module_kernel_paths_on_the_card(cuda_device, monkeypatch):
    """Both kernel paths of a ViT (stream: K4, K7, K6; per block: K4, K5,
    K6) launch their kernels and agree with the plain path at bf16."""
    from situation_recognition_tpu_torch.models.vit import ViT
    from situation_recognition_tpu_torch.ops import vit_kernel as vk

    m = ViT(16, 128, 2, 2, image_size=64, dtype=torch.bfloat16)
    m.reset_parameters(torch.Generator().manual_seed(0))
    m.to(cuda_device)
    x = torch.rand(3, 64, 64, 3, generator=torch.Generator().manual_seed(1)
                   ).to(cuda_device)
    counts = lambda: (vk.vit_qkv_forward.launches,  # noqa: E731
                      vk.vit_attention_forward.launches,
                      vk.vit_attention_stream_forward.launches,
                      vk.vit_out_mlp_forward.launches)
    with torch.inference_mode():
        m.block_impl = "plain"
        want = m(x).float()
        m.block_impl = "kernel"
        for stream, delta in (("1", (2, 0, 2, 2)), ("0", (2, 2, 0, 2))):
            monkeypatch.setenv("SRTPU_VIT_STREAM", stream)
            before = counts()
            got = m(x).float()
            torch.cuda.synchronize()
            assert tuple(a - b for a, b in zip(counts(), before)) == delta
            # bf16 through two blocks by other roundings (plain: bf16
            # products and softmax input; kernels: f32 sums and residual)
            assert (got - want).abs().max().item() < 0.1


def test_vit_serving_on_the_card_uses_the_kernels(cuda_device, tmp_path):
    from situation_recognition_tpu_torch.data.encoder import ImsituEncoder
    from situation_recognition_tpu_torch.ops import vit_kernel as vk
    from situation_recognition_tpu_torch.serving import (
        SituationModel, export_inference, load_inference)

    enc = ImsituEncoder.synthetic_full(0)
    model = SituationModel(enc, backbone="vit_b16", hidden=768,
                           image_size=64, dtype=torch.bfloat16)
    g = torch.Generator().manual_seed(0)
    model.backbone.reset_parameters(g)
    model.head.reset_parameters(g)
    export_inference(model, str(tmp_path / "art"), batch_size=4)
    fn = load_inference(str(tmp_path / "art"))
    plain = load_inference(str(tmp_path / "art"), ggnn_impl="masked",
                           block_impl="plain")
    assert fn.model.backbone.resolved_impl(cuda_device) == "kernel"
    images = np.random.default_rng(0).integers(0, 256, (4, 256, 256, 3),
                                               dtype=np.uint8)
    before = vk.vit_qkv_forward.launches
    verb_logits, _, nouns = fn(images)
    torch.cuda.synchronize()
    assert vk.vit_qkv_forward.launches == before + 12
    assert torch.isfinite(verb_logits).all() and torch.isfinite(nouns).all()
    pv, _, _ = plain(images)
    assert (verb_logits - pv).abs().max().item() < 0.25
