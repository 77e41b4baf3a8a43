"""Card-only tests: the CUDA GGNN and ViT kernels against their plain
twins, the ViT's differentiable attention (K7 forward, K8 backward), and
the serving and training paths on the card, and the global-statistics
BatchNorm in a NCCL world of one.  Marked ``cuda``;
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
# candidate tiles), the resnet18/34 head (512), the ViT head (1024) and
# the ResNet-50/101/152 head (2048); one example of each (M = 6, M = 1)
# is single-image inference's noun and verb shape; ragged
# masks for r=6, and mask 0 (the verb branch: E = I) for r=1 and for some
# r=6 batches
FOLDED_EDGE_CASES = ([(b, 6, False) for b in (1, 10, 11, 21, 22, 43, 256)]
                     + [(b, 6, True) for b in (11, 43)]
                     + [(m, 1, True) for m in (1, 63, 64, 65, 127, 129,
                                               256)])


@pytest.mark.parametrize("d", (64, 192, 512, 1024, 2048))
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


@pytest.mark.parametrize("d", (64, 192, 512, 1024, 2048))
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


# the head widths of the attention kernels' forms: 64 and 128 (resident),
# 192 (chunked, 64-column groups), 256 and 512 (chunked, 128-column groups
# and 64-column reduction chunks)
HEAD_WIDTHS = (64, 128, 192, 256, 512)
WIDE_HEAD_WIDTHS = HEAD_WIDTHS[1:]


@pytest.mark.parametrize("b,n,stride,heads,dh,folded", [
    (3, 257, 264, 2, 64, True), (3, 257, 257, 2, 64, False),
    (2, 50, 56, 1, 64, True), (2, 17, 17, 3, 64, False),
    (2, 129, 136, 16, 64, False),
    # ViT-L/14 at 336² and a longer sequence: many key tiles
    (2, 577, 577, 2, 64, True), (2, 577, 584, 1, 64, False),
    (1, 1025, 1025, 1, 64, True),
    # the tile boundaries of the 64-query tiles, 64-key tiles and 16-row
    # warps, through K5 (stride N) and K7 with pad rows, both flavours
    *[(2, n, n + pad, 2, 64, folded) for n in (1, 63, 64, 65, 128)
      for folded, pad in ((True, 0), (False, 7))],
    # the wider heads: ViT-L/14's 257 tokens in 1024 columns (8 heads of
    # 128, 4 of 256, 2 of 512) with and without pad rows, and 192 in 3
    # heads; 577 tokens at 128; the tile boundaries at each width
    *[(2, 257, 257 + pad, 1024 // dh, dh, folded)
      for dh in (128, 256, 512) for folded, pad in ((True, 7), (False, 0))],
    (2, 257, 264, 3, 192, True), (2, 257, 257, 3, 192, False),
    (2, 577, 577, 2, 128, True), (2, 577, 584, 2, 128, False),
    *[(2, n, n + pad, 2, dh, folded) for dh in WIDE_HEAD_WIDTHS
      for n in (1, 63, 64, 65, 128)
      for folded, pad in ((True, 0), (False, 7))]])
def test_vit_attention_kernel_matches_twin(cuda_device, b, n, stride, heads,
                                           dh, folded):
    from situation_recognition_tpu_torch.ops import vit as tv
    from situation_recognition_tpu_torch.ops import vit_kernel as vk

    g = torch.Generator().manual_seed(b * n + heads + dh)
    d = dh * heads
    q, k, v = (torch.randn(b * stride, d, generator=g).to(torch.bfloat16)
               .to(cuda_device) for _ in range(3))
    want = tv.attn_core_reference(q, k, v, heads, dh ** -0.5, folded, stride,
                                  n)
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
    rule = "heads whose width is a multiple of 64"
    q = torch.zeros(2 * 64, 128, dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(ValueError, match=rule):
        vk.vit_attention_stream_forward(q, q, q, 4, True, 64, 64)
    q = torch.zeros(2 * 64, 192, dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(ValueError, match=rule):      # heads of 96
        vk.vit_attention_stream_forward(q, q, q, 2, True, 64, 64)
    with pytest.raises(ValueError, match=rule):
        vk.vit_attention_backward(q, q, q, q, q, 2, 64, 64)
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


@pytest.mark.parametrize("b,n,stride,heads,dh", [
    (2, 257, 257, 16, 64), (2, 257, 264, 16, 64), (3, 50, 56, 2, 64),
    (2, 13, 16, 1, 64), (1, 577, 577, 2, 64),
    # ViT-L/14's 1024 columns in 8 heads of 128, 4 of 256 and 2 of 512,
    # with and without pad rows; 192 in 3 heads; 577 tokens at 128
    *[(2, 257, stride, 1024 // dh, dh) for dh in (128, 256, 512)
      for stride in (257, 264)],
    (2, 257, 264, 3, 192), (3, 50, 56, 2, 192), (1, 577, 577, 2, 128)])
def test_vit_attention_backward_kernel_matches_twin(cuda_device, b, n,
                                                    stride, heads, dh):
    """K8 at the ViT-L/14 head shape (16 heads, 257 tokens) and its wider
    splits, with pad rows (stride 264), small and ragged tiles, and many
    key tiles."""
    from situation_recognition_tpu_torch.ops import vit as tv
    from situation_recognition_tpu_torch.ops import vit_kernel as vk

    g = torch.Generator().manual_seed(b * n + stride + dh)
    d = dh * heads
    q, k, v, do = (torch.randn(b * stride, d, generator=g).to(torch.bfloat16)
                   .to(cuda_device) for _ in range(4))
    o = vk.vit_attention_stream_forward(q, k, v, heads, True, stride, n)
    want = tv.attn_bwd_reference(q, k, v, o, do, heads, dh ** -0.5, stride,
                                 n)
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


@pytest.mark.parametrize("dh", HEAD_WIDTHS)
@pytest.mark.parametrize("n", [1, 63, 64, 65, 128])
@pytest.mark.parametrize("folded", [True, False])
def test_vit_attention_backward_tile_boundaries(cuda_device, n, folded, dh):
    """K8 at the tile boundaries (64-row tiles, 16-row warps), with pad
    rows, on the context of either forward flavour, at each head width.
    Errors are measured against the largest element of the three
    gradients: at N = 1 the one key's softmax is 1, so dq and dk are zero
    in exact arithmetic and both sides hold only rounding noise (dv is do
    there)."""
    from situation_recognition_tpu_torch.ops import vit as tv
    from situation_recognition_tpu_torch.ops import vit_kernel as vk

    b, heads, stride = 2, 2, n + 5
    g = torch.Generator().manual_seed(31 * n + folded + dh)
    d = dh * heads
    q, k, v, do = (torch.randn(b * stride, d, generator=g).to(torch.bfloat16)
                   .to(cuda_device) for _ in range(4))
    o = vk.vit_attention_stream_forward(q, k, v, heads, folded, stride, n)
    want = tv.attn_bwd_reference(q, k, v, o, do, heads, dh ** -0.5, stride,
                                 n)
    got = vk.vit_attention_backward(q, k, v, o, do, heads, stride, n)
    torch.cuda.synchronize()
    scale = max(w.float().abs().max().item() for w in want)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        diff = (a.float() - w.float()).abs()
        assert diff.max().item() <= BWD_MAX_REL * scale, (name, diff.max())
        assert diff.mean().item() <= BWD_MEAN_REL * scale, (name, diff.mean())
        assert (a.reshape(b, stride, d)[:, n:] == 0).all(), name


@pytest.mark.parametrize("heads", [16, 8, 2])
def test_vit_attention_kernels_are_deterministic(cuda_device, heads):
    """Two launches on the same inputs give bit-equal outputs, forward (both
    flavours) and backward, at the ViT-L/14 width (1024 columns, 257
    tokens) in heads of 64, 128 and 512: no atomics, a fixed order of
    sums."""
    from situation_recognition_tpu_torch.ops import vit_kernel as vk

    b, n = 2, 257
    d = 1024
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


# ---------------------------------------------- checkpoints and the uploader


def _mini_trainer(device, dtype, **kw):
    from situation_recognition_tpu_torch.data.encoder import ImsituEncoder
    from situation_recognition_tpu_torch.train import Trainer, TrainerConfig

    cfg = dict(hidden=64, batch_size=8, backbone="mini", compute_dtype=dtype)
    cfg.update(kw)
    return Trainer(ImsituEncoder.synthetic_full(0), TrainerConfig(**cfg),
                   device=device)


def _host_batches(enc, sizes, seed):
    rng = np.random.default_rng(seed)
    out = []
    for n in sizes:
        verbs = rng.integers(0, enc.get_num_verbs(), n)
        out.append({"images": rng.integers(0, 256, (n, 256, 256, 3),
                                           dtype=np.uint8),
                    "flip": rng.random(n) < 0.5,
                    "verbs": verbs.astype(np.int32),
                    "labels": rng.integers(0, enc.get_num_labels(),
                                           (n, 3, enc.max_role_count)
                                           ).astype(np.int32)})
    return out


def _assert_tree_bit_equal(a, b, path=""):
    if torch.is_tensor(a):
        assert a.dtype == b.dtype and torch.equal(a.cpu(), b.cpu()), path
    elif isinstance(a, dict):
        assert list(a) == list(b), path
        for k in a:
            _assert_tree_bit_equal(a[k], b[k], f"{path}.{k}")
    else:
        assert a == b, path


def test_reference_checkpoint_through_a_bf16_frozen_trainer_is_bit_equal(
        cuda_device, tmp_path):
    """A reference-layout checkpoint (f32, from a CPU trainer after a
    step) loaded into a bf16 trainer on the card, whose convolutions are
    cast in place, saves back bit for bit: the f32 sources are kept."""
    from situation_recognition_tpu_torch.utils.checkpoint import (
        load_checkpoint, save_checkpoint)

    src = _mini_trainer("cpu", torch.float32)
    batch = _host_batches(src.encoder, (8,), 0)
    src.train_epoch(batch, 0)
    path = str(tmp_path / "ref")
    save_checkpoint(path, {"epoch": 1, **src.model_state_dict()})
    card = _mini_trainer(cuda_device, torch.bfloat16)
    conv = card.backbone.conv1.weight
    assert conv.dtype == torch.bfloat16 and conv.is_cuda
    ck = load_checkpoint(path)
    card.load_model_state(ck)
    save_checkpoint(str(tmp_path / "again"),
                    {"epoch": 1, **card.model_state_dict()})
    _assert_tree_bit_equal(load_checkpoint(str(tmp_path / "again")), ck)
    # and after a step on the card the frozen convolutions still save f32
    card.train_epoch(_host_batches(card.encoder, (8,), 1), 1)
    msd = card.model_state_dict()["model_state_dict"]
    assert torch.equal(msd["convnet_verbs.model.conv1.weight"],
                       ck["model_state_dict"][
                           "convnet_verbs.model.conv1.weight"])


@pytest.mark.parametrize("train_backbone", [False, True])
def test_cache_device_reserve_covers_a_fit_run(cuda_device, tmp_path,
                                               capsys, train_backbone):
    """``--cache_device``'s reserve, measured by its probe, covers the
    device memory a ``fit`` of the same configuration takes: an epoch with
    an asynchronous snapshot after every step, then its dev eval."""
    from situation_recognition_tpu_torch import cli
    from situation_recognition_tpu_torch.data.encoder import ImsituEncoder
    from situation_recognition_tpu_torch.train import Trainer, TrainerConfig

    enc = ImsituEncoder.synthetic_full(0)
    cfg = TrainerConfig(hidden=64, batch_size=32, backbone="mini",
                        compute_dtype=torch.bfloat16, epochs=1,
                        train_backbone=train_backbone)
    reserve = cli._working_reserve(enc, cfg, cuda_device, 256, train=True)
    assert reserve > 0
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_reserved()
    torch.cuda.reset_peak_memory_stats()
    tr = Trainer(enc, cfg, device=cuda_device)
    tr.fit(_host_batches(enc, (32, 32, 32, 20), 4),
           _host_batches(enc, (32, 32), 5), "sr", folder=str(tmp_path),
           plot=False, save_every_steps=1, async_save=True)
    torch.cuda.synchronize()
    took = torch.cuda.max_memory_reserved() - base
    capsys.readouterr()
    assert took <= reserve, (took, reserve)


@pytest.mark.parametrize("train_backbone", [False, True])
def test_cache_device_reserve_covers_an_accumulating_fit_run(cuda_device,
                                                             tmp_path,
                                                             capsys,
                                                             train_backbone):
    """With ``grad_accum`` 2 the probe takes groups of two microbatches at
    the microbatch (the CLI's ``batch_size``), and its reserve covers a
    ``fit`` of that configuration: 2 groups and a part group, a snapshot
    at each group's end, the dev eval.  (The mini backbone's gradients
    are small: chip_smoke.py's vit ft accum phase makes the same check
    for ViT-L/14 fine-tuned.)"""
    from situation_recognition_tpu_torch import cli
    from situation_recognition_tpu_torch.data.encoder import ImsituEncoder
    from situation_recognition_tpu_torch.train import Trainer, TrainerConfig

    enc = ImsituEncoder.synthetic_full(0)
    cfg = TrainerConfig(hidden=64, batch_size=32, backbone="mini",
                        compute_dtype=torch.bfloat16, epochs=1, grad_accum=2,
                        train_backbone=train_backbone)
    reserve = cli._working_reserve(enc, cfg, cuda_device, 256, train=True)
    assert reserve > 0
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_reserved()
    torch.cuda.reset_peak_memory_stats()
    tr = Trainer(enc, cfg, device=cuda_device)
    tr.fit(_host_batches(enc, (32, 32, 32, 32, 20), 6),
           _host_batches(enc, (32, 32), 7), "sr", folder=str(tmp_path),
           plot=False, save_every_steps=1, async_save=True)
    torch.cuda.synchronize()
    took = torch.cuda.max_memory_reserved() - base
    capsys.readouterr()
    assert tr.opt_steps == 3 and tr.step_count == 5
    assert took <= reserve, (took, reserve)


@pytest.mark.parametrize("depth", ["1", "3"])
def test_uploader_batches_equal_the_host_batches(cuda_device, monkeypatch,
                                                 depth):
    """Over 3 epochs (a short last batch each), every device batch the
    uploader hands over equals the padded host batch."""
    monkeypatch.setenv("SRTPU_UPLOAD_DEPTH", depth)
    tr = _mini_trainer(cuda_device, torch.bfloat16)
    for epoch in range(3):
        host = _host_batches(tr.encoder, (8, 8, 8, 5), 10 + epoch)
        seen = 0
        for (images, flip, verbs, labels, valid), batch, n in \
                tr._device_batches(host):
            arrays, hvalid, hn = tr._pad_batch(host[seen])
            assert n == hn and batch is host[seen]
            for got, want in ((images, arrays["images"]),
                              (flip, arrays["flip"]),
                              (verbs, arrays["verbs"]),
                              (labels, arrays["labels"]),
                              (valid, hvalid)):
                assert got.is_cuda
                np.testing.assert_array_equal(got.cpu().numpy(),
                                              want.astype(
                                                  got.cpu().numpy().dtype))
            # work queued on the step's stream reads the uploaded bytes
            assert int(images.sum()) == int(arrays["images"].sum())
            seen += 1
        assert seen == 4


def test_window_cache_gathers_equal_streamed_batches(cuda_device, tmp_path):
    """``--cache_device``: the device gather of a window-cached split
    equals the streamed (pinned upload) batches of the same split."""
    import json
    import os

    from situation_recognition_tpu_torch.data import dataset as tds
    from situation_recognition_tpu_torch.data.encoder import ImsituEncoder

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(repo, "imSitu", "overfitting.json")) as f:
        ann = json.load(f)
    rng = np.random.default_rng(3)
    tds.write_packed(str(tmp_path), ((n, rng.integers(
        0, 256, (256, 256, 3), dtype=np.uint8)) for n in ann))
    enc = ImsituEncoder(ann, verbose=False)
    from situation_recognition_tpu_torch.train import Trainer, TrainerConfig

    tr = Trainer(enc, TrainerConfig(hidden=64, batch_size=2,
                                    backbone="mini",
                                    compute_dtype=torch.bfloat16),
                 device=cuda_device)
    for train in (True, False):
        loaders = []
        for cached in (False, True):
            ds = tds.ImsituDataset(str(tmp_path), ann, enc, train=train)
            ds.enable_packed(str(tmp_path))
            if cached:
                ds.enable_window_cache()
            loaders.append(tds.ImsituLoader(ds, 2, shuffle=train, seed=5))
        for epoch in range(2):
            for ld in loaders:
                ld.set_epoch(epoch)
            pairs = zip(*(list(tr._device_batches(ld)) for ld in loaders))
            for (streamed, sb, sn), (cached, cb, cn) in pairs:
                assert "indices" in cb and "images" in sb and sn == cn
                for a, b in zip(streamed, cached):
                    assert torch.equal(a, b)


# ------------------------------------------------ accumulation, inference

# logits through the kernel against the plain masked path, bf16 (the
# served-logits bound of chip_smoke.py)
LOGIT_TOL = 0.1


@pytest.mark.parametrize("train_backbone", [False, True])
def test_grad_accum_group_equals_the_big_batch_on_the_card(cuda_device,
                                                           train_backbone):
    """``grad_accum`` 2 at microbatch 8 on batches A and B against one step
    at batch 16 on [A; B] (dropout 0, eval-mode BN), bf16 on the card: the
    mean gradient of every trainable tensor (the backbone's too when
    fine-tuned) as the clip receives it, within chip_smoke.py's
    ACCUM_GRAD_REL (whose reasoning stands beside it), after its
    ``_decisive_verb``; the clip's global norms agree, and K1 launches
    once per microbatch.  Every role of ``_host_batches`` is labelled, so
    the noun losses' denominators of A and B agree."""
    from chip_smoke import (ACCUM_GRAD_REL, _cat, _decisive_verb,
                            _group_grads)
    from situation_recognition_tpu_torch.data.encoder import ImsituEncoder

    enc = ImsituEncoder.synthetic_full(0)
    kw = dict(dropout_rate=0.0, frozen_backbone_bn="eval",
              train_backbone=train_backbone)
    acc = _mini_trainer(cuda_device, torch.bfloat16, grad_accum=2, **kw)
    big = _mini_trainer(cuda_device, torch.bfloat16, batch_size=16, **kw)
    a, b = _host_batches(enc, (8, 8), seed=21)
    _decisive_verb(acc, big)
    before = tk.folded_rows.launches
    got, got_norm = _group_grads(acc, [a, b])
    torch.cuda.synchronize()
    assert tk.folded_rows.launches - before == 2
    want, want_norm = _group_grads(big, [_cat(a, b)])
    assert acc.opt_steps == big.opt_steps == 1
    assert abs(got_norm - want_norm) <= ACCUM_GRAD_REL * want_norm
    for g, w in zip(got, want):
        rel = ((g - w).norm() / (w.norm() + 1e-30)).item()
        assert rel <= ACCUM_GRAD_REL, (tuple(w.shape), rel)


def test_infer_matches_the_plain_masked_path_on_the_card(cuda_device):
    """``infer_verb`` / ``infer_nouns`` of one window (K1 at M = 1 and
    M = 6) against the same trainer through the plain masked GGNN: f32
    logits on the card within LOGIT_TOL, one launch each."""
    tr = _mini_trainer(cuda_device, torch.bfloat16)
    assert tr.head.ggsnn.impl == "kernel"
    window = np.random.default_rng(3).integers(0, 256, (1, 256, 256, 3),
                                               dtype=np.uint8)
    before = tk.folded_rows.launches
    verb = tr.infer_verb(window)
    ids = verb.argmax(dim=1).cpu().numpy()
    nouns = tr.infer_nouns(window, ids)
    torch.cuda.synchronize()
    assert tk.folded_rows.launches - before == 2
    assert verb.is_cuda and verb.dtype == nouns.dtype == torch.float32
    assert verb.shape == (1, 504) and nouns.shape == (1, 6, 2001)
    tr.head.ggsnn.impl = "masked"
    for got, want in ((verb, tr.infer_verb(window)),
                      (nouns, tr.infer_nouns(window, ids))):
        assert torch.isfinite(got).all()
        assert (got - want).abs().max().item() <= LOGIT_TOL


# ------------------------------------------- custom ops and cuda programs


def test_custom_ops_match_their_twins(cuda_device):
    """Each kernel's torch.library op against its twin under the kernel
    tolerances (K1: KERNEL_ATOL; K4, K5/K7, K6: VIT_MAX_REL / VIT_MEAN_REL
    of the largest element), its launch counted under its wrapper, and
    ``opcheck`` (fake shapes and types against the real ones)."""
    from situation_recognition_tpu_torch.ops import vit as tv
    from situation_recognition_tpu_torch.ops import vit_kernel as vk

    params, h, mask = _case(24, 6, 256, seed=5)
    weights = [w.to(cuda_device) for w in tk.fold_gate_weights(params, 6.0)]
    h, mask = h.to(cuda_device), mask.to(cuda_device)
    ops = tk.kernel_weights(weights)
    before = tk.folded_rows.launches
    got = torch.ops.srtorch.ggnn_folded(h, mask, *ops, weights[3], 6, 4)
    torch.cuda.synchronize()
    assert tk.folded_rows.launches == before + 1
    want = tk.folded_reference(h, mask, weights, 6, 4)
    assert (got.float() - want.float()).abs().max().item() <= KERNEL_ATOL
    torch.library.opcheck(torch.ops.srtorch.ggnn_folded,
                          (h, mask, *ops, weights[3], 6, 4))

    d, n, b, heads = 128, 65, 3, 2
    w = tv.BlockWeights(*(t.to(cuda_device) for t in vk.kernel_weights(
        _vit_weights(d, 4 * d, 9))))
    x = torch.randn(b * n, d, generator=torch.Generator().manual_seed(9)).to(
        torch.bfloat16).to(cuda_device)
    counts = (vk.vit_qkv_forward.launches, vk.vit_attention_forward.launches,
              vk.vit_attention_stream_forward.launches,
              vk.vit_out_mlp_forward.launches)
    q, k, v = torch.ops.srtorch.vit_qkv(x, *w[:4], 1e-6)
    for g, t in zip((q, k, v), tv.qkv_reference(x, w, 1e-6)):
        _assert_close_rel(g, t)
    for stream in (False, True):
        ctx = torch.ops.srtorch.vit_attention(q, k, v, heads, True, n, n,
                                              stream)
        _assert_close_rel(ctx, tv.attn_core_reference(
            q, k, v, heads, 0.125, True, n, n))
    out = torch.ops.srtorch.vit_out_mlp(x, ctx, *w[4:], 1e-6, False)
    _assert_close_rel(out, tv.out_mlp_reference(x, ctx, w, 1e-6, False))
    torch.cuda.synchronize()
    assert (vk.vit_qkv_forward.launches, vk.vit_attention_forward.launches,
            vk.vit_attention_stream_forward.launches,
            vk.vit_out_mlp_forward.launches) == tuple(
                c + 1 for c in counts)
    torch.library.opcheck(torch.ops.srtorch.vit_qkv, (x, *w[:4], 1e-6))
    torch.library.opcheck(torch.ops.srtorch.vit_attention,
                          (q, k, v, heads, True, n, n, True))
    torch.library.opcheck(torch.ops.srtorch.vit_out_mlp,
                          (x, ctx, *w[4:], 1e-6, False))


def test_vit_attention_op_at_heads_of_128(cuda_device):
    """The attention op at ViT-L/14's 1024 columns in 8 heads of 128 on the
    card: K5 and K7 against the twin (VIT_MAX_REL / VIT_MEAN_REL), each
    launch counted under its wrapper, and ``opcheck`` (the fake's shape
    and type against the kernel's)."""
    from situation_recognition_tpu_torch.ops import vit as tv
    from situation_recognition_tpu_torch.ops import vit_kernel as vk

    d, heads, n, b = 1024, 8, 257, 2
    g = torch.Generator().manual_seed(17)
    q, k, v = (torch.randn(b * n, d, generator=g).to(torch.bfloat16)
               .to(cuda_device) for _ in range(3))
    counts = (vk.vit_attention_forward.launches,
              vk.vit_attention_stream_forward.launches)
    want = tv.attn_core_reference(q, k, v, heads, (d // heads) ** -0.5,
                                  True, n, n)
    for stream in (False, True):
        ctx = torch.ops.srtorch.vit_attention(q, k, v, heads, True, n, n,
                                              stream)
        _assert_close_rel(ctx, want)
    torch.cuda.synchronize()
    assert (vk.vit_attention_forward.launches,
            vk.vit_attention_stream_forward.launches) == tuple(
                c + 1 for c in counts)
    torch.library.opcheck(torch.ops.srtorch.vit_attention,
                          (q, k, v, heads, True, n, n, True))


@pytest.mark.parametrize("backbone,hidden,size", [("mini", 128, 224),
                                                  ("vit_b16", 768, 64)])
def test_cuda_program_matches_the_eager_model(cuda_device, tmp_path,
                                              backbone, hidden, size):
    """A ``cuda`` artifact's programs launch the kernels (K1 twice an
    argmax batch, once a gt batch; a ViT's K4, K7 and K6 once a block) on
    the current stream, and agree with the eager model rebuilt from the
    same artifact; the artifact refuses the CPU."""
    from situation_recognition_tpu_torch.data.encoder import ImsituEncoder
    from situation_recognition_tpu_torch.ops import vit_kernel as vk
    from situation_recognition_tpu_torch.serving import (
        SituationModel, export_inference, load_inference)

    enc = ImsituEncoder.synthetic_full(0)
    model = SituationModel(enc, backbone=backbone, hidden=hidden,
                           image_size=size, dtype=torch.bfloat16)
    g = torch.Generator().manual_seed(4)
    model.backbone.reset_parameters(g)
    model.head.reset_parameters(g)
    path = str(tmp_path / "art")
    export_inference(model.to(cuda_device), path, batch_size=4,
                     platform="cuda")
    fn = load_inference(path)
    eager = load_inference(path, rebuild=True)
    with pytest.raises(RuntimeError, match="exported for platforms"):
        load_inference(path, device="cpu")
    images = np.random.default_rng(1).integers(0, 256, (4, 256, 256, 3),
                                               dtype=np.uint8)
    depth = 12 if backbone == "vit_b16" else 0
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        before = (tk.folded_rows.launches, vk.vit_qkv_forward.launches,
                  vk.vit_attention_stream_forward.launches,
                  vk.vit_out_mlp_forward.launches)
        got = fn(images)
        gt = fn.gt(images, np.array([1, 2, 3, 4]))
        after = (tk.folded_rows.launches, vk.vit_qkv_forward.launches,
                 vk.vit_attention_stream_forward.launches,
                 vk.vit_out_mlp_forward.launches)
    side.synchronize()
    assert tuple(a - b for a, b in zip(after, before)) == (
        3, 2 * depth, 2 * depth, 2 * depth)
    want = eager(images)
    top2 = want[0].topk(2, dim=1).values
    decided = (top2[:, 0] - top2[:, 1]) > 0.1
    assert torch.equal(got[1][decided], want[1][decided])
    for a, b in ((got[0], want[0]), (got[2], want[2]),
                 (gt, eager.gt(images, np.array([1, 2, 3, 4])))):
        assert torch.isfinite(a).all()
        assert (a - b).abs().max().item() <= 0.1


# ------------------------------------------------ global-statistics BN


@pytest.fixture
def nccl_world(cuda_device):
    """A NCCL world of one process on the card (``init_distributed``)."""
    import socket

    from situation_recognition_tpu_torch.parallel import (
        destroy, init_distributed)

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    init_distributed(f"127.0.0.1:{port}", 1, 0, device="cuda:0")
    assert torch.distributed.get_backend() == "nccl"
    yield torch.distributed.group.WORLD
    destroy()


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2 ** -7)])
def test_global_batch_norm_card_form_matches_the_shared_form(nccl_world,
                                                             dtype, tol):
    """The card's global-statistics BN (``batch_norm_stats`` /
    ``batch_norm_elemt``, ``batch_norm_backward_reduce`` /
    ``batch_norm_backward_elemt``) against the plain-op form that the CPU
    tests run, both on the card over a NCCL world of one: y, the
    statistics, dx and the scale's and shift's gradients (f32 sums in
    another order: Welford against two passes; bf16 outputs within a
    rounding)."""
    from situation_recognition_tpu_torch.models import resnet

    dev = torch.device("cuda:0")
    g = torch.Generator().manual_seed(3)
    x = (torch.randn(16, 64, 14, 14, generator=g) * 2 + 0.5).to(
        dev, dtype).contiguous(memory_format=torch.channels_last)
    dy = torch.randn(x.shape, generator=g).to(dev, dtype).contiguous(
        memory_format=torch.channels_last)
    w = torch.linspace(0.5, 1.5, 64, device=dev)
    b = torch.linspace(-0.2, 0.2, 64, device=dev)
    out = {}
    for name, fwd, bwd in (
            ("card", resnet.forward_cuda, resnet.backward_cuda),
            ("shared", resnet.forward_shared, resnet.backward_shared)):
        y, mean, var = fwd(x, w, b, 1e-5, nccl_world)
        out[name] = (y.float(), mean, var) + tuple(
            t.float() for t in bwd(dy, x, w, mean, var, 1e-5, nccl_world,
                                   (True, True, True)))
    for a, want, what in zip(out["card"], out["shared"],
                             ("y", "mean", "var", "dx", "dw", "db")):
        scale = max(1.0, want.abs().max().item())
        torch.testing.assert_close(a, want, rtol=tol, atol=tol * scale,
                                   msg=what)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2 ** -7)])
def test_global_batch_norm_in_a_world_of_one_matches_native(nccl_world,
                                                            dtype, tol):
    """The global-statistics BN over a NCCL world of one against the
    layer's own ``native_batch_norm`` path: output, running statistics,
    and the gradients of x, the scale and the shift."""
    from situation_recognition_tpu_torch.models.resnet import BatchNorm

    dev = torch.device("cuda:0")
    g = torch.Generator().manual_seed(5)
    x0 = (torch.randn(8, 32, 10, 10, generator=g) * 1.5 + 0.3).to(
        dev, dtype).contiguous(memory_format=torch.channels_last)
    dy = torch.randn(x0.shape, generator=g).to(dev, dtype)
    out = {}
    for name, group in (("global", nccl_world), ("native", None)):
        bn = BatchNorm(32, eps=1e-5).to(dev).train()
        bn.weight.data = torch.linspace(0.5, 1.5, 32, device=dev)
        bn.bias.data = torch.linspace(-0.2, 0.2, 32, device=dev)
        bn.stats_group = group
        x = x0.clone().requires_grad_(True)
        y = bn(x)
        y.backward(dy)
        out[name] = (y.float(), bn.running_mean.clone(),
                     bn.running_var.clone(), x.grad.float(),
                     bn.weight.grad, bn.bias.grad)
    for a, b, what in zip(out["global"], out["native"],
                          ("y", "running mean", "running var", "dx", "dw",
                           "db")):
        scale = max(1.0, b.abs().max().item())
        torch.testing.assert_close(a, b, rtol=tol, atol=tol * scale,
                                   msg=what)


# ------------------------------------------ train-mode BN, ReLU and add

# (C, H·W) of ResNet-152's 155 BN layers at 224² (the 12 distinct ones),
# then the mini stack's widths (C = 2, 8) and widths that leave a lane of
# a vector idle (24) or take one channel a thread (12 in bf16), at a
# prime H·W
BN_SHAPES = [(64, 12544), (64, 3136), (256, 3136), (128, 3136), (128, 784),
             (512, 784), (256, 784), (256, 196), (1024, 196), (512, 196),
             (512, 49), (2048, 49), (2, 256), (8, 64), (12, 61), (24, 61)]
BN_MODES = {"relu": (False, True), "residual_relu": (True, True),
            "neither": (False, False)}
def _bn_case(device, dtype, n, c, hw, residual, seed,
             fmt=torch.channels_last):
    """(x, residual or None, two BatchNorms alike) on the card: x in
    ``fmt`` (channels-last, or plain NCHW) with per-channel means and
    scales, random f32 scale, shift and running statistics."""
    from situation_recognition_tpu_torch.models.resnet import BatchNorm

    g = torch.Generator().manual_seed(seed)
    h = int(hw ** 0.5)
    shape = (n, c, h, hw // h) if h * (hw // h) == hw else (n, c, hw, 1)
    x = (torch.randn(shape, generator=g) * (0.5 + torch.rand(
        1, c, 1, 1, generator=g) * 2) + torch.randn(1, c, 1, 1, generator=g))
    x = x.to(device, dtype).contiguous(memory_format=fmt)
    res = None
    if residual:
        res = torch.randn(shape, generator=g).to(device, dtype).contiguous(
            memory_format=fmt)
    state = {"weight": torch.rand(c, generator=g) + 0.5,
             "bias": torch.rand(c, generator=g) * 0.6 - 0.3,
             "running_mean": torch.randn(c, generator=g),
             "running_var": torch.rand(c, generator=g) + 0.5}
    bns = []
    for _ in range(2):
        bn = BatchNorm(c).to(device).train()
        bn.requires_grad_(False)
        with torch.no_grad():
            for k, v in state.items():
                getattr(bn, k).copy_(v)
        bns.append(bn)
    return x, res, bns


def _check_bn_pair(device, dtype, n, c, hw, mode, seed,
                   fmt=torch.channels_last):
    from chip_smoke import bn_excess
    from situation_recognition_tpu_torch.ops import batchnorm as bk

    residual, relu = BN_MODES[mode]
    x, res, (bn_k, bn_t) = _bn_case(device, dtype, n, c, hw, residual, seed,
                                    fmt)
    with torch.no_grad():
        pre, mean, invstd = torch.native_batch_norm(
            x, bn_t.weight, bn_t.bias, None, None, True, 0.0, bn_t.eps)
        want = bk.batchnorm_act_reference(x, bn_t, res, relu)
        # the apply kernel on torch's statistics: bit-equal
        same = bk._lone_apply(x, bn_k, torch.stack([mean, invstd]), res,
                              relu)
        before = bk.batchnorm_act.launches
        got = bk.batchnorm_act(x.clone(), bn_k, res, relu)
        torch.cuda.synchronize()
    assert bk.batchnorm_act.launches == before + 1
    assert got.dtype == dtype and got.is_contiguous(memory_format=fmt)
    assert torch.equal(same, want)
    # the pair's own statistics: f32 sums in another order
    with torch.no_grad():
        stats = bk._lone_stats(x, bn_k)
    std = (1 / invstd).max().item()
    torch.testing.assert_close(stats[0], mean, rtol=1e-5, atol=1e-5 * std)
    torch.testing.assert_close(stats[1], invstd, rtol=1e-5, atol=0)
    # so each rounding of the composition may land an ulp the other way:
    # the output's, and with a residual the normalised value's before the
    # add; beside the shift that statistics a rounding apart give
    err, excess = bn_excess(got, want, pre, dtype, res is not None)
    assert excess <= 0, (err, excess)
    # the running statistics advanced once by the pair (twice by the pair
    # and the lone statistics call above): against the twin's once
    assert int(bn_k.num_batches_tracked) == 2
    assert int(bn_t.num_batches_tracked) == 1
    return bn_k, bn_t, mean, std


@pytest.mark.parametrize("mode", list(BN_MODES))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("c,hw", BN_SHAPES)
def test_batchnorm_kernels_match_twin(cuda_device, c, hw, dtype, mode):
    """The pair against the twin (``native_batch_norm``, the running
    update, ``add``, ``relu``) at every layer shape of ResNet-152 at batch
    4 and the mini stack's widths: the apply kernel on torch's statistics
    bit-equal; the pair's statistics within f32 rounding, its output
    within an ulp, the running statistics and the batch count advanced."""
    _check_bn_pair(cuda_device, dtype, 4, c, hw, mode, seed=c + hw)


@pytest.mark.parametrize("mode", list(BN_MODES))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("c,hw", [(64, 3136), (256, 784), (2048, 49),
                                  (2, 256), (12, 61)])
def test_batchnorm_kernels_match_twin_on_plain_nchw(cuda_device, c, hw,
                                                    dtype, mode):
    """The planar layout (a plain contiguous NCHW x and residual) held as
    the channels-last one: the apply on torch's statistics bit-equal, the
    pair's statistics within f32 rounding, its output within an ulp."""
    _check_bn_pair(cuda_device, dtype, 4, c, hw, mode, seed=c + hw + 1,
                   fmt=torch.contiguous_format)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_batchnorm_kernels_at_the_last_stage_of_the_cell(cuda_device,
                                                         dtype):
    """1536 x 7 x 7 x 2048: ResNet-152's last bn3 at the benchmark's
    batch, residual and ReLU; the running statistics against the twin's."""
    bn_k, bn_t, mean, std = _check_bn_pair(cuda_device, dtype, 1536, 2048,
                                           49, "residual_relu", seed=9)
    from situation_recognition_tpu_torch.ops import batchnorm as bk

    # the twin's running statistics after a second update, as bn_k's
    x, _, _ = _bn_case(cuda_device, dtype, 1536, 2048, 49, False, seed=9)
    with torch.no_grad():
        bk.batch_norm_train(x, bn_t)
    torch.testing.assert_close(bn_k.running_mean, bn_t.running_mean,
                               rtol=1e-5, atol=1e-5 * std)
    torch.testing.assert_close(bn_k.running_var, bn_t.running_var,
                               rtol=1e-5, atol=0)


@pytest.mark.parametrize("c,hw,fmt", [
    (64, 12544, torch.channels_last), (2048, 49, torch.channels_last),
    (12, 61, torch.channels_last), (64, 3136, torch.contiguous_format)])
def test_batchnorm_kernels_are_deterministic(cuda_device, c, hw, fmt):
    """Two runs of the pair on one input: outputs, statistics and running
    statistics bit-equal (integer tickets, partials merged in index
    order)."""
    from situation_recognition_tpu_torch.ops import batchnorm as bk

    x, res, bns = _bn_case(cuda_device, torch.bfloat16, 64, c, hw, True, 3,
                           fmt)
    with torch.no_grad():
        outs = [bk.batchnorm_act(x.clone(), bn, res) for bn in bns]
        stats = [bk._lone_stats(x, bn) for bn in bns]
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1])
    assert torch.equal(stats[0], stats[1])
    for a, b in zip(bns[0].buffers(), bns[1].buffers()):
        assert torch.equal(a, b)


def test_batchnorm_kernels_refuse_other_layouts(cuda_device):
    from situation_recognition_tpu_torch.ops import batchnorm as bk

    x, res, (bn, _) = _bn_case(cuda_device, torch.bfloat16, 2, 16, 49,
                               True, 1)
    with pytest.raises(ValueError, match="channels-last"):
        bk.batchnorm_act(x[:, :, :, ::2], bn)
    with pytest.raises(ValueError, match="channels-last"):
        bk.batchnorm_act(x, bn, res.contiguous())
    with pytest.raises(ValueError, match="channels-last"):
        bk.batchnorm_act(x.contiguous(), bn, res)
    with pytest.raises(ValueError, match="channels-last"):
        bk.batchnorm_act(x.half(), bn)
    assert int(bn.num_batches_tracked) == 0


@pytest.mark.parametrize("case", ["frozen", "train_backbone", "eval"])
def test_batchnorm_launches_only_in_frozen_train_steps(cuda_device, case):
    """The pair runs once a BN layer of a frozen train step (the mini
    stack's 17 layers), never when the backbone is fine-tuned (autograd
    keeps torch's BN) or in eval mode."""
    from situation_recognition_tpu_torch.models.resnet import BatchNorm
    from situation_recognition_tpu_torch.ops import batchnorm as bk

    tr = _mini_trainer(cuda_device, torch.bfloat16,
                       train_backbone=case == "train_backbone")
    layers = sum(isinstance(m, BatchNorm) for m in tr.backbone.modules())
    assert layers == 17
    batches = _host_batches(tr.encoder, (8, 8), seed=4)
    before = bk.batchnorm_act.launches
    if case == "eval":
        tr.evaluate(batches)
    else:
        _, _, losses = tr.train_epoch(batches, 0)
        assert np.isfinite(losses).all()
    torch.cuda.synchronize()
    assert bk.batchnorm_act.launches - before == (
        2 * layers if case == "frozen" else 0)
    for m in tr.backbone.modules():
        if isinstance(m, BatchNorm):
            assert int(m.num_batches_tracked) == (0 if case == "eval" else 2)
            assert torch.isfinite(m.running_var).all()


def test_batchnorm_launches_none_with_a_stats_group(nccl_world):
    """A global-statistics world keeps its all-reduced BN: no launch."""
    from situation_recognition_tpu_torch.models import resnet
    from situation_recognition_tpu_torch.ops import batchnorm as bk

    dev = torch.device("cuda:0")
    model = resnet.mini(64).to(dev).train().to(
        memory_format=torch.channels_last)
    model.requires_grad_(False)
    resnet.set_stats_group(model, nccl_world)
    x = torch.rand(4, 32, 32, 3, device=dev)
    before = bk.batchnorm_act.launches
    with torch.no_grad():
        model(x)
    torch.cuda.synchronize()
    assert bk.batchnorm_act.launches == before
    resnet.set_stats_group(model, None)
    with torch.no_grad():
        model(x)
    torch.cuda.synchronize()
    assert bk.batchnorm_act.launches == before + 17


@pytest.mark.parametrize("layout", ["nhwc", "nchw"])
def test_batchnorm_frozen_step_on_plain_nchw_launches_the_pair(cuda_device,
                                                               layout,
                                                               monkeypatch):
    """A frozen train-mode ResNet on the card whose weights were never made
    channels-last: fed (B, H, W, 3) windows its convolutions give
    channels-last outputs, fed windows that are an NCHW tensor's view they
    give plain NCHW; either way each BN launches the pair, and the
    features agree with torch's BN (the module's path) on the same weights
    and input."""
    from situation_recognition_tpu_torch.models import resnet
    from situation_recognition_tpu_torch.ops import batchnorm as bk

    models = [resnet.mini(64).to(cuda_device).train() for _ in range(2)]
    models[1].load_state_dict(models[0].state_dict())
    for m in models:
        m.requires_grad_(False)
    images = torch.rand(4, 32, 32, 3, device=cuda_device)
    if layout == "nchw":
        images = images.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    before = bk.batchnorm_act.launches
    with torch.no_grad():
        got = models[0](images)
        torch.cuda.synchronize()
        assert bk.batchnorm_act.launches - before == 17
        monkeypatch.setattr(resnet, "fused", lambda bn, x: False)
        want = models[1](images)
    torch.cuda.synchronize()
    assert bk.batchnorm_act.launches - before == 17
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3)
    for a, b in zip(models[0].buffers(), models[1].buffers()):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
    counted = [int(m.num_batches_tracked) for m in models[0].modules()
               if isinstance(m, resnet.BatchNorm)]
    assert counted == [1] * 17


# ------------------------------------------------------------- the Swin

# Swin-L's four stages at 224: (windows an image, heads, C, window,
# shifted); the last stage's map is its one window and never shifts
SWIN_L_STAGES = [(64, 6, 192, 7, True), (16, 12, 384, 7, True),
                 (4, 24, 768, 7, True), (1, 48, 1536, 7, False)]


def _swin_case(images, nw, heads, c, window, masked, seed, device):
    """qkv, bias, mask and a cotangent of the window-attention core on the
    card: qkv N(0, 1) in bf16, a bias table's gather N(0, 1), the shifted
    map's mask (a map of √nW windows a side) or None."""
    from situation_recognition_tpu_torch.ops import swin

    g = torch.Generator().manual_seed(seed)
    n = window * window
    m = images * nw * n
    qkv = torch.randn(m, 3 * c, generator=g).to(torch.bfloat16)
    bias = torch.randn(heads, n, n, generator=g)
    dout = torch.randn(m, c, generator=g).to(torch.bfloat16)
    side = int(round(nw ** 0.5)) * window
    mask = (swin.shift_mask(side, side, window, window // 2).to(device)
            if masked else None)
    return qkv.to(device), bias.to(device), mask, dout.to(device)


# kernel vs twin on the same bf16 operands: the scores' f32 sums run in
# another order, which flips the last bit of a bf16 P, dS or output now
# and then (2^-7 of its size at most); dbias is an f32 sum of f32 dS over
# every window, equal to f32 rounding; a wrong fragment or tile moves
# elements by the order of the largest one
SWIN_MAX_REL = 2 ** -6
SWIN_MEAN_REL = 2 ** -10
SWIN_DBIAS_REL = 1e-4


def _check_swin(qkv, bias, mask, dout, heads, n):
    from situation_recognition_tpu_torch.ops import swin
    from situation_recognition_tpu_torch.ops import swin_kernel as sk

    scale = (qkv.shape[1] // 3 // heads) ** -0.5
    got = sk.wattn_forward(qkv, bias, mask, heads, n)
    dqkv, dbias = sk.wattn_backward(qkv, bias, mask, dout, heads, n)
    want = swin.wattn_reference(qkv, bias, mask, heads, n, scale)
    wdqkv, wdbias = swin.wattn_bwd_reference(qkv, bias, mask, dout, heads,
                                             n, scale)
    torch.cuda.synchronize()
    _assert_close_rel(got, want)
    for third, want_third in zip(dqkv.chunk(3, dim=1),
                                 wdqkv.chunk(3, dim=1)):
        _assert_close_rel(third, want_third)
    scale_b = wdbias.abs().max().item()
    err = (dbias - wdbias).abs().max().item()
    assert err <= SWIN_DBIAS_REL * scale_b, (err, scale_b)


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("stage", range(4))
def test_swin_attention_pair_matches_twins_at_swin_l_stages(cuda_device,
                                                            stage, masked):
    """The forward and backward kernels, dbias included, against the twins
    at each of Swin-L's stage shapes (3 images), with and without the
    shifted mask."""
    nw, heads, c, window, shifted = SWIN_L_STAGES[stage]
    if masked and not shifted:
        pytest.skip("the last stage never shifts")
    _check_swin(*_swin_case(3, nw, heads, c, window, masked, stage,
                            cuda_device), heads, window * window)


@pytest.mark.parametrize("nw,heads,window", [(16, 1, 4), (4, 2, 8),
                                              (1, 3, 1), (4, 2, 2)])
def test_swin_attention_pair_at_other_windows(cuda_device, nw, heads,
                                              window):
    """Windows of 16, 64, 1 and 4 tokens: one whole tile, and tiles of
    mostly pad rows."""
    masked = window > 1
    _check_swin(*_swin_case(2, nw, heads, heads * 32, window, masked, 7,
                            cuda_device), heads, window * window)


def test_swin_attention_pair_is_deterministic(cuda_device):
    """Two calls of each kernel on the same inputs are bit-equal: dbias is
    summed over fixed groups of windows, then over the groups in order."""
    from situation_recognition_tpu_torch.ops import swin_kernel as sk

    qkv, bias, mask, dout = _swin_case(8, 64, 6, 192, 7, True, 3,
                                       cuda_device)
    a = sk.wattn_forward(qkv, bias, mask, 6, 49)
    b = sk.wattn_forward(qkv, bias, mask, 6, 49)
    da, ba = sk.wattn_backward(qkv, bias, mask, dout, 6, 49)
    db, bb = sk.wattn_backward(qkv, bias, mask, dout, 6, 49)
    torch.cuda.synchronize()
    assert torch.equal(a, b) and torch.equal(da, db)
    assert torch.equal(ba, bb)


def test_swin_attention_pair_refuses_what_it_does_not_take(cuda_device):
    from situation_recognition_tpu_torch.ops import swin_kernel as sk

    qkv, bias, mask, dout = _swin_case(1, 4, 2, 64, 7, True, 1, cuda_device)
    with pytest.raises(ValueError, match="bf16 heads of 32"):
        sk.wattn_forward(qkv.float(), bias, mask, 2, 49)
    with pytest.raises(ValueError, match="bf16 heads of 32"):
        sk.wattn_forward(qkv, bias, mask, 1, 49)
    big = torch.zeros(81, 3 * 64, dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(ValueError, match="1..64 tokens"):
        sk.wattn_forward(big, torch.zeros(2, 81, 81, device=cuda_device),
                         None, 2, 81)
    with pytest.raises(ValueError, match="whole images"):
        sk.wattn_backward(qkv[:3 * 49], bias, mask, dout[:3 * 49], 2, 49)


def test_swin_module_kernel_path_matches_plain_on_the_card(cuda_device,
                                                          monkeypatch):
    """Swin-micro at bf16 on the card: the kernel path's features and
    gradients against the same model and weights with the core's twin
    (plain torch, under autograd) in the pair's place, and a
    differentiated call under remat launches the forward kernel twice and
    the backward once a block."""
    from situation_recognition_tpu_torch.models.swin import build_swin
    from situation_recognition_tpu_torch.ops import swin
    from situation_recognition_tpu_torch.ops import swin_kernel as sk

    model = build_swin("swin_micro", 64, torch.bfloat16, remat=True)
    model.reset_parameters(torch.Generator().manual_seed(0))
    model.to(cuda_device)
    x = torch.rand(4, 64, 64, 3, generator=torch.Generator().manual_seed(1))
    x = x.to(cuda_device)

    def run():
        model.zero_grad(set_to_none=True)
        y = model(x)
        y.float().square().sum().backward()
        return y.detach(), [p.grad for p in model.parameters()]

    before = (sk.wattn_forward.launches, sk.wattn_backward.launches)
    got, got_grads = run()
    torch.cuda.synchronize()
    assert (sk.wattn_forward.launches - before[0],
            sk.wattn_backward.launches - before[1]) == (12, 6)
    monkeypatch.setattr(
        sk, "window_attention", lambda qkv, bias, mask, heads, n:
        swin.wattn_reference(qkv, bias, mask, heads, n,
                             (qkv.shape[1] // 3 // heads) ** -0.5))
    want, want_grads = run()
    torch.cuda.synchronize()
    _assert_close_rel(got, want)
    for (name, _), a, b in zip(model.named_parameters(), got_grads,
                               want_grads):
        scale = b.abs().max().item()
        err = (a - b).abs().max().item()
        assert err <= 0.05 * scale, (name, err, scale)


def test_swin_l_fine_tuning_step_launches_the_pair(cuda_device):
    """``build_backbone("swin_l", 1536)`` through ``Trainer.train_epoch``
    with ``train_backbone`` and ``remat_backbone`` on the card: 48 forward
    and 24 backward launches a step, finite losses."""
    from situation_recognition_tpu_torch.data.encoder import ImsituEncoder
    from situation_recognition_tpu_torch.ops import swin_kernel as sk
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
    tr = Trainer(enc, TrainerConfig(hidden=1536, batch_size=n,
                                    backbone="swin_l", train_backbone=True,
                                    remat_backbone=True))
    before = (sk.wattn_forward.launches, sk.wattn_backward.launches)
    _, _, losses = tr.train_epoch([batch, batch], 0)
    torch.cuda.synchronize()
    assert np.isfinite(losses).all()
    assert (sk.wattn_forward.launches - before[0],
            sk.wattn_backward.launches - before[1]) == (96, 48)


@pytest.mark.parametrize("b,r,verb", [(43, 6, False), (256, 6, False),
                                      (256, 1, True), (1, 6, False)])
def test_folded_forward_at_the_swin_head_width(cuda_device, b, r, verb):
    """K1 and K2 at d = 1536, the Swin-L head's width, which no other
    configuration runs."""
    weights, h, mask = _card_case(b, r, 1536, b * r + 1536, cuda_device,
                                  verb)
    _check_folded(weights, h, mask, r)
