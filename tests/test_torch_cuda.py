"""Card-only tests: the CUDA GGNN kernel against its plain twin, and the
serving path on the card.  Marked ``cuda``; each test asks for the card
in the ``cuda_device`` fixture and skips with a reason where there is
none (run them on the card with ``python -m pytest tests/test_torch_cuda.py
-m cuda``)."""

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
                                        (130, 1, 192, True)])
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
    wt = tk.transpose_folded(weights)
    dh, da = tk.folded_bwd_rows(g, mask, res, wt, r, 4)
    want_dh, want_da = tk.folded_bwd_reference(g, mask, res, wt, r, 4)
    torch.cuda.synchronize()
    assert (tk.folded_rows_res.launches,
            tk.folded_bwd_rows.launches) == (before[0] + 1, before[1] + 1)
    for got, want in ((dh, want_dh), (da, want_da)):
        scale = want.float().abs().max().item()
        err = (got.float() - want.float()).abs().max().item()
        assert err <= BWD_REL_ATOL * scale, (err, scale)


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
