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
