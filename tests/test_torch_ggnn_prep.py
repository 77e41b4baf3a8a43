"""What K1/K2 (``csrc/ggnn_folded.cu``) read besides h, prepared on the host
and tested here without a card: the weights in the layout of their GEMMs
(``kernel_weights``), the cache that builds them once per weight change
(``folded_operands``), and the tiles chosen for (M, d) (``tile_plan``)."""

import gc
import math

import numpy as np
import pytest
import torch

from situation_recognition_tpu_torch.models.fcggnn import GGNN
from situation_recognition_tpu_torch.ops import ggnn_kernel as tk
from situation_recognition_tpu_torch.ops.ggnn import GGNNParams


def _weights(d, seed=0):
    g = torch.Generator().manual_seed(seed)
    bound = 1.0 / d ** 0.5
    arrs = []
    for _ in range(7):
        arrs.append((torch.rand(d, d, generator=g) * 2 - 1) * bound)
        arrs.append((torch.rand(d, generator=g) * 2 - 1) * bound)
    return tk.fold_gate_weights(GGNNParams(*arrs), 6.0)


@pytest.mark.parametrize("d", [64, 192, 256])
def test_kernel_weights_permute_the_folded_weights(d):
    """Row 128 j + 64 g + i of w_zr (u_zr) is column g d + 64 j + i of wa
    (uzr), bit for bit; w_h and u_h are the transposes of wa's c third and
    of uh."""
    wa, uzr, uh, _ = weights = _weights(d)
    w_zr, u_zr, w_h, u_h = tk.kernel_weights(weights)
    assert w_zr.shape == u_zr.shape == (2 * d, d)
    for t in (w_zr, u_zr, w_h, u_h):
        assert t.is_contiguous() and t.dtype == torch.bfloat16
    for j in range(d // 64):
        for g in range(2):
            rows = slice(128 * j + 64 * g, 128 * j + 64 * g + 64)
            cols = slice(g * d + 64 * j, g * d + 64 * j + 64)
            assert torch.equal(w_zr[rows], wa[:, cols].t())
            assert torch.equal(u_zr[rows], uzr[:, cols].t())
    assert torch.equal(w_h, wa[:, 2 * d:].t())
    assert torch.equal(u_h, uh.t())


def test_folded_operands_are_built_once_per_weights():
    weights = _weights(64)
    first = tk.folded_operands(weights)
    assert tk.folded_operands(weights) is first
    assert tk.folded_operands(list(weights)) is first
    for got, want in zip(first, tk.kernel_weights(weights)):
        assert torch.equal(got, want)


def test_folded_operands_are_rebuilt_after_a_ggnn_weight_changes():
    """An in-place write to a GGNN weight gives ``GGNN.folded`` new
    tensors, and an in-place write to a folded tensor bumps its version:
    either way the prepared copy is rebuilt from the new values."""
    g = GGNN(64, dtype=torch.bfloat16, impl="kernel")
    g.reset_parameters(torch.Generator().manual_seed(0))
    first = tk.folded_operands(g.folded(6.0))
    with torch.no_grad():
        g.W_h.weight.add_(0.25)
    weights = g.folded(6.0)
    second = tk.folded_operands(weights)
    assert second is not first
    assert not torch.equal(second[2], first[2])
    for got, want in zip(second, tk.kernel_weights(
            tk.fold_gate_weights(g.params(), 6.0))):
        assert torch.equal(got, want)
    with torch.no_grad():
        weights[2].mul_(2.0)
    third = tk.folded_operands(weights)
    assert third is not second
    assert torch.equal(third[3], weights[2].t())


def test_folded_operands_of_weights_folded_in_inference_mode():
    """The serving paths fold under ``torch.inference_mode``, whose tensors
    keep no version counter: they are prepared once and kept by
    identity."""
    g = GGNN(64, dtype=torch.bfloat16, impl="kernel")
    g.reset_parameters(torch.Generator().manual_seed(2))
    with torch.inference_mode():
        weights = g.folded(1.0)
        first = tk.folded_operands(weights)
        assert tk.folded_operands(weights) is first
    assert tk.folded_operands(weights) is first
    for got, want in zip(first, tk.kernel_weights(weights)):
        assert torch.equal(got, want)


def test_folded_operands_entry_goes_with_its_weights():
    weights = _weights(64, seed=1)
    tk.folded_operands(weights)
    key = tuple(id(t) for t in weights[:3])
    assert key in tk._KERNEL_WEIGHTS
    del weights
    gc.collect()
    assert key not in tk._KERNEL_WEIGHTS


def _walk(m, n, bm, bn):
    """How many times the kernel's tile walk (tile t: rows (t % m_tiles) bm,
    columns (t // m_tiles) bn, for t < m_tiles * n / bn) covers each of the
    (m, n) outputs, the rows past m dropped."""
    m_tiles = math.ceil(m / bm)
    cover = np.zeros((m, n), dtype=np.int64)
    for t in range(m_tiles * (n // bn)):
        m0, n0 = (t % m_tiles) * bm, (t // m_tiles) * bn
        cover[m0:m0 + bm, n0:n0 + bn] += 1
    return cover


# the shapes of the paths: ResNet noun and verb, a ragged last batch, the
# ViT head's noun and verb, each with the plan the rule gives on 132 SMs
@pytest.mark.parametrize("m,d,plan", [
    (1536, 2048, (128, 128, 128, 256)),
    (256, 2048, (64, 128, 64, 64)),
    (42, 2048, (64, 128, 64, 64)),
    (1536, 1024, (128, 256, 128, 128)),
    (256, 1024, (64, 128, 64, 64)),
])
def test_tile_plan_of_the_paths_covers_each_output_once(m, d, plan):
    got = tk.tile_plan(m, d)
    assert tuple(got) == plan
    gate = _walk(m, 2 * d, got.gate_bm, got.gate_bn)
    cand = _walk(m, d, got.cand_bm, got.cand_bn)
    assert (gate == 1).all() and (cand == 1).all()
    # a gate tile holds z and r of the same 64 columns of h
    assert got.gate_bn % 128 == 0


def test_tile_plan_takes_every_width_the_kernels_take():
    for d in range(64, 2049, 64):
        for m in (1, 6, 42, 258):
            p = tk.tile_plan(m, d)
            assert p.gate_bm in (64, 128) and p.cand_bm in (64, 128)
            assert (2 * d) % p.gate_bn == 0 and d % p.cand_bn == 0


# the shapes of the paths (ResNet noun, verb, a ragged last batch, the ViT
# head's noun and verb) with the tile the rule gives on 132 SMs, and edges
@pytest.mark.parametrize("m,d,tile", [
    (1536, 2048, (128, 256)), (256, 2048, (64, 64)), (42, 2048, (64, 64)),
    (1536, 1024, (128, 128)), (256, 1024, (64, 64)), (6, 64, (64, 64)),
    (258, 192, None), (1, 128, None)])
def test_bwd_tile_plan_divides_fits_and_costs_least(m, d, tile):
    plan = tk.bwd_tile_plan(m, d)
    tiles = list(zip(plan[::2], plan[1::2]))
    if tile is not None:
        assert tiles == [tile] * 3
    for bm, bn in tiles:
        assert bm in (64, 128) and bn in (64, 128, 256) and d % bn == 0
        assert tk.gemm_smem(bm, bn) <= 232448
        cost = tk._rounds_cost(m, d, bm, bn, tk.H100_SMS)
        assert all(cost <= tk._rounds_cost(m, d, obm, obn, tk.H100_SMS)
                   for obm in (64, 128) for obn in (64, 128, 256)
                   if d % obn == 0)
        assert (_walk(m, d, bm, bn) == 1).all()
