"""The benchmark's counts of work, held to worked shapes."""

import pytest

import core
import work

PEAK = core.peaks("NVIDIA H100 80GB HBM3")


def test_the_h100_peaks():
    assert PEAK == (989e12, 3.35e12)


def test_k1_at_the_resnet_cells_noun_shape():
    # the gt-verb branch at 1536 rows x 6 roles, d = 2048, 4 steps; the
    # role graphs' edges add 2·edges·d a step (at most 36 a graph here)
    flops, nbytes = work.k1_work(9216, 2048, 4, 0)
    assert flops == pytest.approx(1.855e12, rel=1e-3)
    least, term = work.least_ms(flops, nbytes, *PEAK)
    assert term == "operations"
    assert least == pytest.approx(1.876, rel=1e-3)
    with_edges, _ = work.k1_work(9216, 2048, 4, 1536 * 36)
    assert with_edges - flops == 4 * 2 * 1536 * 36 * 2048


def test_k1_at_the_vit_cells_shape():
    least, _ = work.least_ms(*work.k1_work(1536, 1024, 4, 0), *PEAK)
    assert least == pytest.approx(0.078, rel=0.01)


def test_k7_and_k8_at_vit_l14_batch_256():
    fwd = work.least_ms(*work.attention_work(256, 257, 16, 64, False),
                        *PEAK)
    bwd = work.least_ms(*work.attention_work(256, 257, 16, 64, True),
                        *PEAK)
    assert fwd[1] == bwd[1] == "bytes"
    assert fwd[0] == pytest.approx(0.161, rel=0.01)
    assert bwd[0] == pytest.approx(0.322, rel=0.01)


def test_a_resnet152_step_counts_its_forward_once():
    # ResNet-152 at 224: 11.56 G multiply-adds an image forward (23.1
    # GFLOP), the frozen backbone no backward.  The head at d = 2048: 7
    # products of 2048² a node and GGNN step (58.7 MFLOP), 4 steps of the
    # verb branch's node and of both noun branches' 6 nodes (2.8 GFLOP),
    # twice that again for the backward of the verb and predicted-verb
    # branches (3.3 GFLOP), and the resize's 0.17 GFLOP
    cfg = core.config("r152-fcggnn")
    per_image = work.step_flops(cfg, 2) / 2
    assert 29.0e9 < per_image < 30.5e9


def test_a_vit_l14_fine_tuning_step_counts_forward_and_backward():
    # ~81 G multiply-adds an image forward at 257 tokens; the backward
    # twice the forward
    cfg = core.config("vitl14-fcggnn")
    per_image = work.step_flops(cfg, 2) / 2
    assert 470e9 < per_image < 530e9
