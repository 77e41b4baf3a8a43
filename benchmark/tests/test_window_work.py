"""The Swin window-attention pair's counts of work, held to Swin-L's shapes
worked by hand, the Swin-L configuration's step FLOPs, and the pair's
kernel names in the device trace's categories."""

import pytest

import core
import devtrace
import window_work as ww
import work

PEAK = core.peaks("NVIDIA H100 80GB HBM3")


def test_a_stage_one_launch_at_batch_256():
    # 256 images x 64 windows x 6 heads x 49² x 32 = 7,552,892,928; the
    # qkv read, 256·64·49 rows x 3·192 bf16, and the context written, x
    # 192: 4 x 308,281,344 bytes; the bias, 6 x 49² f32, read once
    per, row, bias = 7_552_892_928, 308_281_344, 6 * 49 * 49 * 4
    assert ww.window_work(256, 64, 6, 49, 32, False, False) == (
        4 * per, 4 * row + bias)
    # shifted: the mask, 64 x 49² f32, read once
    assert ww.window_work(256, 64, 6, 49, 32, True, False) == (
        4 * per, 4 * row + bias + 64 * 49 * 49 * 4)
    # the backward: qkv and dO read, dqkv written (7 rows' worth); the
    # bias read and dbias written
    assert ww.window_work(256, 64, 6, 49, 32, False, True) == (
        10 * per, 7 * row + 2 * bias)
    least, term = work.least_ms(*ww.window_work(256, 64, 6, 49, 32, False,
                                                False), *PEAK)
    assert term == "bytes"
    assert least == pytest.approx(0.3681, rel=1e-3)


def test_the_last_stage_is_one_window_of_48_heads():
    per = 256 * 48 * 49 * 49 * 32
    row = 256 * 49 * 1536 * 2
    assert ww.window_work(256, 1, 48, 49, 32, False, True) == (
        10 * per, 7 * row + 2 * 48 * 49 * 49 * 4)


def test_swin_l_blocks_and_a_steps_launches():
    cfg = core.config("swinl-fcggnn")
    blocks = ww.blocks(cfg)
    assert len(blocks) == 24
    assert blocks[:4] == [(64, 6, 49, 32, False), (64, 6, 49, 32, True),
                          (16, 12, 49, 32, False), (16, 12, 49, 32, True)]
    assert sum(b[4] for b in blocks) == 1 + 1 + 9
    assert blocks[-2:] == [(1, 48, 49, 32, False)] * 2
    assert ww.launches_a_step(cfg, False) == 48
    assert ww.launches_a_step(cfg, True) == 24
    # every launch bound by bytes: a step's forward twice under remat
    fwd = ww.step_least_ms(cfg, 256, *PEAK, False)
    bwd = ww.step_least_ms(cfg, 256, *PEAK, True)
    assert fwd == pytest.approx(5.709, rel=1e-3)
    assert bwd == pytest.approx(4.996, rel=1e-3)


def test_a_swin_l_fine_tuning_step_counts_forward_and_backward():
    # 34.5 G multiply-adds an image forward at 224 (the published count,
    # with its 1.5 M-parameter classifier), the backward twice that: 207
    # GFLOP; the head at d = 1536 and the resize about 3.6 more
    cfg = core.config("swinl-fcggnn")
    assert work.step_flops(cfg, 2) == 421_346_893_824
    assert 205e9 < work.step_flops(cfg, 2) / 2 < 215e9


@pytest.mark.parametrize("name", [
    "(anonymous namespace)::swin_wattn_fwd_kernel(__nv_bfloat16 const*, "
    "float const*, float const*, __nv_bfloat16*, int, int, int, int, "
    "float)",
    "(anonymous namespace)::swin_wattn_bwd_kernel(__nv_bfloat16 const*, "
    "float const*, float const*, __nv_bfloat16 const*, __nv_bfloat16*, "
    "float*, int, int, int, int, float)",
    "(anonymous namespace)::swin_wattn_dbias_kernel(float const*, float*, "
    "int, int)"])
def test_the_pairs_kernels_fall_under_other(name):
    assert devtrace.category(name) == "other"
