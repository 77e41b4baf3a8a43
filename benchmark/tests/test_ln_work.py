"""``ln_roofline.train``: the LayerNorm byte count on the reference's
backbones, held to sums worked by hand on the tiny fixture configurations
and on the two fine-tuning cells, and the reader's steps from the
backward's launches over a reduced trace."""

import json
import os

import pytest

import core
import work

PEAK = core.peaks("NVIDIA H100 80GB HBM3")
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures", "configs")


def _fixture(name):
    with open(os.path.join(FIXTURES, name + ".json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def reader():
    return core.metric_reader("ln_roofline.train")


class _Ctx:
    def __init__(self, kernels, cfg, batch=256):
        self.config = cfg
        self.counters = {"batch": batch}
        self.peaks = PEAK
        self.trace = None if kernels is None else {
            "kernels": kernels, "busy_s": 1.0, "window_s": 1.0,
            "categories": {}}


@pytest.mark.parametrize("batch", [1, 3])
def test_the_count_on_tiny_vit(reader, batch):
    # vit_tiny at 64²: 5 tokens of width 64, 2 blocks of 2 norms, f32;
    # each block norm read and written twice forward (remat), read twice
    # and written once backward: 4 x 4 bytes + 3 x 4 a value; the final
    # LayerNorm on the CLS rows is not the pair's
    nbytes, norms = reader.ln_work(_fixture("tiny-vit"), batch)
    assert norms == 4
    assert nbytes == batch * 4 * 5 * 64 * (2 * 8 + 12)


@pytest.mark.parametrize("batch", [1, 3])
def test_the_count_on_tiny_swin(reader, batch):
    # swin_micro at 64²: maps of 16², 8², 4² at widths 32, 64, 128, f32.
    # Block norms (2 a block, 2 blocks a stage, twice forward under remat):
    # 4 x 256 x 32 + 4 x 64 x 64 + 4 x 16 x 128 values an image; once
    # forward: the patch embedding's 256 x 32, the mergings' 64 x 128 and
    # 16 x 256, the final norm's 16 x 128 (f32 out, f32 anyway)
    nbytes, norms = reader.ln_work(_fixture("tiny-swin"), batch)
    blocks = 4 * 256 * 32 + 4 * 64 * 64 + 4 * 16 * 128
    once = 256 * 32 + 64 * 128 + 16 * 256 + 16 * 128
    assert norms == 12 + 4
    assert nbytes == batch * (blocks * (2 * 8 + 12) + once * (8 + 12))


def test_the_count_at_the_vitl14_cell(reader):
    # 48 block norms of 256 x 257 rows x 1024 bf16: 2 x 4 + 6 bytes a value
    nbytes, norms = reader.ln_work(core.config("vitl14-fcggnn"), 256)
    assert norms == 48
    assert nbytes == 48 * 256 * 257 * 1024 * (2 * 4 + 6)
    assert nbytes == pytest.approx(45.27e9, rel=1e-3)
    least, term = work.least_ms(0, nbytes, *PEAK)
    assert term == "bytes"
    assert least == pytest.approx(13.51, rel=1e-3)


def test_the_count_at_the_swinl_cell(reader):
    # an image at 224²: the blocks' norms 4 x 3136 x 192 + 4 x 784 x 384 +
    # 36 x 196 x 768 + 4 x 49 x 1536 (2 x 4 + 6 bytes a value); the patch
    # embedding's 3136 x 192 and the mergings' 784 x 768, 196 x 1536 and
    # 49 x 3072 (4 + 6); the final norm's 49 x 1536, bf16 in and f32 out
    # (2 + 4 forward, 2 + 4 + 2 backward)
    nbytes, norms = reader.ln_work(core.config("swinl-fcggnn"), 256)
    blocks = 4 * 3136 * 192 + 4 * 784 * 384 + 36 * 196 * 768 \
        + 4 * 49 * 1536
    once = 3136 * 192 + 784 * 768 + 196 * 1536 + 49 * 3072
    assert norms == 53
    assert nbytes == 256 * (blocks * 14 + once * 10 + 49 * 1536 * 14)
    assert nbytes == pytest.approx(37.96e9, rel=1e-3)
    assert work.least_ms(0, nbytes, *PEAK)[0] == pytest.approx(11.33,
                                                               rel=1e-3)


@pytest.mark.parametrize("launches,norms,want", [
    (192, 48, 4.0), (212, 53, 4.0), (24, 48, 0.5)])
def test_steps_are_backward_launches_over_a_forwards_norms(reader, launches,
                                                           norms, want):
    assert reader.steps(launches, norms) == want


@pytest.mark.parametrize("kernels", [
    None, {},
    {"void at::native::vectorized_elementwise_kernel<4>": [1.0, 100],
     "void at::native::(anonymous namespace)::layer_norm_kernel": [0.1, 9]}])
def test_none_without_the_pairs_kernels(reader, kernels):
    assert reader.read(_Ctx(kernels, core.config("vitl14-fcggnn"))) is None


def test_a_reduced_trace_reads_least_over_device_time_a_step(reader):
    # 4 traced steps of the ViT cell: 96 forward and 48 backward launches
    # a step, each backward with its dparam pass
    cfg = core.config("vitl14-fcggnn")
    kernels = {
        "void ln_rows_fwd_kernel<__nv_bfloat16, __nv_bfloat16, 4>(...)":
            [0.030, 384],
        "void ln_rows_bwd_kernel<__nv_bfloat16, __nv_bfloat16, 4>(...)":
            [0.040, 192],
        "ln_rows_dparam_kernel(float const*, float*, int, int)":
            [0.002, 192],
        "void at::native::vectorized_elementwise_kernel<4>": [1.0, 9]}
    least, _ = work.least_ms(0, reader.ln_work(cfg, 256)[0], *PEAK)
    want = 100.0 * least / ((0.030 + 0.040 + 0.002) / 4 * 1e3)
    assert reader.read(_Ctx(kernels, cfg)) == pytest.approx(want)
    assert 0 < want <= 100


def test_no_reading_in_a_cell_without_the_pair(reader):
    kernels = {"void ln_rows_bwd_kernel<float, float, 4>": [0.1, 10]}
    assert reader.read(_Ctx(kernels, core.config("r152-fcggnn"),
                            1536)) is None


@pytest.mark.parametrize("name", [
    "void ln_rows_fwd_kernel<__nv_bfloat16, __nv_bfloat16, 4>(__nv_bfloat16 "
    "const*, float const*, float const*, __nv_bfloat16*, float*, float*, "
    "int, int, int, float)",
    "void ln_rows_bwd_kernel<__nv_bfloat16, float, 3>(__nv_bfloat16 const*, "
    "float const*, float const*, float const*, float const*, "
    "__nv_bfloat16*, float*, int, int, int)",
    "ln_rows_dparam_kernel(float const*, float*, int, int)"])
def test_the_pairs_kernels_fall_under_other(name):
    import devtrace

    assert devtrace.category(name) == "other"
