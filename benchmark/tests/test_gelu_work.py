"""``gelu_roofline.train``: the bias + GELU byte count on the reference's
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
    return core.metric_reader("gelu_roofline.train")


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
    # vit_tiny at 64²: 5 tokens, 2 blocks of hidden 256, f32; each GELU's
    # input read and output written twice forward (remat), read twice and
    # written once backward: 4 x 4 bytes + 3 x 4 a value
    nbytes, gelus = reader.gelu_work(_fixture("tiny-vit"), batch)
    assert gelus == 2
    assert nbytes == batch * 2 * 5 * 256 * (2 * 8 + 12)


@pytest.mark.parametrize("batch", [1, 3])
def test_the_count_on_tiny_swin(reader, batch):
    # swin_micro at 64²: maps of 16², 8², 4² at hidden 128, 256, 512 (4 x
    # the widths 32, 64, 128), 2 blocks a stage, f32
    nbytes, gelus = reader.gelu_work(_fixture("tiny-swin"), batch)
    assert gelus == 6
    per_image = 2 * (256 * 128 + 64 * 256 + 16 * 512)
    assert nbytes == batch * per_image * (2 * 8 + 12)


def test_the_count_at_the_vitl14_cell(reader):
    # 24 fc1 activations of 256 x 257 rows x 4096 bf16: 2 x 4 + 6 bytes
    nbytes, gelus = reader.gelu_work(core.config("vitl14-fcggnn"), 256)
    assert gelus == 24
    assert nbytes == 24 * 256 * 257 * 4096 * (2 * 4 + 6) == 90_546_634_752
    least, term = work.least_ms(0, nbytes, *PEAK)
    assert term == "bytes"
    assert least == pytest.approx(27.03, rel=1e-3)


def test_the_count_at_the_swinl_cell(reader):
    # an image at 224²: 2 blocks of 3136 x 768, 2 of 784 x 1536, 18 of
    # 196 x 3072 and 2 of 49 x 6144, 2 x 4 + 6 bytes a value
    nbytes, gelus = reader.gelu_work(core.config("swinl-fcggnn"), 256)
    assert gelus == 24
    per_image = 2 * 3136 * 768 + 2 * 784 * 1536 + 18 * 196 * 3072 \
        + 2 * 49 * 6144
    assert nbytes == 256 * per_image * 14 == 66_897_051_648
    assert work.least_ms(0, nbytes, *PEAK)[0] == pytest.approx(19.97,
                                                               rel=1e-3)


@pytest.mark.parametrize("launches,gelus,want", [
    (96, 24, 4.0), (24, 24, 1.0), (12, 24, 0.5)])
def test_steps_are_backward_launches_over_a_forwards_gelus(reader, launches,
                                                           gelus, want):
    assert reader.steps(launches, gelus) == want


@pytest.mark.parametrize("kernels", [
    None, {},
    {"void at::native::vectorized_elementwise_kernel<4>": [1.0, 100],
     "void at::native::GeluCUDAKernelImpl": [0.1, 9]}])
@pytest.mark.parametrize("cell", ["vitl14-fcggnn", "swinl-fcggnn"])
def test_none_without_the_pairs_kernels(reader, kernels, cell):
    assert reader.read(_Ctx(kernels, core.config(cell))) is None


@pytest.mark.parametrize("cell", ["vitl14-fcggnn", "swinl-fcggnn"])
def test_a_reduced_trace_reads_least_over_device_time_a_step(reader, cell):
    # 4 traced steps: 48 forward and 24 backward launches a step, each
    # backward with its dbias pass
    cfg = core.config(cell)
    kernels = {
        "void gelu_rows_fwd_kernel<false, 2>(uint4 const*, float const*, "
        "uint4*, int, int, int)": [0.060, 192],
        "void gelu_rows_bwd_kernel<false, 2>(uint4 const*, float const*, "
        "uint4 const*, uint4*, float*, int, int, int)": [0.050, 96],
        "gelu_rows_dbias_kernel(float const*, float*, int, int)":
            [0.002, 96],
        "void at::native::vectorized_elementwise_kernel<4>": [1.0, 9]}
    least, _ = work.least_ms(0, reader.gelu_work(cfg, 256)[0], *PEAK)
    want = 100.0 * least / ((0.060 + 0.050 + 0.002) / 4 * 1e3)
    assert reader.read(_Ctx(kernels, cfg)) == pytest.approx(want)
    assert 0 < want <= 100


def test_no_reading_in_a_cell_without_the_pair(reader):
    kernels = {"void gelu_rows_bwd_kernel<false, 3>": [0.1, 10]}
    assert reader.read(_Ctx(kernels, core.config("r152-fcggnn"),
                            1536)) is None


@pytest.mark.parametrize("name", [
    "void gelu_rows_fwd_kernel<true, 3>(uint4 const*, float const*, uint4*, "
    "int, int, int)",
    "void gelu_rows_bwd_kernel<false, 2>(uint4 const*, float const*, "
    "uint4 const*, uint4*, float*, int, int, int)",
    "gelu_rows_dbias_kernel(float const*, float*, int, int)"])
def test_the_pairs_kernels_fall_under_other(name):
    import devtrace

    assert devtrace.category(name) == "other"
