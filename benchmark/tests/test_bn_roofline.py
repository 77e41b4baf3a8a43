"""``bn_roofline.train``: the BN byte count on the reference's ResNet, and
the reader's arithmetic over a reduced trace."""

import pytest

import core
import work

PEAK = core.peaks("NVIDIA H100 80GB HBM3")


@pytest.fixture(scope="module")
def reader():
    return core.metric_reader("bn_roofline.train")


class _Ctx:
    def __init__(self, kernels, batch=1536, config="r152-fcggnn"):
        self.config = core.config(config)
        self.counters = {"batch": batch}
        self.peaks = PEAK
        self.trace = None if kernels is None else {
            "kernels": kernels, "busy_s": 1.0, "window_s": 1.0,
            "categories": {}}


def test_the_count_at_the_r152_cell(reader):
    # ResNet-152 at 224²: 155 BN layers, 22,554,112 BN output elements an
    # image, 13,146,112 of them where a block adds its residual; bf16
    cfg = core.config("r152-fcggnn")
    nbytes, layers = reader.bn_work(cfg, 1536)
    assert layers == 155
    assert nbytes == 1536 * 2 * (3 * 22_554_112 + 13_146_112)
    assert nbytes == pytest.approx(248.2e9, rel=1e-3)
    least, term = work.least_ms(0, nbytes, *PEAK)
    assert term == "bytes"
    assert least == pytest.approx(74.1, rel=1e-3)


@pytest.mark.parametrize("kernels", [
    None, {},
    {"void at::native::batch_norm_collect_statistics_channels_last_kernel":
     [0.58, 930],
     "void at::native::batch_norm_transform_input_channels_last_kernel":
     [0.39, 930]}])
def test_none_without_the_batchnorm_kernels(reader, kernels):
    assert reader.read(_Ctx(kernels)) is None


def test_a_reduced_trace_reads_least_over_device_time_a_step(reader):
    # 6 traced steps: 155 launches of each kernel a step
    kernels = {
        "void batchnorm_stats_kernel<__nv_bfloat16, 8>(...)": [0.150, 930],
        "void batchnorm_apply_kernel<__nv_bfloat16, 8, true, true>(...)":
            [0.300, 300],
        "void batchnorm_apply_kernel<__nv_bfloat16, 8, false, true>(...)":
            [0.130, 630],
        "void at::native::vectorized_elementwise_kernel<8>": [1.0, 6]}
    least, _ = work.least_ms(0, reader.bn_work(core.config("r152-fcggnn"),
                                                1536)[0], *PEAK)
    want = 100.0 * least / ((0.150 + 0.300 + 0.130) / 6 * 1e3)
    assert reader.read(_Ctx(kernels)) == pytest.approx(want)
    assert 0 < want <= 100


def test_no_reading_in_a_cell_without_batch_norm(reader):
    kernels = {"void batchnorm_apply_kernel<float, 4, false, false>":
               [0.1, 10]}
    assert reader.read(_Ctx(kernels, 256, "vitl14-fcggnn")) is None
