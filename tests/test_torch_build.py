"""The kernel build's bookkeeping, which runs without nvcc: what
``-Xptxas -v`` reported for each kernel (registers, spills, shared memory),
read back from the build log kept beside a library."""

import os

import pytest

from situation_recognition_tpu_torch.ops import _build

# nvcc -Xptxas -v output in the form CUDA 12 prints it for sm_90a: a device
# function's properties between two entry functions, a kernel with spills
# and one with static shared memory
_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_19dq_kernelEPK13__nv_bfloat16' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_19dq_kernelEPK13__nv_bfloat16
    8 bytes stack frame, 4 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 8 bytes cumulative stack size
ptxas info    : Function properties for __internal_helper
    64 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_110dkv_kernelEPK13__nv_bfloat16' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_110dkv_kernelEPK13__nv_bfloat16
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 16 bytes smem, 424 bytes cmem[0]
"""


@pytest.mark.parametrize("kernel,want", [
    ("dq_kernel", {"registers": 168, "spill_stores": 4, "spill_loads": 12,
                   "stack_frame": 8, "static_smem": 0}),
    ("dkv_kernel", {"registers": 128, "spill_stores": 0, "spill_loads": 0,
                    "stack_frame": 0, "static_smem": 16}),
])
def test_kernel_resources_reads_ptxas_report(kernel, want):
    got = _build.kernel_resources(_LOG, kernel)
    assert list(got.values()) == [want]
    assert kernel in next(iter(got))


def test_kernel_resources_of_an_absent_kernel_is_empty():
    assert _build.kernel_resources(_LOG, "attn_kernel") == {}
    assert _build.kernel_resources("", "dq_kernel") == {}


def test_build_log_reads_the_copy_beside_a_built_library(tmp_path,
                                                         monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    source = "vit_attention_bwd.cu"
    assert _build.build_log(source) == ""
    with open(f"{_build._target(source)[1]}.log", "w") as f:
        f.write(_LOG)
    assert _build.build_log(source) == _LOG


def _write(path, text):
    with open(path, "w") as f:
        f.write(text)


def test_target_hashes_the_headers_a_source_includes(tmp_path, monkeypatch):
    """An edited header of ``csrc/`` (included directly or through another
    header) names a new library; a header no source includes does not."""
    monkeypatch.setattr(_build, "_CSRC", str(tmp_path))
    _write(tmp_path / "k.cu", '#include <cuda.h>\n#include "a.cuh"\nint k;\n')
    _write(tmp_path / "a.cuh", '#pragma once\n#include "b.cuh"\n')
    _write(tmp_path / "b.cuh", "int b = 1;\n")
    _write(tmp_path / "other.cuh", "int o = 1;\n")
    first = _build._target("k.cu")[1]
    _write(tmp_path / "other.cuh", "int o = 2;\n")
    assert _build._target("k.cu")[1] == first
    _write(tmp_path / "b.cuh", "int b = 2;\n")
    second = _build._target("k.cu")[1]
    assert second != first
    _write(tmp_path / "a.cuh", '#pragma once\n#include "b.cuh"\n// x\n')
    assert _build._target("k.cu")[1] not in (first, second)


def test_the_gemm_sources_share_the_hopper_header():
    """K1/K2 and K4/K6 take their TMA, mbarrier and wgmma helpers from one
    header, which their libraries' names cover."""
    with open(_build._target("ggnn_folded.cu")[0]) as f:
        ggnn = f.read()
    with open(_build._target("vit_block.cu")[0]) as f:
        vit = f.read()
    assert '#include "hopper.cuh"' in ggnn and '#include "hopper.cuh"' in vit
    assert "mma_async.sync" not in ggnn + vit


def test_the_ggnn_sources_share_one_gemm():
    """K1/K2 and K3 run their products on one wgmma GEMM, from the header
    that both include (and that their libraries' names cover), each with
    its own epilogues; neither source has a GEMM kernel of its own."""
    texts = []
    for src in ("ggnn_folded.cu", "ggnn_folded_bwd.cu"):
        with open(_build._target(src)[0]) as f:
            texts.append(f.read())
    with open(os.path.join(_build._CSRC, "ggnn_gemm.cuh")) as f:
        gemm = f.read()
    assert "ggnn_gemm_kernel(" in gemm and "wgmma<" in gemm
    for text in texts:
        assert '#include "ggnn_gemm.cuh"' in text
        assert "ggnn_gemm_kernel(" not in text and "wgmma<" not in text
        assert "template <int KIND, int WN>" in text   # its epilogues
