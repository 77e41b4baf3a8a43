"""The kernel build's bookkeeping, which runs without nvcc: what
``-Xptxas -v`` reported for each kernel (registers, spills, shared memory),
read back from the build log kept beside a library; and the binding of
the libraries' C entry points, each kernel module's signature table held
against the prototypes of ``csrc/*.cu``."""

import ctypes
import os
import re
import types

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


# ------------------------------------------------------------ the binding

_KINDS = {"int": ctypes.c_int, "float": ctypes.c_float,
          "double": ctypes.c_double}


def _c_type(param: str):
    """A C parameter's ctypes type as the binding passes it: a pointer or a
    stream is ``c_void_p``, ``int`` / ``float`` / ``double`` their own;
    None for any other."""
    if "*" in param or "cudaStream_t" in param.split():
        return ctypes.c_void_p
    words = [w for w in param.split()[:-1] if w != "const"]
    return _KINDS.get(" ".join(words))


def _c_entries() -> dict:
    """Each function defined in an ``extern "C"`` block of ``csrc/*.cu`` →
    (source, return type, the ctypes types of its parameters)."""
    out = {}
    for name in sorted(os.listdir(_build._CSRC)):
        if not name.endswith(".cu"):
            continue
        with open(os.path.join(_build._CSRC, name)) as f:
            text = re.sub(r"//[^\n]*|/\*.*?\*/", "", f.read(), flags=re.S)
        for block in re.finditer(r'extern\s+"C"\s*\{', text):
            top, depth = [], 1
            for ch in text[block.end():]:
                depth += (ch == "{") - (ch == "}")
                if depth == 0:
                    break
                if depth == 1 and ch != "}":
                    top.append(ch)
            for m in re.finditer(r"([\w\s*]+?)\s*\b(\w+)\s*\(([^()]*)\)",
                                 "".join(top)):
                params = [p.strip() for p in m.group(3).split(",")]
                if params in ([""], ["void"]):
                    params = []
                assert m.group(2) not in out, f"{m.group(2)} twice"
                out[m.group(2)] = (name, " ".join(m.group(1).split()),
                                   [_c_type(p) for p in params])
    return out


def _tables() -> dict:
    """The signature tables of the kernel modules, merged: entry → (the
    module that binds it, its ctypes types)."""
    from situation_recognition_tpu_torch.ops import (
        batchnorm, gelu, ggnn_kernel, layernorm, swin_kernel, vit_kernel)

    out = {}
    for mod in (batchnorm, gelu, ggnn_kernel, layernorm, swin_kernel,
                vit_kernel):
        for entry, types in mod.SIGNATURES.items():
            assert entry not in out, f"{entry} in two tables"
            out[entry] = (mod.__name__, list(types))
    return out


_C_ENTRIES = _c_entries()
_TABLES = _tables()


@pytest.mark.parametrize("entry", sorted(set(_C_ENTRIES) | set(_TABLES)))
def test_signature_table_matches_the_c_prototype(entry):
    """Each entry point of ``csrc/*.cu``'s ``extern "C"`` blocks is in one
    module's signature table, and the table gives its parameters in the
    C prototype's number and kinds, with the ``int`` return that
    ``_build.bind`` sets; each table's entry is defined in C."""
    assert entry in _C_ENTRIES, f"{entry} is in no extern \"C\" block"
    assert entry in _TABLES, f"{entry} is in no signature table"
    source, ret, c_types = _C_ENTRIES[entry]
    module, types = _TABLES[entry]
    assert ret == "int", f"{source}: {entry} returns {ret}"
    assert None not in c_types, f"{source}: {entry} has a parameter of " \
        "a kind the binding does not pass"
    assert types == c_types, f"{module} binds {entry} of {source} as " \
        f"{types}, its prototype takes {c_types}"


def test_a_failed_launch_raises_with_its_error_code(monkeypatch):
    """An entry that returns a CUDA error code makes ``launch`` raise
    with the entry's name and the code; the function is bound once."""
    calls = []

    def stand_in(*args):
        calls.append(args)
        return 7

    monkeypatch.setattr(_build, "_bound", {})
    monkeypatch.setattr(_build, "load", lambda source: types.SimpleNamespace(
        stand_in_launch=stand_in))
    table = {"stand_in_launch": [ctypes.c_int, ctypes.c_void_p]}
    for _ in range(2):
        with pytest.raises(RuntimeError, match=r"^stand_in_launch failed "
                           r"to launch: CUDA error 7$"):
            _build.launch("stand_in.cu", "stand_in_launch", table, 3, None)
    assert calls == [(3, None)] * 2
    assert stand_in.restype is ctypes.c_int
    assert stand_in.argtypes == table["stand_in_launch"]
    assert _build.bind("stand_in.cu", "stand_in_launch", {}) is stand_in
