"""The port stands alone: no module of it (its tools included), and not
chip_smoke.py or the port's scripts in ``tools/``, imports JAX or the JAX
package; its entry points refuse to run without a card
unless the CPU is asked for by name."""

import ast
import os
import subprocess
import sys

import pytest
import torch

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PKG = os.path.join(_REPO, "situation_recognition_tpu_torch")
_FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "msgpack",
              "situation_recognition_tpu")


#: the port's scripts under the repository's ``tools/`` (the rest of that
#: directory is the JAX package's)
_PORT_TOOLS = ("ggnn_tile_sweep.py", "vit_gemm_variants.py",
               "serving_program_profile.py", "vit_attention_variants.py")


def _port_files():
    out = [os.path.join(_REPO, "chip_smoke.py")]
    out += [os.path.join(_REPO, "tools", f) for f in _PORT_TOOLS]
    for root, _, files in os.walk(_PKG):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, _REPO))
def test_no_jax_imports(path):
    bad = [m for m in _imported_roots(path)
           if m.split(".")[0] in _FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_importing_the_port_loads_no_jax():
    modules = ["situation_recognition_tpu_torch." + m for m in (
        "device", "convert", "serving", "server", "train", "cli",
        "data.encoder", "data.transforms", "data.dataset",
        "data.native_decoder", "utils.checkpoint", "utils.logging",
        "metrics.scorer", "ops.ggnn", "ops.ggnn_kernel",
        "ops.ggnn_train", "ops._build", "ops.vit", "ops.vit_kernel",
        "ops.vit_train", "ops.swin", "ops.swin_kernel",
        "models.resnet", "models.vit", "models.swin", "models.backbone",
        "models.fcggnn",
        "bench", "export_serving", "inference", "utils.msgpack",
        "parallel.distributed", "parallel.mesh", "parallel.spmd",
        "tools.common", "tools.profile_step", "tools.perf_guard",
        "tools.bench_e2e", "tools.bench_input", "tools.bench_vit_block",
        "tools.pack_dataset", "tools.convert_torch", "tools.export_torch")]
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in modules)
            + "bad = [m for m in sys.modules if m.split('.')[0] in "
            + repr(_FORBIDDEN) + "]\n"
            + "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=_REPO)
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=_REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_chip_smoke_refuses_without_its_repo(tmp_path):
    """Alone in a directory, chip_smoke.py fails and prints no result."""
    import shutil

    shutil.copy(os.path.join(_REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_entry_points_raise_without_a_card(monkeypatch, tmp_path):
    from situation_recognition_tpu_torch.device import resolve_device
    from situation_recognition_tpu_torch.serving import load_inference

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_inference(str(tmp_path))
    assert resolve_device("cpu") == torch.device("cpu")


def test_kernel_wrapper_has_no_fallback_off_cpu():
    """A tensor that is not on the CPU never reaches the plain twin."""
    from situation_recognition_tpu_torch.ops import ggnn_kernel as tk

    h = torch.zeros(6, 64, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="no GGNN kernel"):
        tk.folded_rows(h, torch.zeros(6, device="meta"), (None,) * 4, 6, 1)


def test_vit_kernel_wrappers_have_no_fallback_off_cpu():
    """A tensor that is not on the CPU never reaches a ViT twin."""
    from situation_recognition_tpu_torch.ops import vit_kernel as vk

    x = torch.zeros(2 * 8, 64, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="no ViT kernel"):
        vk.vit_qkv_forward(x, None, 1e-6)
    with pytest.raises(ValueError, match="no ViT kernel"):
        vk.vit_out_mlp_forward(x, x, None, 1e-6, False)
    with pytest.raises(ValueError, match="no ViT kernel"):
        vk.vit_attention_stream_forward(x, x, x, 1, True, 8, 7)
    with pytest.raises(ValueError, match="no ViT kernel"):
        vk.vit_attention_forward(x.reshape(2, 8, 64), x.reshape(2, 8, 64),
                                 x.reshape(2, 8, 64), 1, True)


@pytest.mark.parametrize("shift,transpose,ok", [
    (0, False, True), (1, False, False), (8, False, True), (0, True, False)])
def test_kernel_operand_check_refuses_what_tma_cannot_read(shift, transpose,
                                                          ok):
    """The check each kernel wrapper runs on every operand before a launch
    (the ViT GEMMs read them through TMA tensor maps): a view ``shift``
    elements into a buffer passes only when 16-byte aligned, a transposed
    view never."""
    from situation_recognition_tpu_torch.ops.ggnn_kernel import (
        _check_tensors)

    m, d = 64, 128
    buf = torch.zeros(m * d + 8, dtype=torch.bfloat16)
    x = buf[shift:shift + m * d].view(m, d)
    if transpose:
        x = buf[:m * d].view(d, m).t()
    want = {"x": (x, (m, d), torch.bfloat16)}
    if ok:
        _check_tensors(x.device, want)
    else:
        with pytest.raises(ValueError, match="16-byte aligned"):
            _check_tensors(x.device, want)
