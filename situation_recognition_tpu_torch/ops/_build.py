"""Build a CUDA source of this package with ``nvcc`` into a shared library
with a plain C interface, and load it with ``ctypes``.

The library is built at first use into ``build/torch_kernels/`` beside the
package (``build/`` is ignored by git), under a name that carries a hash of
the source and the flags, so an edited source is rebuilt and an unchanged
one is loaded as it is.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "build", "torch_kernels")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict = {}
#: ``nvcc`` output (``-Xptxas -v``: registers, shared memory, spills) of
#: each library built by this process, by source name
build_logs: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (on PATH or under CUDA_HOME); "
                           "the CUDA kernels of this package are built "
                           "from source at first use")
    return path


def _target(source: str) -> tuple:
    src = os.path.join(_CSRC, source)
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()
                                ).hexdigest()[:16]
    stem = os.path.splitext(source)[0]
    return src, os.path.join(BUILD_DIR, f"lib{stem}-{digest}.so")


def build(sources) -> None:
    """Compile the libraries of ``sources`` that are not built yet, one
    ``nvcc`` process each, all started together."""
    with _lock:
        os.makedirs(BUILD_DIR, exist_ok=True)
        jobs = []
        for source in sources:
            src, out = _target(source)
            if os.path.exists(out):
                continue
            tmp = f"{out}.{os.getpid()}.tmp"
            jobs.append((source, out, tmp, subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for source, out, tmp, proc in jobs:
            build_logs[source] = proc.communicate()[0]
            if proc.returncode != 0:
                failed.append(source)
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(
                f"{s}:\n{build_logs[s]}" for s in failed))


def load(source: str) -> ctypes.CDLL:
    """``csrc/<source>`` → loaded ``ctypes.CDLL`` (built once per process
    and once per source content)."""
    if source not in _libs:
        build([source])
    with _lock:
        if source not in _libs:
            _libs[source] = ctypes.CDLL(_target(source)[1])
        return _libs[source]
