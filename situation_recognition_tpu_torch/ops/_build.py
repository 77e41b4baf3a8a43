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


def load(source: str) -> ctypes.CDLL:
    """``csrc/<source>`` → loaded ``ctypes.CDLL`` (built once per process
    and once per source content)."""
    with _lock:
        if source in _libs:
            return _libs[source]
        src = os.path.join(_CSRC, source)
        with open(src, "rb") as f:
            digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()
                                    ).hexdigest()[:16]
        os.makedirs(BUILD_DIR, exist_ok=True)
        stem = os.path.splitext(source)[0]
        out = os.path.join(BUILD_DIR, f"lib{stem}-{digest}.so")
        if not os.path.exists(out):
            tmp = f"{out}.{os.getpid()}.tmp"
            proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                                  capture_output=True, text=True)
            build_logs[source] = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {source}:\n"
                                   f"{build_logs[source]}")
            os.replace(tmp, out)
        lib = ctypes.CDLL(out)
        _libs[source] = lib
        return lib
