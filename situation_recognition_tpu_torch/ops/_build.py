"""Build a CUDA source of this package with ``nvcc`` into a shared library
with a plain C interface, and load it with ``ctypes``.

The library is built at first use into ``build/torch_kernels/`` beside the
package (``build/`` is ignored by git), under a name that carries a hash of
the source, the headers of ``csrc/`` it includes and the flags, so an
edited source or header is rebuilt and an unchanged one is loaded as it
is.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
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


_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]+"([^"]+)"', re.M)


def _target(source: str) -> tuple:
    """``csrc/<source>`` and its library's path, whose name carries a hash
    of the source, of the local headers it includes (``#include "..."``,
    found beside the including file, recursively) and of the flags."""
    src = os.path.join(_CSRC, source)
    digest = hashlib.sha256()
    seen, todo = set(), [src]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.add(path)
        with open(path, "rb") as f:
            text = f.read()
        digest.update(text)
        todo += [os.path.join(os.path.dirname(path), name.decode())
                 for name in _INCLUDE.findall(text)]
    digest.update(" ".join(NVCC_FLAGS).encode())
    stem = os.path.splitext(source)[0]
    return src, os.path.join(BUILD_DIR,
                             f"lib{stem}-{digest.hexdigest()[:16]}.so")


def build(sources) -> None:
    """Compile the libraries of ``sources`` that are not built yet, one
    ``nvcc`` process each, all started together; each library's ``nvcc``
    output (``-Xptxas -v``: registers, shared memory, spills) is kept
    beside it (``build_log``)."""
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
            log = proc.communicate()[0]
            if proc.returncode != 0:
                failed.append(f"{source}:\n{log}")
                continue
            with open(f"{tmp}.log", "w") as f:
                f.write(log)
            os.replace(f"{tmp}.log", f"{out}.log")
            os.replace(tmp, out)
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))


def build_log(source: str) -> str:
    """The ``nvcc`` output of the built library of ``source`` ("" when it
    has not been built)."""
    path = f"{_target(source)[1]}.log"
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return f.read()


def load(source: str) -> ctypes.CDLL:
    """``csrc/<source>`` → loaded ``ctypes.CDLL`` (built once per process
    and once per source content)."""
    if source not in _libs:
        build([source])
    with _lock:
        if source not in _libs:
            _libs[source] = ctypes.CDLL(_target(source)[1])
        return _libs[source]


_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_PROPS = re.compile(r"Function properties for (\S+)")
_FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                    r"(\d+) bytes spill loads")
_USED = re.compile(r"Used (\d+) registers")
_SMEM = re.compile(r"(\d+) bytes smem")


def kernel_resources(log: str, kernel: str) -> dict:
    """What ``-Xptxas -v`` reported in ``log`` for the entry functions
    whose (mangled) names contain ``kernel``: by name, the registers per
    thread, spill stores and loads and stack frame in bytes, and static
    shared memory in bytes.  Empty when no entry matches."""
    out, name, props = {}, None, None
    for line in log.splitlines():
        m = _ENTRY.search(line)
        if m:
            name = m.group(1) if kernel in m.group(1) else None
            if name:
                out[name] = {"registers": None, "spill_stores": None,
                             "spill_loads": None, "stack_frame": None,
                             "static_smem": 0}
            continue
        m = _PROPS.search(line)
        if m:
            props = m.group(1)
            continue
        if name is None:
            continue
        m = _FRAME.search(line)
        if m and props == name:
            out[name].update(stack_frame=int(m.group(1)),
                             spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
        m = _USED.search(line)
        if m:
            out[name]["registers"] = int(m.group(1))
            smem = _SMEM.search(line)
            if smem:
                out[name]["static_smem"] = int(smem.group(1))
    return out
