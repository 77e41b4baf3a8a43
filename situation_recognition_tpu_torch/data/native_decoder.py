"""ctypes bindings for the native batch decoder (``data/native/decoder.cpp``).

Port of ``situation_recognition_tpu/data/native_decoder.py`` with its own
build: ``g++ -O3 -shared -fPIC -std=c++17 decoder.cpp -ljpeg -pthread``
into ``build/native/`` beside the package (ignored by git), never next to
the source, under a name that carries a hash of the source and the flags.
Each process compiles into ``{out}.{pid}.tmp`` and renames it into place,
so concurrent first uses (test workers, loader threads) never read or
replace each other's half-written file.

``decode_window_batch`` decodes a list of JPEG paths into a (B, 256, 256,
3) uint8 window batch with one C call (GIL released for the whole batch;
internal thread pool).  Failed decodes (non-JPEG, corrupt) are reported per
image so the caller can fall back to the PIL path.

Augmentation: crop offsets and flip bits come from a splitmix64 stream
keyed by (seed, epoch, index) — deterministic, but a different stream than
the Python loader's numpy PCG64, exactly as in the JAX package.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Sequence, Tuple

import numpy as np

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "native",
                   "decoder.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "build", "native")
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
LIBS = ("-ljpeg", "-pthread")

_lib = None
_lock = threading.Lock()


class NativeBuildError(RuntimeError):
    pass


def library_path() -> str:
    """Where the library of the current source and flags is built."""
    digest = hashlib.sha256()
    with open(SRC, "rb") as f:
        digest.update(f.read())
    digest.update(" ".join(FLAGS + LIBS).encode())
    return os.path.join(BUILD_DIR,
                        f"libsrtorch_decoder-{digest.hexdigest()[:16]}.so")


def ensure_built() -> str:
    """Compile ``decoder.cpp`` unless its library exists; → its path."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = ["g++", *FLAGS, SRC, *LIBS, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise NativeBuildError(f"g++ not available: {e}") from e
    except subprocess.CalledProcessError as e:
        raise NativeBuildError(
            f"native decoder build failed:\n{e.stderr}") from e
    os.replace(tmp, out)
    return out


def available() -> bool:
    try:
        _load()
        return True
    except (NativeBuildError, OSError):
        return False


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(ensure_built())
        lib.srtpu_decode_window_batch.restype = ctypes.c_int
        lib.srtpu_decode_window_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p),  # paths
            ctypes.c_int,                     # n
            ctypes.c_int,                     # train
            ctypes.c_uint64,                  # seed
            ctypes.c_uint64,                  # epoch
            ctypes.POINTER(ctypes.c_int64),   # indices
            ctypes.POINTER(ctypes.c_uint8),   # out
            ctypes.POINTER(ctypes.c_uint8),   # flips
            ctypes.POINTER(ctypes.c_uint8),   # failed
            ctypes.c_int,                     # num_threads
        ]
        _lib = lib
        return lib


def decode_window_batch(paths: Sequence[str], train: bool, seed: int,
                        epoch: int, indices: Sequence[int],
                        num_threads: int = 4
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """→ (images (B, 256, 256, 3) u8, flips (B,) bool, failed (B,) bool)."""
    lib = _load()
    n = len(paths)
    if len(indices) != n:
        # the C worker reads indices[i] for every path
        raise ValueError(
            f"decode_window_batch: {n} paths but {len(indices)} indices")
    images = np.empty((n, 256, 256, 3), dtype=np.uint8)
    flips = np.zeros((n,), dtype=np.uint8)
    failed = np.zeros((n,), dtype=np.uint8)
    idx = np.ascontiguousarray(np.asarray(indices, dtype=np.int64))
    # os.fsencode: file names need not be UTF-8
    c_paths = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    lib.srtpu_decode_window_batch(
        c_paths, n, int(train), seed & (2**64 - 1), epoch & (2**64 - 1),
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        images.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        flips.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        failed.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        num_threads)
    return images, flips.astype(bool), failed.astype(bool)
