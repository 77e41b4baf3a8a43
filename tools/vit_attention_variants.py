#!/usr/bin/env python3
"""Time the ViT attention kernels of the PyTorch port (K5/K7,
``csrc/vit_attention.cu``; K8, ``csrc/vit_attention_bwd.cu``) against
variants of their sources on one card.

    python3 tools/vit_attention_variants.py [source.cu ...] [--reps 20]
        [--heads 16,8,4,2]

Builds, with the package's ``nvcc`` flags, into a temporary directory the
package's two sources and each ``source.cu`` given: a copy of either one
with a change, or the file of another tree (a parent commit's), that keeps
its C entry point (``vit_attention_forward`` or ``vit_attention_backward``,
same arguments), and prints each build's registers and spills as
``-Xptxas -v`` reported them.  Each build is checked against the twins
of ``ops/vit.py`` first, at a ragged shape with pad rows and at the timed
one (the card tests' bounds: forward max ≤ 2^-6 and mean ≤ 2^-10 of the
largest element, backward 2^-5 and 2^-10, pad rows exactly zero).  Then
every build times its kernel at ViT-L/14, batch 256 (257 tokens, 1024
columns) in each head count of ``--heads`` that it takes, with CUDA
events, in turns: every build in order, then in reverse.  The forward is
timed in both softmax flavours (the exp2 fold, the f32 softmax), the
backward on the exp2 context.  Prints one JSON line per build, shape and
pass, and the card's ``nvidia-smi`` line.  Needs a card; exits non-zero
without one.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_REPO, "situation_recognition_tpu_torch", "csrc")
B, N, D = 256, 257, 1024
FWD_TOL, BWD_TOL = (2 ** -6, 2 ** -10), (2 ** -5, 2 ** -10)


def _build(name: str, src: str, out_dir: str) -> str:
    from situation_recognition_tpu_torch.ops import _build as b

    out = os.path.join(out_dir, f"lib{name}.so")
    proc = subprocess.run([b._nvcc(), *b.NVCC_FLAGS, "-o", out, src],
                          capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"nvcc failed for {name}:\n{proc.stdout}"
                         f"{proc.stderr}")
    # each kernel's registers and spills as -Xptxas -v reported them
    found = b.kernel_resources(proc.stdout + proc.stderr, "kernel")
    print(json.dumps({"build": name, "resources": found}), flush=True)
    return out


def _library(path: str):
    """(library, 'fwd' or 'bwd') with the entry's argument types set."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib = ctypes.CDLL(path)
    if hasattr(lib, "vit_attention_backward"):
        lib.vit_attention_backward.argtypes = [p] * 9 + [i] * 5 + [f, p]
        return lib, "bwd"
    lib.vit_attention_forward.argtypes = [p] * 4 + [i] * 5 + [f, f, i, p]
    return lib, "fwd"


class _Refused(RuntimeError):
    """The entry returned a CUDA error: 1 (invalid value) for a shape
    that the build does not take."""

    def __init__(self, rc: int):
        super().__init__(f"CUDA error {rc}")
        self.rc = rc


def _forward(lib, q, k, v, heads, folded, stride, n):
    import math

    import torch

    d = q.shape[1]
    scale = (d // heads) ** -0.5
    out = torch.empty_like(q)
    rc = lib.vit_attention_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        q.shape[0] // stride, stride, n, d, heads,
        float(scale * math.log2(math.e)), float(scale), int(folded),
        torch.cuda.current_stream().cuda_stream)
    if rc:
        raise _Refused(rc)
    return out


def _backward(lib, q, k, v, o, do, heads, stride, n):
    import torch

    d, b = q.shape[1], q.shape[0] // stride
    grads = [torch.empty_like(q) for _ in range(3)]
    stats = torch.empty((3, b, heads, stride), dtype=torch.float32,
                        device=q.device)
    rc = lib.vit_attention_backward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), *(g.data_ptr() for g in grads), stats.data_ptr(), b,
        stride, n, d, heads, float((d // heads) ** -0.5),
        torch.cuda.current_stream().cuda_stream)
    if rc:
        raise _Refused(rc)
    return grads


def _check(name, got, want, tol, b, stride, n) -> None:
    for i, (g, w) in enumerate(zip(got, want)):
        diff = (g.float() - w.float()).abs()
        scale = w.float().abs().max().item()
        if diff.max().item() > tol[0] * scale or \
                diff.mean().item() > tol[1] * scale:
            raise SystemExit(f"{name} output {i} disagrees with its twin "
                             f"at B={b} N={n} stride={stride}: max "
                             f"{diff.max().item()}, mean {diff.mean().item()}"
                             f", scale {scale}")
        if not (g.reshape(b, stride, -1)[:, n:] == 0).all():
            raise SystemExit(f"{name} wrote nonzero pad rows")


def _check_build(name, lib, kind, q, k, v, do, heads, scale, b, stride,
                 n) -> None:
    """One build against the twins of ``ops/vit.py`` at one shape."""
    import torch

    from situation_recognition_tpu_torch.ops import vit as tv

    if kind == "fwd":
        for folded in (True, False):
            want = tv.attn_core_reference(q, k, v, heads, scale, folded,
                                          stride, n)
            got = _forward(lib, q, k, v, heads, folded, stride, n)
            torch.cuda.synchronize()
            _check(name, [got], [want], FWD_TOL, b, stride, n)
    else:
        o = tv.attn_core_reference(q, k, v, heads, scale, True, stride, n)
        want = tv.attn_bwd_reference(q, k, v, o, do, heads, scale, stride,
                                     n)
        got = _backward(lib, q, k, v, o, do, heads, stride, n)
        torch.cuda.synchronize()
        _check(name, got, want, BWD_TOL, b, stride, n)


def _operands(b, stride, gen):
    import torch

    return [torch.randn(b * stride, D, generator=gen).to(torch.bfloat16)
            .cuda() for _ in range(4)]


def _takes(heads: int) -> bool:
    return D % heads == 0 and (D // heads) % 64 == 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("sources", nargs="*")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--heads", default="16,8,4,2")
    args = ap.parse_args(argv)
    sys.path.insert(0, _REPO)
    import torch

    from situation_recognition_tpu_torch.ops import vit as tv

    if not torch.cuda.is_available():
        print("vit_attention_variants: no CUDA device", file=sys.stderr)
        return 1
    heads_list = [int(h) for h in args.heads.split(",") if _takes(int(h))]
    tmp = tempfile.mkdtemp(prefix="vit_attention_variants_")
    builds = {"main_fwd": os.path.join(_CSRC, "vit_attention.cu"),
              "main_bwd": os.path.join(_CSRC, "vit_attention_bwd.cu")}
    for i, src in enumerate(args.sources):
        builds[f"v{i}_{os.path.basename(src).rsplit('.', 1)[0]}"] = src
    libs = {name: _library(_build(name, src, tmp))
            for name, src in builds.items()}
    gen = torch.Generator().manual_seed(0)

    # the checks: a ragged shape with pad rows, then the timed shape; a
    # head count that a build refuses (a tree before the head width it
    # needs) is left out of its timing
    refused = set()
    for b, n, stride in ((3, 65, 72), (B, N, N)):
        q, k, v, do = _operands(b, stride, gen)
        for heads in heads_list:
            scale = (D // heads) ** -0.5
            for name, (lib, kind) in libs.items():
                if (name, heads) in refused:
                    continue
                try:
                    _check_build(name, lib, kind, q, k, v, do, heads, scale,
                                 b, stride, n)
                except _Refused as e:
                    if e.rc != 1:
                        raise
                    refused.add((name, heads))
        del q, k, v, do

    q, k, v, do = _operands(B, N, gen)
    ctx = {h: tv.attn_core_reference(q, k, v, h, (D // h) ** -0.5, True, N,
                                     N) for h in heads_list}
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))

    def time_ms(fn) -> float:
        for _ in range(3):
            fn()
        start.record()
        for _ in range(args.reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / args.reps

    order = list(libs)
    for turn, names in enumerate((order, order[::-1])):
        for name in names:
            lib, kind = libs[name]
            for heads in heads_list:
                if (name, heads) in refused:
                    continue
                row = {"build": name, "turn": turn, "heads": heads,
                       "dh": D // heads, "shape": f"B={B} N={N} D={D}"}
                if kind == "fwd":
                    for flavour, folded in (("exp2", True),
                                            ("softmax", False)):
                        row[f"{flavour}_ms"] = time_ms(
                            lambda: _forward(lib, q, k, v, heads, folded, N,
                                             N))
                else:
                    row["ms"] = time_ms(lambda: _backward(
                        lib, q, k, v, ctx[heads], do, heads, N, N))
                print(json.dumps(row), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
