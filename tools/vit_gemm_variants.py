#!/usr/bin/env python3
"""Time the GEMM of ``situation_recognition_tpu_torch/csrc/vit_block.cu``
(K4 and K6 of the PyTorch port) against variants of it on one card.

    python3 tools/vit_gemm_variants.py [variant.cu ...] [--reps 20]

Builds, with the package's ``nvcc`` flags, into a temporary directory:

* ``main``       — the package's source;
* ``main_noepi`` — a diagnostic copy whose epilogue returns at once (no
  bias, residual, GELU or store; one accumulator value feeds a store that
  never happens, so that the compiler keeps every product): the main loop
  alone, so that the epilogue's share of each product shows;
* each ``variant.cu`` given (a copy of the source with a change; it must
  keep the C entry points).

Each build but the diagnostic is checked first against plain PyTorch math
on small and ragged shapes, product by product (max ≤ 2^-6 and mean
≤ 2^-10 of the largest element, the card tests' bounds), in a child
process with a time limit so that a hung kernel cannot hang the run.  Then
each build times the four products of ViT-L/14 at batch 256 (M = 65,792
rows, D = 1024, H = 4096; fc1 with both GELUs) through ``vit_block_gemm``,
and K4 and K6 whole, with CUDA events, in turns: every build in order,
then in reverse.  Prints one JSON line per build and pass.  Needs a card;
exits non-zero without one.
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
_SOURCE = os.path.join(_REPO, "situation_recognition_tpu_torch", "csrc",
                       "vit_block.cu")
# the first statement of each epilogue (store_tile, store_staged), before
# which the diagnostic returns
_EPILOGUE = "    const int q = threadIdx.x & 3;\n"
# what the diagnostic puts there: a store on a value no product gives
_KEEP = ("    if (d[0] == -1.0e30f) ep.out_f32[0] = d[BN / 2 - 1];\n"
         "    return;\n")
# (name, product code of vit_block_gemm)
_PRODUCTS = (("qkv", 0), ("out_proj", 1), ("fc1", 2), ("fc1_quick", 3),
             ("fc2", 4))
MAX_REL, MEAN_REL = 2 ** -6, 2 ** -10


def _build(name: str, src: str, out_dir: str) -> str:
    sys.path.insert(0, _REPO)
    from situation_recognition_tpu_torch.ops import _build as b

    out = os.path.join(out_dir, f"lib{name}.so")
    proc = subprocess.run([b._nvcc(), *b.NVCC_FLAGS, "-o", out, src],
                          capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"nvcc failed for {name}:\n{proc.stdout}"
                         f"{proc.stderr}")
    return out


def _library(path: str) -> ctypes.CDLL:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib = ctypes.CDLL(path)
    lib.vit_block_gemm.argtypes = [i] + [p] * 5 + [i] * 3 + [p]
    lib.vit_qkv_forward.argtypes = [p] * 9 + [i, i, f, p]
    lib.vit_out_mlp_forward.argtypes = [p] * 14 + [i, i, i, f, i, p]
    return lib


def _operands(m: int, d: int, gen):
    """Block weights as the kernels take them, a stream x, a context, a
    hidden (m, 4d) and an f32 residual, all on the card."""
    import torch

    from situation_recognition_tpu_torch.ops import vit as tv
    from situation_recognition_tpu_torch.ops import vit_kernel as vk

    hid = 4 * d

    def rnd(*shape, scale=1.0, base=0.0):
        return base + torch.randn(shape, generator=gen) * scale

    b = d ** -0.5
    w = vk.kernel_weights(tv.BlockWeights(
        rnd(d, base=1.0, scale=0.05), rnd(d, scale=0.05),
        rnd(3 * d, d, scale=b), rnd(3 * d, scale=b), rnd(d, d, scale=b),
        rnd(d, scale=b), rnd(d, base=1.0, scale=0.05), rnd(d, scale=0.05),
        rnd(hid, d, scale=b), rnd(hid, scale=b),
        rnd(d, hid, scale=hid ** -0.5), rnd(d, scale=b)))
    w = tv.BlockWeights(*(t.cuda() for t in w))
    bf = torch.bfloat16
    return (w, rnd(m, d).to(bf).cuda(), rnd(m, d).to(bf).cuda(),
            rnd(m, hid).to(bf).cuda(), rnd(m, d).cuda())


def _product(code: int, w, x, ctx, hidden, res32):
    """(a, weight, bias, residual, output dtype) of one product."""
    import torch

    return {0: (x, w.in_w, w.in_b, None, torch.bfloat16),
            1: (ctx, w.out_w, w.out_b, x, torch.float32),
            2: (x, w.fc1_w, w.fc1_b, None, torch.bfloat16),
            3: (x, w.fc1_w, w.fc1_b, None, torch.bfloat16),
            4: (hidden, w.fc2_w, w.fc2_b, res32, torch.bfloat16)}[code]


def _plain(code: int, a, wt, bias, res):
    from situation_recognition_tpu_torch.ops import vit as tv

    acc = a.float() @ wt.float().t()
    if code == 1:
        return (res.float() + acc) + bias
    if code in (2, 3):
        return tv.gelu(acc + bias, code == 3)
    if code == 4:
        return (res + acc) + bias
    return acc + bias


def _run(name: str, path: str, mode: str, reps: int) -> None:
    import torch

    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    lib = _library(path)
    gen = torch.Generator().manual_seed(0)
    shapes = ([(129, 192), (129, 256), (1, 64), (300, 1024), (1000, 128),
               (4 * 257, 1024)] if mode == "check" else [(256 * 257, 1024)])
    for m, d in shapes:
        w, x, ctx, hidden, res32 = _operands(m, d, gen)
        row = {"build": name, "mode": mode, "m": m, "d": d}
        for pname, code in _PRODUCTS:
            a, wt, bias, res, dtype = _product(code, w, x, ctx, hidden,
                                               res32)
            n, k = wt.shape
            out = torch.empty((m, n), dtype=dtype, device="cuda")
            args = (code, a.data_ptr(), wt.data_ptr(), bias.data_ptr(),
                    None if res is None else res.data_ptr(), out.data_ptr(),
                    m, n, k)

            def call():
                rc = lib.vit_block_gemm(
                    *args, torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise SystemExit(f"{name} {pname}: CUDA error {rc}")

            if mode == "check":
                call()
                torch.cuda.synchronize()
                err = cs._rel_errors(out, _plain(code, a, wt, bias, res)
                                     .to(dtype))
                row[pname] = {"max_rel": err["max_rel"],
                              "mean_rel": err["mean_rel"]}
                if err["max_rel"] > MAX_REL or err["mean_rel"] > MEAN_REL:
                    print(json.dumps(row), flush=True)
                    raise SystemExit(f"{name} {pname} disagrees at {m}x{d}")
            else:
                ms = cs._time_ms(call, reps)
                row[pname] = {"ms": ms, "tflops": 2 * m * n * k / ms / 1e9}
            del out
        if mode == "time" and not name.endswith("_noepi"):
            row.update(_whole(lib, w, x, ctx, reps))
        print(json.dumps(row), flush=True)


def _whole(lib, w, x, ctx, reps: int) -> dict:
    """K4 and K6 (erf) through the library's own entry points."""
    import torch

    import chip_smoke as cs

    m, d = x.shape
    hid = w.fc1_w.shape[0]
    y, q, k, v, out = (torch.empty_like(x) for _ in range(5))
    r = torch.empty((m, d), dtype=torch.float32, device="cuda")
    h = torch.empty((m, hid), dtype=torch.bfloat16, device="cuda")

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def k4():
        if lib.vit_qkv_forward(
                x.data_ptr(), w.ln1_w.data_ptr(), w.ln1_b.data_ptr(),
                w.in_w.data_ptr(), w.in_b.data_ptr(), y.data_ptr(),
                q.data_ptr(), k.data_ptr(), v.data_ptr(), m, d, 1e-6,
                stream()):
            raise SystemExit("vit_qkv_forward failed")

    def k6():
        if lib.vit_out_mlp_forward(
                x.data_ptr(), ctx.data_ptr(), w.out_w.data_ptr(),
                w.out_b.data_ptr(), w.ln2_w.data_ptr(), w.ln2_b.data_ptr(),
                w.fc1_w.data_ptr(), w.fc1_b.data_ptr(), w.fc2_w.data_ptr(),
                w.fc2_b.data_ptr(), r.data_ptr(), y.data_ptr(), h.data_ptr(),
                out.data_ptr(), m, d, hid, 1e-6, 0, stream()):
            raise SystemExit("vit_out_mlp_forward failed")

    return {"K4_ms": cs._time_ms(k4, reps), "K6_ms": cs._time_ms(k6, reps)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("variants", nargs="*", help="variant sources (.cu)")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--child", nargs=3, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    sys.path.insert(0, _REPO)
    if args.child:
        _run(*args.child, args.reps)
        return 0

    import torch

    if not torch.cuda.is_available():
        print("vit_gemm_variants: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"card": smi}), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        with open(_SOURCE) as f:
            text = f.read()
        if text.count(_EPILOGUE) != 2:
            raise SystemExit("the epilogues no longer start as expected")
        noepi = os.path.join(tmp, "main_noepi.cu")
        with open(noepi, "w") as f:
            f.write(text.replace(_EPILOGUE, _KEEP + _EPILOGUE))
        sources = [("main", _SOURCE), ("main_noepi", noepi)] + [
            (os.path.splitext(os.path.basename(v))[0], v)
            for v in args.variants]
        builds = [(name, _build(name, src, tmp)) for name, src in sources]
        for name, path in builds:
            if name.endswith("_noepi"):
                continue
            proc = subprocess.run(
                [sys.executable, __file__, "--child", name, path, "check"],
                capture_output=True, text=True, timeout=120)
            sys.stdout.write(proc.stdout)
            if proc.returncode:
                sys.stderr.write(proc.stderr[-4000:])
                raise SystemExit(f"{name} failed its check")
        for name, path in builds + builds[::-1]:
            proc = subprocess.run(
                [sys.executable, __file__, "--child", name, path, "time",
                 "--reps", str(args.reps)], capture_output=True, text=True,
                timeout=300)
            sys.stdout.write(proc.stdout)
            if proc.returncode:
                sys.stderr.write(proc.stderr[-4000:])
                raise SystemExit(f"{name} failed while timed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
