#!/usr/bin/env python3
"""Check and time K1 of the PyTorch port (``csrc/ggnn_folded.cu``, the
folded GGNN forward) under every tile plan, on one card.

    python3 tools/ggnn_tile_sweep.py [--reps 20] [--seed 0] [--csrc DIR]
                                     [--chosen] [--diagnostic]

1. Builds the package's ``ggnn_folded.cu`` (``ops/_build.py``) and prints
   what ``nvcc -Xptxas -v`` reported for its kernels and the HGMMA count of
   each GEMM instantiation in the SASS (``cuobjdump -sass``).
2. In a child process with a time limit (a hung kernel cannot hang the
   run): K1 and K2 under every plan (rows 64 or 128; gate columns 128 or
   256, candidate columns 64, 128 or 256) against their twins at small and
   ragged shapes (max abs ≤ 2^-4, mean ≤ 1e-3: ``chip_smoke.py``'s bounds).
3. Times K1 (d=2048 and 1024, 4 steps, the noun shape B=256 x R=6 with
   ragged masks, the verb shape B=256 x 1 and a ragged B=7 x 6) under each
   plan with CUDA events, every plan in order then in reverse, marks the
   plan ``tile_plan`` picks, and profiles that plan at each shape
   (``torch.profiler``: device time by kernel).

``--csrc DIR`` builds ``DIR/ggnn_folded.cu`` (a copy of the package's
source with a change, beside copies of ``ggnn_gemm.cuh`` and
``hopper.cuh``) in place of the
package's, to compare a variant with it in one call; ``--diagnostic``
skips the checks, for such a copy that does not compute the function (an
epilogue that returns at once, to time a main loop alone); ``--chosen``
times only the plan ``tile_plan`` picks.  Prints one JSON line per check, timing
and profile.  Needs a card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

MAX_TOL, MEAN_TOL = 2 ** -4, 1e-3
STEPS = 4
# (label, batch, roles, d)
SHAPES = (("noun", 256, 6, 2048), ("verb", 256, 1, 2048),
          ("ragged", 7, 6, 2048), ("noun", 256, 6, 1024),
          ("verb", 256, 1, 1024))
# (batch, roles, d, verb) of the checks: tiles with partial row tiles,
# every candidate width, both masks
CHECKS = ((11, 6, 256, False), (129, 1, 256, True), (43, 6, 512, False),
          (1, 1, 64, True))


def _plans(d: int):
    from situation_recognition_tpu_torch.ops.ggnn_kernel import TilePlan

    return [TilePlan(gm, gn, cm, cn) for gm in (128, 64) for gn in (256, 128)
            for cm in (128, 64) for cn in (256, 128, 64)
            if (2 * d) % gn == 0 and d % cn == 0]


def _case(b: int, r: int, d: int, gen, verb: bool):
    import torch

    from situation_recognition_tpu_torch.ops import ggnn_kernel as tk
    from situation_recognition_tpu_torch.ops.ggnn import GGNNParams

    bound = 1.0 / d ** 0.5
    arrs = []
    for _ in range(7):
        arrs.append((torch.rand(d, d, generator=gen) * 2 - 1) * bound)
        arrs.append((torch.rand(d, generator=gen) * 2 - 1) * bound)
    weights = [w.cuda() for w in tk.fold_gate_weights(GGNNParams(*arrs),
                                                      float(r))]
    h = torch.randn(b * r, d, generator=gen).to(torch.bfloat16).cuda()
    counts = torch.randint(1, r + 1, (b,), generator=gen)
    mask = (torch.arange(r)[None, :] < counts[:, None]).float().reshape(-1)
    if verb:
        mask.zero_()
    return h, mask.cuda(), weights


def _err(got, want) -> tuple:
    diff = (got.float() - want.float()).abs()
    return diff.max().item(), diff.mean().item()


def check(seed: int) -> int:
    """Every plan against the twins; 0 if all agree."""
    import torch

    from situation_recognition_tpu_torch.ops import ggnn_kernel as tk

    gen = torch.Generator().manual_seed(seed)
    bad = 0
    for b, r, d, verb in CHECKS:
        h, mask, weights = _case(b, r, d, gen, verb)
        want = tk.folded_reference(h, mask, weights, r, STEPS)
        want_res = tk.folded_reference_res(h, mask, weights, r, STEPS)
        for plan in _plans(d):
            got = tk._launch(h, mask, weights, r, STEPS, plan)
            got_res = tk._launch_res(h, mask, weights, r, STEPS, plan)
            torch.cuda.synchronize()
            errs = {"K1": _err(got, want)}
            for name, g, w in zip(("out", "h", "z", "r", "c"),
                                  (got_res[0],) + got_res[1],
                                  (want_res[0],) + want_res[1]):
                errs[f"K2 {name}"] = _err(g, w)
            ok = all(e[0] <= MAX_TOL and e[1] <= MEAN_TOL
                     for e in errs.values())
            bad += not ok
            print(json.dumps({"check": f"B={b} R={r} d={d} verb={verb}",
                              "plan": plan._asdict(), "ok": ok,
                              "errors": errs}), flush=True)
    return 1 if bad else 0


def _time_ms(fn, reps: int) -> float:
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _profile(fn) -> dict:
    """Device time (ms) by kernel name over one call of ``fn``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total", None)
        if t is None:
            t = ev.cuda_time_total
        if t > 0:
            out[ev.key[:90]] = {"ms": t / 1e3, "calls": ev.count}
    return out


def sweep(seed: int, reps: int, chosen_only: bool) -> None:
    import torch

    from situation_recognition_tpu_torch.ops import ggnn_kernel as tk

    gen = torch.Generator().manual_seed(seed)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for label, b, r, d in SHAPES:
        h, mask, weights = _case(b, r, d, gen, r == 1)
        m = b * r
        chosen = tk.tile_plan(m, d, sms)
        plans = [chosen] if chosen_only else _plans(d)
        want = tk.folded_reference(h, mask, weights, r, STEPS)
        times = {p: [] for p in plans}
        for order in (plans, plans[::-1]):
            for plan in order:
                times[plan].append(_time_ms(
                    lambda: tk._launch(h, mask, weights, r, STEPS, plan),
                    reps))
        for plan in plans:
            got = tk._launch(h, mask, weights, r, STEPS, plan)
            print(json.dumps({
                "shape": f"{label} B={b} R={r} M={m} d={d}",
                "plan": plan._asdict(), "chosen": plan == chosen,
                "ms": times[plan], "max_abs_err": _err(got, want)[0],
                "tflops": 12 * m * d * d * STEPS / min(times[plan]) / 1e9}),
                flush=True)
        prof = _profile(lambda: tk._launch(h, mask, weights, r, STEPS,
                                           chosen))
        print(json.dumps({"profile": f"{label} B={b} R={r} M={m} d={d}",
                          "plan": chosen._asdict(), "kernels": prof}),
              flush=True)


def _build_source() -> str:
    from situation_recognition_tpu_torch.ops import _build

    return _build._target("ggnn_folded.cu")[0]


def resources() -> None:
    from situation_recognition_tpu_torch.ops import _build

    src = "ggnn_folded.cu"
    _build.build([src])
    log = _build.build_log(src)
    print("\n".join(line for line in log.splitlines() if line.strip()),
          flush=True)
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", _build._target(src)[1]],
                          capture_output=True, text=True, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        found = re.search(r"Function : (\S+)", line)
        if found:
            fn = found.group(1)
            counts[fn] = 0
        elif fn is not None and "HGMMA" in line:
            counts[fn] += 1
    print(json.dumps({"sass_hgmma": counts}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--csrc", default=None)
    ap.add_argument("--chosen", action="store_true")
    ap.add_argument("--diagnostic", action="store_true")
    ap.add_argument("--child", choices=("check",), default=None)
    args = ap.parse_args()
    if args.csrc:
        from situation_recognition_tpu_torch.ops import _build

        _build._CSRC = os.path.abspath(args.csrc)

    import torch

    if not torch.cuda.is_available():
        print("ggnn_tile_sweep: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.child == "check":
        return check(args.seed)
    print(json.dumps({"device": torch.cuda.get_device_name(0)}), flush=True)
    resources()
    if args.diagnostic:
        sweep(args.seed, args.reps, args.chosen)
        return 0
    try:
        rc = subprocess.run([sys.executable, os.path.abspath(__file__),
                             "--child", "check", "--seed", str(args.seed)]
                            + (["--csrc", args.csrc] if args.csrc else []),
                            timeout=300).returncode
    except subprocess.TimeoutExpired:
        print("ggnn_tile_sweep: the checks timed out", file=sys.stderr)
        return 1
    if rc:
        print("ggnn_tile_sweep: a plan disagrees with the twins",
              file=sys.stderr)
        return rc
    print(json.dumps({"source": _build_source()}), flush=True)
    sweep(args.seed, args.reps, args.chosen)
    return 0


if __name__ == "__main__":
    sys.exit(main())
