#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card (H100).

    python3 chip_smoke.py [--seed 0]

Phases, each printing its seconds:

1. device  — the card's name, count and power limit; fails without a card.
2. build   — ``nvcc`` builds every kernel of the serving path from
             ``situation_recognition_tpu_torch/csrc`` (prints ``-Xptxas -v``).
3. kernel  — each kernel against its plain PyTorch twin on the card at the
             shapes the serving path gives it, full width (d=2048, 4
             steps): the noun shape B x R=6 with role masks of
             ``synthetic_full`` verbs, the verb shape B x r=1, and a ragged
             B=7; max abs error against the stated tolerance, kernel and
             twin times from CUDA events, and the bound of the work.
4. path    — a full-width ResNet-152 + FCGGNN at bf16 with random weights
             from ``--seed`` and the ``synthetic_full`` vocabulary:
             ``export_inference`` into a temporary directory outside the
             repository, ``load_inference(device="cuda")``, and a
             ``DynamicBatcher`` answering 3 bursts of 8 concurrent argmax
             requests and 1 gt-verb request.  Checks shapes, finite values, the kernel
             launch counts (two propagates per argmax dispatch, one per gt
             dispatch) and agreement with the same weights served through
             the plain masked GGNN path on the card.

Then a ``kernels`` JSON line, the card's ``nvidia-smi`` line, and as the
last line ``{"ok": true, "device": {...}}``.  Any failure exits non-zero
before that line is printed.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

_REPO = os.path.dirname(os.path.abspath(__file__))

# the card's published dense peaks (H100 SXM data sheet, at 700 W)
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

BACKBONE, D, STEPS = "resnet152", 2048, 4
# kernel vs twin: the same bf16 operands with f32 sums of 2048-4096 terms
# in other orders; a last-bit flip of a bf16 intermediate moves h by a few
# bf16 ulp (2^-6 at |h| < 4), so the largest element error is bounded by
# 2^-4 and the mean stays near 0 unless a tile is wrong
KERNEL_MAX_TOL = 2 ** -4
KERNEL_MEAN_TOL = 1e-3
# served logits, folded kernel vs the masked plain path at bf16: the
# kernel's h differs from the masked path's by bf16-class rounding (the
# JAX kernel documents 0.023 over 4 steps), seen through a bf16
# classifier with weights below 1/sqrt(2048)
LOGIT_TOL = 0.1
# rounds of 8 argmax requests + 1 gt-verb request through the batcher
BURSTS = 3
# batch of the kernel phase's noun and verb shapes and of the throughput run
BATCH = 256


def _log(msg: str) -> None:
    print(msg, flush=True)


def _phase(name: str, t0: float) -> None:
    _log(f"[{name}] {time.perf_counter() - t0:.3f} s")


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


def _time_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
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


def _ggnn_params(d: int, gen):
    import torch

    from situation_recognition_tpu_torch.ops.ggnn import GGNNParams

    bound = 1.0 / d ** 0.5
    arrs = []
    for _ in range(7):
        arrs.append((torch.rand(d, d, generator=gen) * 2 - 1) * bound)
        arrs.append((torch.rand(d, generator=gen) * 2 - 1) * bound)
    return GGNNParams(*(a.cuda() for a in arrs))


def _folded_bound(m: int, d: int, r: int, steps: int, mask) -> tuple:
    """Least time (ms) of one folded propagate on the card, and which term
    sets it.  Operations: the three gate products (2·m·d·3d + 2·m·d·2d)
    and the candidate product (2·m·d·d) per step, plus the adjacency sum
    over the nonzero entries of E this input has.  Bytes: h, mask,
    weights and bias read once, h written once."""
    from situation_recognition_tpu_torch.ops.ggnn_kernel import (
        block_adjacency)

    nnz = int((block_adjacency(mask.cpu(), r) != 0).sum())
    flops = steps * (12 * m * d * d + 2 * nnz * d)
    nbytes = m * d * 2 + m * 4 + 6 * d * d * 2 + 3 * d * 4 + m * d * 2
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes", flops, nbytes)


def phase_kernel(enc, seed: int, batch: int) -> dict:
    import torch

    from situation_recognition_tpu_torch.ops import ggnn_kernel as tk

    gen = torch.Generator().manual_seed(seed)
    params = _ggnn_params(D, gen)
    role_mask = torch.as_tensor(enc.role_mask)
    shapes = []
    for label, b, r in (("noun", batch, 6), ("verb", batch, 1),
                        ("ragged", 7, 6)):
        m = b * r
        if r == 1:
            mask = torch.zeros(m)
        else:
            verbs = torch.randint(0, enc.get_num_verbs(), (b,), generator=gen)
            mask = role_mask[verbs].reshape(-1)
        h = torch.randn(m, D, generator=gen).to(torch.bfloat16).cuda()
        mask = mask.cuda()
        weights = tk.fold_gate_weights(params, float(r))
        want = tk.folded_reference(h, mask, weights, r, STEPS)
        got = tk.folded_rows(h, mask, weights, r, STEPS)
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs()
        err, mean_err = diff.max().item(), diff.mean().item()
        same = (got == want).float().mean().item()
        ok = err <= KERNEL_MAX_TOL and mean_err <= KERNEL_MEAN_TOL
        ms = _time_ms(lambda: tk.folded_rows(h, mask, weights, r, STEPS), 20)
        plain_ms = _time_ms(
            lambda: tk.folded_reference(h, mask, weights, r, STEPS), 5, 1)
        bound_ms, bound_by, flops, nbytes = _folded_bound(m, D, r, STEPS,
                                                          mask)
        row = {"shape": f"{label} B={b} R={r} M={m} d={D} steps={STEPS}",
               "max_abs_err": err, "mean_abs_err": mean_err,
               "equal_share": same, "tol_max": KERNEL_MAX_TOL,
               "tol_mean": KERNEL_MEAN_TOL, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": bound_by, "flop": flops,
               "bytes": nbytes, "tflops": flops / ms / 1e9}
        _log("[kernel] " + json.dumps(row))
        if not ok:
            raise SystemExit(f"GGNN kernel disagrees with its twin at "
                             f"{row['shape']}: max {err} mean {mean_err}")
        shapes.append(row)
    return {"shapes": shapes}


def _random_model(enc, seed: int):
    """Full-width ResNet-152 + FCGGNN with random weights from ``seed``;
    the BN running statistics are set from one batch of random windows,
    so eval-mode BN normalises as a trained network's would."""
    import numpy as np
    import torch

    from situation_recognition_tpu_torch.serving import SituationModel

    model = SituationModel(enc, backbone=BACKBONE, hidden=D,
                           dtype=torch.bfloat16)
    gen = torch.Generator().manual_seed(seed)
    model.backbone.reset_parameters(gen)
    model.head.reset_parameters(gen)
    model.cuda()
    images = torch.from_numpy(np.random.default_rng(seed).integers(
        0, 256, (32, 256, 256, 3), dtype=np.uint8)).cuda()
    bns = [m for m in model.backbone.modules()
           if isinstance(m, torch.nn.BatchNorm2d)]
    for bn in bns:
        bn.reset_running_stats()
        bn.momentum = None
    model.backbone.train()
    with torch.no_grad():
        from situation_recognition_tpu_torch.data.transforms import (
            eval_transform)
        model.backbone(eval_transform(images))
    for bn in bns:
        bn.momentum = 0.1
    return model.eval().cpu()


def phase_path(enc, seed: int, batch: int, card: str) -> dict:
    import numpy as np
    import torch

    from situation_recognition_tpu_torch.ops import ggnn_kernel as tk
    from situation_recognition_tpu_torch.server import DynamicBatcher
    from situation_recognition_tpu_torch.serving import (
        export_inference, load_inference)

    _log(f"[path] cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
         f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    n_req = 8
    t = time.perf_counter()
    model = _random_model(enc, seed)
    _phase("path: random weights + BN statistics", t)
    tmp = tempfile.mkdtemp(prefix="srtorch_artifact_")
    try:
        t = time.perf_counter()
        export_inference(model, tmp, batch_size=n_req)
        del model
        fn = load_inference(tmp, device="cuda")
        plain = load_inference(tmp, device="cuda", ggnn_impl="masked")
        _phase("path: export + load", t)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if fn.model.head.ggsnn.impl != "kernel":
        raise SystemExit("the served model did not resolve to the kernel")

    rng = np.random.default_rng(seed + 1)
    images = rng.integers(0, 256, (n_req, 256, 256, 3), dtype=np.uint8)
    gt_verb = int(rng.integers(0, enc.get_num_verbs()))
    # warm-up: cuDNN algorithm choice and the first launches
    fn(images)
    fn.gt(images[:1], np.array([gt_verb]))
    torch.cuda.synchronize()

    batcher = DynamicBatcher(fn, max_batch=n_req, max_wait_ms=20)
    try:
        tk.folded_rows.launches = 0
        walls = []
        for _ in range(BURSTS):
            t0 = time.perf_counter()
            futs = [batcher.submit(img) for img in images]
            gt_fut = batcher.submit_gt(images[0], gt_verb)
            rows = [f.result(timeout=300) for f in futs]
            gt_row = gt_fut.result(timeout=300)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        launches = tk.folded_rows.launches
        stats = dict(batcher.stats)
        lat = batcher.latency_stats()
    finally:
        batcher.close()
    # one gt dispatch (one propagate) per burst, the rest argmax (two each)
    expected = 2 * (stats["dispatches"] - BURSTS) + BURSTS
    _log(f"[path] dispatches={stats['dispatches']} "
         f"ggnn_folded launches={launches} expected={expected}")
    if launches != expected or launches == 0:
        raise SystemExit(f"kernel launches {launches} != {expected}")

    verb_logits = np.stack([r["verb_logits"] for r in rows])
    verb_ids = np.array([r["verb_id"] for r in rows])
    nouns = np.stack([r["noun_logits"] for r in rows])
    gt_nouns = gt_row["noun_logits"]
    if (verb_logits.shape != (n_req, 504) or nouns.shape != (n_req, 6, 2001)
            or gt_nouns.shape != (6, 2001)):
        raise SystemExit(f"bad shapes {verb_logits.shape} {nouns.shape} "
                         f"{gt_nouns.shape}")
    for name, a in (("verb_logits", verb_logits), ("noun_logits", nouns),
                    ("gt_noun_logits", gt_nouns)):
        if not np.isfinite(a).all():
            raise SystemExit(f"{name} has non-finite values")

    pv, pids, pn = (x.cpu().numpy() for x in plain(images))
    pgt = plain.gt(images[:1], np.array([gt_verb]))[0].cpu().numpy()
    verb_err = float(np.abs(verb_logits - pv).max())
    gt_err = float(np.abs(gt_nouns - pgt).max())
    top2 = np.sort(pv, axis=1)[:, -2:]
    decided = (top2[:, 1] - top2[:, 0]) > LOGIT_TOL
    same_verb = verb_ids == pids
    noun_err = (float(np.abs(nouns[same_verb] - pn[same_verb]).max())
                if same_verb.any() else 0.0)
    _log(f"[path] vs masked plain path: verb max|d|={verb_err:.5f} "
         f"noun max|d|={noun_err:.5f} gt-noun max|d|={gt_err:.5f} "
         f"tol={LOGIT_TOL}; verb ids agree on {int(same_verb.sum())}/"
         f"{n_req} ({int(decided.sum())} with top-2 margin > tol)")
    if max(verb_err, noun_err, gt_err) > LOGIT_TOL:
        raise SystemExit("served logits disagree with the plain path")
    if not same_verb[decided].all():
        raise SystemExit("verb ids disagree where the margin is decisive")

    # throughput at the kernel phase's batch, through the served model
    big = torch.from_numpy(rng.integers(0, 256, (batch, 256, 256, 3),
                                        dtype=np.uint8)).cuda()
    with torch.inference_mode():
        fn.model.serve(big)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reps = 3
        for _ in range(reps):
            out = fn.model.serve(big)
        torch.cuda.synchronize()
        per_batch = (time.perf_counter() - t0) / reps
    if not torch.isfinite(out[0]).all():
        raise SystemExit("non-finite logits at the throughput batch")
    result = {"card": card, "requests": BURSTS * (n_req + 1),
              "bursts": BURSTS, "burst_wall_s": walls, "latency_ms": lat,
              "dispatches": stats["dispatches"],
              "batch_ms": per_batch * 1e3, "batch": batch,
              "img_per_s": batch / per_batch,
              "launches": launches, "verb_err": verb_err,
              "noun_err": noun_err, "gt_err": gt_err}
    _log("[path] " + json.dumps(result))
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, _REPO)
    try:
        import torch

        from situation_recognition_tpu_torch.data.encoder import ImsituEncoder
        from situation_recognition_tpu_torch.ops import _build
        from situation_recognition_tpu_torch.ops import ggnn_kernel as tk
    except ImportError as e:
        print(f"chip_smoke: the port is not importable from {_REPO}: {e}",
              file=sys.stderr)
        return 2

    t = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = _nvidia_smi()
    _log(f"[device] {kind} count={count} torch={torch.__version__} "
         f"cuda={torch.version.cuda} nvidia-smi: {smi}")
    _phase("device", t)

    # f32 products in full f32: the twins' bf16-valued operands multiply
    # exactly only without TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    t = time.perf_counter()
    _build.load("ggnn_folded.cu")
    for src, log in _build.build_logs.items():
        _log(f"[build] {src}:\n" + "\n".join(
            line for line in log.splitlines() if line.strip()))
    _phase("build", t)

    enc = ImsituEncoder.synthetic_full(args.seed)
    t = time.perf_counter()
    kernel = phase_kernel(enc, args.seed, BATCH)
    _phase("kernel", t)

    t = time.perf_counter()
    path = phase_path(enc, args.seed, BATCH, smi)
    _phase("path", t)

    head = kernel["shapes"][0]
    print(json.dumps({"kernels": [{
        "name": "ggnn_folded",
        "route": "cuda",
        "source": "situation_recognition_tpu_torch/csrc/ggnn_folded.cu",
        "replaces": "situation_recognition_tpu/ops/ggnn_pallas.py:217",
        "launches": path["launches"],
        "checked": True,
        "max_abs_err": max(s["max_abs_err"] for s in kernel["shapes"]),
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": None,
        "timed_shape": head["shape"],
        "shapes": kernel["shapes"],
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
