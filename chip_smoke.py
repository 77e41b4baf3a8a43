#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card (H100).

    python3 chip_smoke.py [--seed 0]

Phases, each printing its seconds:

1. device  — the card's name, count and power limit; fails without a card.
2. build   — ``nvcc`` builds every kernel of the serving and training paths
             from ``situation_recognition_tpu_torch/csrc``, one process per
             source, all started together (prints ``-Xptxas -v``).
3. kernel  — each kernel against its plain PyTorch twin on the card at the
             shapes the paths give it, full width (d=2048, 4 steps): the
             noun shape B x R=6 with role masks of ``synthetic_full``
             verbs, the verb shape B x r=1, and a ragged B=7; K1 (folded
             forward), K2 (forward with residuals: output and the four
             residual stacks) and K3 (backward: dh and da); max and mean
             abs error against the stated tolerances, kernel and twin times
             from CUDA events, and the bound of the work.  Then the whole
             differentiated propagate (forward + backward, the parameter
             products included) through each route: the K2/K3 autograd
             Function and autograd over the masked-sum math.
4. path    — a full-width ResNet-152 + FCGGNN at bf16 with random weights
             from ``--seed`` and the ``synthetic_full`` vocabulary:
             ``export_inference`` into a temporary directory outside the
             repository, ``load_inference(device="cuda")``, and a
             ``DynamicBatcher`` answering 3 bursts of 8 concurrent argmax
             requests and 1 gt-verb request.  Checks shapes, finite values, the kernel
             launch counts (two propagates per argmax dispatch, one per gt
             dispatch) and agreement with the same weights served through
             the plain masked GGNN path on the card.
5. train   — a full-width ``Trainer`` (ResNet-152, d=2048, bf16, batch 256,
             weights from ``--seed``, BN statistics set from one batch of
             random windows) driven through ``train_epoch`` and
             ``evaluate`` on in-memory batches of synthetic windows with
             verbs and labels from the ``synthetic_full`` tables, once per
             GGNN backward route (``SRTPU_GGNN_BWD=xla`` and ``pallas``)
             from the same starting state and dropout seed: finite losses;
             per-step losses, step-1 gradients and the parameter updates
             agreeing between the routes; launch counts per step (K1 once,
             for the gt branch; K2 and K3 twice each under ``pallas``,
             never under ``xla``) and per eval batch (K1 three times); 8
             finite scores in [0, 100]; training and eval img/s.

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
DEVICE = "cuda"
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
# K3 vs its twin, relative to the largest |element| of the twin's output:
# the same bf16 operands with f32 sums in other orders; a flipped bf16 da
# or dagg element (2^-8 relative) propagates through the reverse steps (the
# twin and the JAX kernel differ by 2^-10 of the largest element at d=128,
# tests/test_torch_ggnn_train.py; sums 16x longer at d=2048 add noise); a
# wrong tile gives errors of the order of the largest element
BWD_MAX_REL = 2 ** -5
BWD_MEAN_REL = 2 ** -10
# the two backward routes in the train phase (bf16 masked-sum autograd,
# whose every product rounds to bf16, vs the kernels' f32 gate chain):
# * the head gradients of one train-step loss with the noun branch's verbs
#   fixed, tensor by tensor (relative Frobenius; the lone propagate's
#   routes differ by 1e-2, kernel phase);
# * per-step losses (relative), and the cosine between the two routes'
#   parameter updates over the steps.  These see more than bf16 rounding:
#   with random weights the verb logits are nearly flat (verb CE ≈ ln 504),
#   so the argmax verb — and with it the noun branch — differs between the
#   routes on some rows, and Adamax moves every element by about lr
#   whatever its gradient's size
ROUTE_GRAD_REL = 5e-2
ROUTE_LOSS_REL = 1e-2
ROUTE_UPDATE_COS = 0.9
# training steps compared between the routes, then timed; eval batches
TRAIN_STEPS, TIMED_STEPS, EVAL_BATCHES = 3, 3, 2
# rounds of 8 argmax requests + 1 gt-verb request through the batcher
BURSTS = 3
# batch of the kernel phase's noun and verb shapes, of the throughput run
# and of the trainer
BATCH = 256
# every kernel source of the serving and training paths
SOURCES = ("ggnn_folded.cu", "ggnn_folded_bwd.cu")


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
    return GGNNParams(*(a.to(DEVICE) for a in arrs))


def _folded_bound(m: int, d: int, r: int, steps: int, mask,
                  residuals: bool = False) -> tuple:
    """Least time (ms) of one folded propagate on the card (K1, or K2 with
    ``residuals``), and which term sets it.  Operations: the three gate
    products (2·m·d·3d + 2·m·d·2d) and the candidate product (2·m·d·d) per
    step, plus the adjacency sum over the nonzero entries of E this input
    has.  Bytes: h, mask, weights and bias read once, h written once, and
    for K2 the four (steps, m, d) bf16 residual stacks written once."""
    from situation_recognition_tpu_torch.ops.ggnn_kernel import (
        block_adjacency)

    nnz = int((block_adjacency(mask.cpu(), r) != 0).sum())
    flops = steps * (12 * m * d * d + 2 * nnz * d)
    nbytes = m * d * 2 + m * 4 + 6 * d * d * 2 + 3 * d * 4 + m * d * 2
    if residuals:
        nbytes += 4 * steps * m * d * 2
    return _bound(flops, nbytes)


def _bwd_bound(m: int, d: int, r: int, steps: int, mask) -> tuple:
    """Least time (ms) of K3 and its term.  Operations per reverse step:
    drh (2·m·d·d), dagg (2·m·3d·d), da[:, :2d]@Uzrᵀ (2·m·2d·d) and the
    adjacency sum over E's nonzeros.  Bytes: g, mask, the four residual
    stacks and the transposed weights read once; dh and da written once."""
    from situation_recognition_tpu_torch.ops.ggnn_kernel import (
        block_adjacency)

    nnz = int((block_adjacency(mask.cpu(), r) != 0).sum())
    flops = steps * (12 * m * d * d + 2 * nnz * d)
    nbytes = (m * d * 2 + m * 4 + 4 * steps * m * d * 2 + 6 * d * d * 2
              + m * d * 2 + steps * m * 3 * d * 2)
    return _bound(flops, nbytes)


def _bound(flops: int, nbytes: int) -> tuple:
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes", flops, nbytes)


def _errors(got, want) -> tuple:
    diff = (got.float() - want.float()).abs()
    return (diff.max().item(), diff.mean().item(),
            (got == want).float().mean().item())


def _shape_cases(enc, gen, batch):
    import torch

    role_mask = torch.as_tensor(enc.role_mask)
    for label, b, r in (("noun", batch, 6), ("verb", batch, 1),
                        ("ragged", 7, 6)):
        m = b * r
        if r == 1:
            mask = torch.zeros(m)
        else:
            verbs = torch.randint(0, enc.get_num_verbs(), (b,), generator=gen)
            mask = role_mask[verbs].reshape(-1)
        h = torch.randn(m, D, generator=gen).to(torch.bfloat16).to(DEVICE)
        yield label, b, r, m, h, mask.to(DEVICE)


def phase_kernel(enc, seed: int, batch: int) -> dict:
    import torch

    from situation_recognition_tpu_torch.ops import ggnn_kernel as tk

    gen = torch.Generator().manual_seed(seed)
    params = _ggnn_params(D, gen)
    shapes, res_shapes, bwd_shapes = [], [], []
    for label, b, r, m, h, mask in _shape_cases(enc, gen, batch):
        tag = f"{label} B={b} R={r} M={m} d={D} steps={STEPS}"
        weights = tk.fold_gate_weights(params, float(r))
        # K1
        want = tk.folded_reference(h, mask, weights, r, STEPS)
        got = tk.folded_rows(h, mask, weights, r, STEPS)
        torch.cuda.synchronize()
        err, mean_err, same = _errors(got, want)
        ok = err <= KERNEL_MAX_TOL and mean_err <= KERNEL_MEAN_TOL
        ms = _time_ms(lambda: tk.folded_rows(h, mask, weights, r, STEPS), 20)
        plain_ms = _time_ms(
            lambda: tk.folded_reference(h, mask, weights, r, STEPS), 5, 1)
        bound_ms, bound_by, flops, nbytes = _folded_bound(m, D, r, STEPS,
                                                          mask)
        row = {"shape": tag, "max_abs_err": err, "mean_abs_err": mean_err,
               "equal_share": same, "tol_max": KERNEL_MAX_TOL,
               "tol_mean": KERNEL_MEAN_TOL, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": bound_by, "flop": flops,
               "bytes": nbytes, "tflops": flops / ms / 1e9}
        _log("[kernel] K1 " + json.dumps(row))
        if not ok:
            raise SystemExit(f"GGNN kernel disagrees with its twin at "
                             f"{row['shape']}: max {err} mean {mean_err}")
        shapes.append(row)

        # K2: the output and each residual stack against the twin's
        want_out, want_res = tk.folded_reference_res(h, mask, weights, r,
                                                     STEPS)
        got_out, got_res = tk.folded_rows_res(h, mask, weights, r, STEPS)
        torch.cuda.synchronize()
        errs = {name: _errors(g, w) for name, g, w in zip(
            ("out", "h", "z", "r", "c"), (got_out,) + got_res,
            (want_out,) + want_res)}
        ms = _time_ms(lambda: tk.folded_rows_res(h, mask, weights, r,
                                                 STEPS), 20)
        plain_ms = _time_ms(
            lambda: tk.folded_reference_res(h, mask, weights, r, STEPS), 5, 1)
        bound_ms, bound_by, flops, nbytes = _folded_bound(
            m, D, r, STEPS, mask, residuals=True)
        row = {"shape": tag,
               "max_abs_err": max(e[0] for e in errs.values()),
               "errors": {k: {"max": e[0], "mean": e[1], "equal_share": e[2]}
                          for k, e in errs.items()},
               "tol_max": KERNEL_MAX_TOL, "tol_mean": KERNEL_MEAN_TOL,
               "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "flop": flops, "bytes": nbytes,
               "tflops": flops / ms / 1e9}
        _log("[kernel] K2 " + json.dumps(row))
        bad = [k for k, e in errs.items()
               if e[0] > KERNEL_MAX_TOL or e[1] > KERNEL_MEAN_TOL]
        if bad:
            raise SystemExit(f"K2 disagrees with its twin at {tag}: {bad}")
        res_shapes.append(row)

        # K3 from K2's residuals, against the twin on the same residuals
        g = torch.randn(m, D, generator=gen).to(torch.bfloat16).to(DEVICE)
        wt = tk.transpose_folded(weights)
        want_dh, want_da = tk.folded_bwd_reference(g, mask, got_res, wt, r,
                                                   STEPS)
        got_dh, got_da = tk.folded_bwd_rows(g, mask, got_res, wt, r, STEPS)
        torch.cuda.synchronize()
        errs = {}
        for name, gt_, wt_ in (("dh", got_dh, want_dh), ("da", got_da,
                                                         want_da)):
            e_max, e_mean, same = _errors(gt_, wt_)
            scale = wt_.float().abs().max().item()
            errs[name] = {"max": e_max, "mean": e_mean, "equal_share": same,
                          "max_rel": e_max / scale,
                          "mean_rel": e_mean / scale, "scale": scale}
        ms = _time_ms(lambda: tk.folded_bwd_rows(g, mask, got_res, wt, r,
                                                 STEPS), 20)
        plain_ms = _time_ms(lambda: tk.folded_bwd_reference(
            g, mask, got_res, wt, r, STEPS), 5, 1)
        bound_ms, bound_by, flops, nbytes = _bwd_bound(m, D, r, STEPS, mask)
        row = {"shape": tag,
               "max_abs_err": max(e["max"] for e in errs.values()),
               "errors": errs, "tol_max_rel": BWD_MAX_REL,
               "tol_mean_rel": BWD_MEAN_REL, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": bound_by, "flop": flops,
               "bytes": nbytes, "tflops": flops / ms / 1e9}
        _log("[kernel] K3 " + json.dumps(row))
        bad = [k for k, e in errs.items()
               if e["max_rel"] > BWD_MAX_REL or e["mean_rel"] > BWD_MEAN_REL]
        if bad:
            raise SystemExit(f"K3 disagrees with its twin at {tag}: {bad}")
        bwd_shapes.append(row)
    routes = [_route_times(params, mask_case)
              for mask_case in _route_cases(enc, gen, batch)]
    return {"shapes": shapes, "res_shapes": res_shapes,
            "bwd_shapes": bwd_shapes, "routes": routes}


def _route_cases(enc, gen, batch):
    for label, b, r, m, h, mask in _shape_cases(enc, gen, batch):
        if label != "ragged":
            yield label, b, r, h.reshape(b, r, D), mask.reshape(b, r)


def _route_times(params, case) -> dict:
    """One differentiated propagate, forward + backward with the parameter
    gradients, through each route at bf16: the K2/K3 Function (the fold
    included, as the JAX route folds inside) and autograd over the
    masked-sum math."""
    import torch

    from situation_recognition_tpu_torch.ops import ggnn as tg
    from situation_recognition_tpu_torch.ops import ggnn_train as tt

    label, b, r, hidden, mask = case
    p = tg.GGNNParams(*(x.to(torch.bfloat16).requires_grad_()
                        for x in params))
    hidden = hidden.detach().requires_grad_()
    w = torch.randn(hidden.shape, device=hidden.device)
    fns = {"pallas": tt.ggnn_propagate_train,
           "xla": tg.ggnn_propagate_verb if r == 1 else tg.ggnn_propagate}

    def run(route):
        if r == 1 and route == "xla":
            out = fns[route](p, hidden[:, 0], STEPS)[:, None]
        else:
            out = fns[route](p, hidden, mask, STEPS)
        return torch.autograd.grad((out.float() * w).sum(), [hidden, *p])

    grads = {k: run(k) for k in fns}
    rel = max(((a.float() - b_.float()).norm()
               / (b_.float().norm() + 1e-12)).item()
              for a, b_ in zip(grads["pallas"], grads["xla"]))
    # turns: xla, pallas, pallas, xla
    times = {"xla": [], "pallas": []}
    for route in ("xla", "pallas", "pallas", "xla"):
        times[route].append(_time_ms(lambda: run(route), 5, 1))
    row = {"shape": f"{label} B={b} R={r} d={D} steps={STEPS}",
           "pallas_ms": min(times["pallas"]), "xla_ms": min(times["xla"]),
           "pallas_ms_runs": times["pallas"], "xla_ms_runs": times["xla"],
           "grad_rel_diff": rel}
    _log("[kernel] routes fwd+bwd " + json.dumps(row))
    return row


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
    model.to(DEVICE)
    images = torch.from_numpy(np.random.default_rng(seed).integers(
        0, 256, (32, 256, 256, 3), dtype=np.uint8)).to(DEVICE)
    from situation_recognition_tpu_torch.data.transforms import (
        eval_transform)
    _set_bn_statistics(model.backbone, eval_transform(images))
    return model.eval().cpu()


def _set_bn_statistics(backbone, x) -> None:
    """Running BN statistics = the batch statistics of ``x`` (one
    train-mode pass with momentum 1), so that eval-mode BN normalises as a
    trained network's would."""
    import torch

    bns = [m for m in backbone.modules()
           if isinstance(m, torch.nn.BatchNorm2d)]
    for bn in bns:
        bn.momentum = 1.0
    backbone.train()
    with torch.no_grad():
        backbone(x)
    for bn in bns:
        bn.momentum = 0.1
    backbone.eval()


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


def _train_batches(enc, seed: int, batch: int, count: int):
    """``count`` host batches of ``batch`` synthetic uint8 windows, verbs
    drawn from the ``synthetic_full`` tables and labels with the ignore
    index outside each verb's roles."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n_labels, roles = enc.get_num_labels(), enc.max_role_count
    out = []
    for _ in range(count):
        verbs = rng.integers(0, enc.get_num_verbs(), batch)
        labels = rng.integers(0, n_labels, (batch, 3, roles))
        real = np.arange(roles)[None, None, :] \
            < enc.role_counts[verbs][:, None, None]
        out.append({"images": rng.integers(0, 256, (batch, 256, 256, 3),
                                           dtype=np.uint8),
                    "flip": rng.random(batch) < 0.5,
                    "verbs": verbs,
                    "labels": np.where(real, labels, n_labels)})
    return out


def _counts() -> dict:
    from situation_recognition_tpu_torch.ops import ggnn_kernel as tk

    return {"K1": tk.folded_rows.launches, "K2": tk.folded_rows_res.launches,
            "K3": tk.folded_bwd_rows.launches}


def _zero_counts() -> None:
    from situation_recognition_tpu_torch.ops import ggnn_kernel as tk

    tk.folded_rows.launches = 0
    tk.folded_rows_res.launches = 0
    tk.folded_bwd_rows.launches = 0


def _fixed_verb_grads(trainer, batch) -> dict:
    """The head gradients of one train-step loss under each route, with
    the noun branch run on the verbs the xla route's verb branch picks, so
    that the two routes differentiate the same function; and the share of
    rows whose argmax verb the two routes agree on."""
    import os

    import torch

    from situation_recognition_tpu_torch.models.fcggnn import (
        nouns_loss_masked, verb_loss_masked)

    (images, flip, verbs, labels, valid), _ = trainer._upload(batch)
    feats = trainer._features(images, flip, False)
    head, n_labels = trainer.head, trainer.encoder.get_num_labels()
    grads, picks, ids = {}, {}, None
    for route in ("xla", "pallas"):
        os.environ["SRTPU_GGNN_BWD"] = route
        head.zero_grad(set_to_none=True)
        gen = trainer._generator(0)
        pv = head.predict_verb(feats, train=True, generator=gen)
        picks[route] = torch.argmax(pv, dim=1)
        ids = picks["xla"] if ids is None else ids
        pn = head.predict_nouns(feats, ids, trainer.role_ids,
                                trainer.role_mask, train=True, generator=gen)
        (verb_loss_masked(pv, verbs, valid)
         + nouns_loss_masked(pn, labels, n_labels, valid)).backward()
        grads[route] = {n: p.grad.detach().float().clone()
                        for n, p in head.named_parameters()}
    head.zero_grad(set_to_none=True)
    rel = {n: ((grads["pallas"][n] - g).norm() / (g.norm() + 1e-30)).item()
           for n, g in grads["xla"].items()}
    agree = (picks["xla"] == picks["pallas"]).float().mean().item()
    return {"grad_rel": rel, "verb_argmax_agree": agree}


def _profile(label: str, fn) -> list:
    """Device time of ``fn()`` by kernel name (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        # kernels and copies only: an operator's device time is that of
        # the kernels it launched, which are listed too
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        if dev_us > 0:
            rows.append((dev_us / 1e3, ev.count, ev.key[:90]))
    rows.sort(reverse=True)
    total = sum(r[0] for r in rows)
    _log(f"[train] profile of {label}: device time {total:.3f} ms over "
         f"{len(rows)} kernel names; top 15:")
    for ms, count, key in rows[:15]:
        _log(f"[train]   {ms:9.3f} ms  x{count:<5d} {key}")
    return {"device_ms": total,
            "top": [{"ms": ms, "count": c, "kernel": k}
                    for ms, c, k in rows[:25]]}


def phase_train(enc, seed: int, batch: int) -> dict:
    """The training path, once per GGNN backward route, from one starting
    state (see the module docstring)."""
    import copy
    import os

    import numpy as np
    import torch

    from situation_recognition_tpu_torch.train import Trainer, TrainerConfig

    t = time.perf_counter()
    trainer = Trainer(enc, TrainerConfig(
        hidden=D, batch_size=batch, backbone=BACKBONE,
        compute_dtype=torch.bfloat16, seed=seed), device=DEVICE)
    if trainer.head.ggsnn.impl != "kernel":
        raise SystemExit("the trainer did not resolve to the GGNN kernels")
    batches = _train_batches(enc, seed + 2, batch, 3)
    from situation_recognition_tpu_torch.data.transforms import (
        eval_transform)
    _set_bn_statistics(trainer.backbone, eval_transform(
        torch.from_numpy(batches[0]["images"][:64]).to(DEVICE),
        dtype=torch.bfloat16))
    start = {"head": copy.deepcopy(trainer.head.state_dict()),
             "backbone": copy.deepcopy(trainer.backbone.state_dict())}
    _phase("train: trainer + BN statistics", t)

    def launches(before):
        now = _counts()
        return {k: now[k] - before[k] for k in now}

    result = {"card": None, "batch": batch, "routes": {}}
    runs = {}
    old_env = os.environ.get("SRTPU_GGNN_BWD")
    try:
        fixed = _fixed_verb_grads(trainer, batches[0])
        _log("[train] fixed-verb gradients " + json.dumps(fixed))
        result["fixed_verb"] = fixed
        for route in ("xla", "pallas"):
            os.environ["SRTPU_GGNN_BWD"] = route
            trainer.head.load_state_dict(start["head"])
            trainer.backbone.load_state_dict(start["backbone"])
            trainer.optimizer = torch.optim.Adamax(
                trainer.head.parameters(), lr=trainer.config.lr)
            trainer.step_count = trainer.opt_steps = 0
            losses, per_step = [], []
            for i in range(TRAIN_STEPS):
                torch.cuda.synchronize()
                before = _counts()
                _, _, step_losses = trainer.train_epoch([batches[i % 3]], i)
                torch.cuda.synchronize()
                per_step.append(launches(before))
                losses.append(list(step_losses))
            params = [p.detach().float().clone()
                      for p in trainer.head.parameters()]
            # throughput: more steps, host clock around synchronised work
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.train_epoch([batches[i % 3] for i in range(TIMED_STEPS)],
                                TRAIN_STEPS)
            torch.cuda.synchronize()
            train_s = (time.perf_counter() - t0) / TIMED_STEPS
            profile = {"train_step": _profile(
                f"one {route} train step",
                lambda: trainer.train_epoch([batches[0]], TRAIN_STEPS + 1))}
            eval_loader = batches[:EVAL_BATCHES]
            before = _counts()
            top1, top5, val_losses, avg = trainer.evaluate(eval_loader,
                                                           logging=True)
            torch.cuda.synchronize()
            eval_launches = launches(before)
            t0 = time.perf_counter()
            trainer.evaluate(eval_loader)
            torch.cuda.synchronize()
            eval_s = (time.perf_counter() - t0) / EVAL_BATCHES
            profile["eval_batch"] = _profile(
                "one eval batch", lambda: trainer.evaluate(batches[:1]))
            scores = [100 * v for v in (
                list(top1.get_average_results_both().values())
                + list(top5.get_average_results_both().values()))]
            runs[route] = {"losses": losses, "params": params}
            row = {"per_step_launches": per_step,
                   "eval_launches": eval_launches,
                   "losses": losses, "val_losses": val_losses,
                   "scores": scores, "mean_of_eight": avg,
                   "train_step_ms": train_s * 1e3,
                   "train_img_per_s": batch / train_s,
                   "eval_batch_ms": eval_s * 1e3,
                   "eval_img_per_s": batch / eval_s,
                   "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                   "profile": profile}
            _log(f"[train] {route} " + json.dumps(row))
            result["routes"][route] = row
            if not np.isfinite(np.asarray(losses)).all() or not all(
                    np.isfinite(v) for v in val_losses.values()):
                raise SystemExit(f"non-finite losses under {route}")
            if len(scores) != 8 or not all(0 <= v <= 100 for v in scores):
                raise SystemExit(f"bad scores under {route}: {scores}")
            want = {"K1": 1, "K2": 2 if route == "pallas" else 0,
                    "K3": 2 if route == "pallas" else 0}
            if any(c != want for c in per_step):
                raise SystemExit(f"launches per train step under {route}: "
                                 f"{per_step}, want {want}")
            if eval_launches != {"K1": 3 * EVAL_BATCHES, "K2": 0, "K3": 0}:
                raise SystemExit(f"launches over {EVAL_BATCHES} eval batches"
                                 f" under {route}: {eval_launches}")
    finally:
        if old_env is None:
            os.environ.pop("SRTPU_GGNN_BWD", None)
        else:
            os.environ["SRTPU_GGNN_BWD"] = old_env

    # the two routes from the same state, batches and dropout seeds
    x, k = runs["xla"], runs["pallas"]
    loss_rel = float(np.max(np.abs(np.asarray(k["losses"])
                                   - np.asarray(x["losses"]))
                            / np.abs(np.asarray(x["losses"]))))
    grad_rel = max(result["fixed_verb"]["grad_rel"].values())
    init = [v.float().to(DEVICE).flatten() for v in start["head"].values()]
    ux = torch.cat([p.flatten() for p in x["params"]]) - torch.cat(init)
    uk = torch.cat([p.flatten() for p in k["params"]]) - torch.cat(init)
    cos = (torch.dot(ux, uk) / (ux.norm() * uk.norm())).item()
    result["route_agreement"] = {
        "loss_rel": loss_rel, "tol_loss_rel": ROUTE_LOSS_REL,
        "grad_rel": grad_rel, "tol_grad_rel": ROUTE_GRAD_REL,
        "update_cos": cos, "tol_update_cos": ROUTE_UPDATE_COS,
        "update_rel": ((uk - ux).norm() / ux.norm()).item()}
    _log("[train] routes " + json.dumps(result["route_agreement"]))
    if (loss_rel > ROUTE_LOSS_REL or grad_rel > ROUTE_GRAD_REL
            or cos < ROUTE_UPDATE_COS):
        raise SystemExit("the two GGNN backward routes disagree")
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
    _build.build(SOURCES)
    for src in SOURCES:
        _build.load(src)
        _log(f"[build] {src}:\n" + "\n".join(
            line for line in _build.build_logs.get(src, "").splitlines()
            if line.strip()))
    _phase("build", t)

    enc = ImsituEncoder.synthetic_full(args.seed)
    t = time.perf_counter()
    kernel = phase_kernel(enc, args.seed, BATCH)
    _phase("kernel", t)

    t = time.perf_counter()
    path = phase_path(enc, args.seed, BATCH, smi)
    _phase("path", t)
    torch.cuda.empty_cache()

    t = time.perf_counter()
    _zero_counts()
    train = phase_train(enc, args.seed, BATCH)
    train_launches = _counts()
    train["card"] = smi
    _phase("train", t)

    if not all(train_launches.values()):
        raise SystemExit(f"a kernel of the training path never launched: "
                         f"{train_launches}")
    print(json.dumps({"kernels": [
        _kernel_line("ggnn_folded", "ggnn_folded.cu", 217, kernel["shapes"],
                     {"serve": path["launches"],
                      "train": train_launches["K1"]}),
        _kernel_line("ggnn_folded_res", "ggnn_folded.cu", 492,
                     kernel["res_shapes"], {"train": train_launches["K2"]}),
        _kernel_line("ggnn_folded_bwd", "ggnn_folded_bwd.cu", 521,
                     kernel["bwd_shapes"], {"train": train_launches["K3"]},
                     routes=kernel["routes"]),
    ]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": kind,
                                             "count": count}}), flush=True)
    return 0


def _kernel_line(name, source, line, shapes, launches, **extra) -> dict:
    """One entry of the ``kernels`` line, timed at the noun shape."""
    head = shapes[0]
    return {"name": name, "route": "cuda",
            "source": f"situation_recognition_tpu_torch/csrc/{source}",
            "replaces": f"situation_recognition_tpu/ops/ggnn_pallas.py:{line}",
            "launches": sum(launches.values()),
            "launches_by_path": launches, "checked": True,
            "max_abs_err": max(s["max_abs_err"] for s in shapes),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": None, "timed_shape": head["shape"],
            "shapes": shapes, **extra}


if __name__ == "__main__":
    sys.exit(main())
