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
             from CUDA events, and the bound of the work; for each also
             its tiles and, as a yardstick the port never calls, cuBLAS
             (``torch.matmul``) on the same steps' products alone.  K3
             also at d=1024 (the ViT head's noun and verb shapes), with
             the route's parameter products on the tensor cores against
             f32 products of f32 copies (checked, both timed, TF32 off),
             and after the last phase its device time by launch kind
             (``torch.profiler``: drh, dagg, E, dh, prep).  Then the
             whole differentiated propagate (forward + backward, the
             parameter products included) through each route: the K2/K3
             autograd Function and autograd over the masked-sum math.
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
6. vit     — ViT-L/14 + FCGGNN(1024) at full width (224², 257 tokens, 24
             blocks, 16 heads, bf16, batch 256, random weights from
             ``--seed``).  Kernels: K4 (qkv), K6 (out-MLP, both GELUs),
             each of their four GEMMs alone (qkv, out-projection, fc1,
             fc2) with its TFLOP/s beside ``torch.nn.functional.linear``
             (cuBLAS) on the same operands, and
             the attention kernel as K7 and K5 (257-row stride, as the
             paths call them; K7 also at the TPU stream's 264-row stride,
             pad rows exactly zero; K5 also at 577 tokens, ViT-L/14 at
             336²), both softmax flavours, each against its twin with
             CUDA-event times, bounds, and SDPA on the same tensors as the
             attention's yardstick.
             Path: an artifact exported and loaded as in ``path``, batch 256
             through the stream stack and through the per-block path
             (``SRTPU_VIT_STREAM=0``) against the plain path on the card,
             batch timing, a profile, and the batcher's bursts; then a
             frozen-backbone ``Trainer``: train steps, a profile of one,
             and an eval batch.
             Fails unless K1, K4, K5, K6 and K7 launched there, as many
             times as the paths call them.  The kernel part also holds K8
             (the attention backward) against its twin at the stream's
             shape (257-row stride) and at the 264-row stride with pad
             rows, timed beside its bound and the backward of SDPA on the
             same (B, h, N, 64) tensors.
7. vit ft  — fine-tuning.  First the ft stack on the card: 2 blocks at
             ViT-L/14 width, batch 16, its gradients (K7 forward, K8
             backward, torch products) against autograd over the plain
             blocks, per tensor.  Then a ``Trainer`` with
             ``train_backbone`` and ``remat_backbone`` (ViT-L/14 +
             FCGGNN(1024), bf16, batch 256, weights from ``--seed``): a
             warm step, 2 timed steps with their launches (K7 48, K8 24, K1
             1, K4/K6 0 per step), a profile of one step, the backbone
             parameters that moved, peak memory, then an eval batch
             through the forward kernels.

Then a ``kernels`` JSON line (the entries of K1–K3 and of the ViT kernels
with the registers, spills and shared memory that ``-Xptxas -v``
reported, and for the GEMMs of K1–K3 and K4/K6 the ``setmaxnreg`` split,
the dynamic shared memory that the library states and the HGMMA count of
each instantiation's SASS; a GEMM without HGMMA, or a K1–K3 kernel that
spills, fails the run), the
card's ``nvidia-smi`` line, and as the last line ``{"ok": true, "device":
{...}}``.  Any failure exits non-zero
before that line is printed.
"""

from __future__ import annotations

import argparse
import json
import os
import re
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
# every kernel source of the serving and training paths, ResNet and ViT
SOURCES = ("ggnn_folded.cu", "ggnn_folded_bwd.cu", "vit_block.cu",
           "vit_attention.cu", "vit_attention_bwd.cu")


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


def _sms() -> int:
    import torch

    return torch.cuda.get_device_properties(0).multi_processor_count


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


def _folded_library_ms(h, weights) -> float:
    """cuBLAS (``torch.matmul``) time of the products of ``STEPS`` folded
    steps on the same shapes and folded weights: per step h @ wa, h @ uzr
    and h @ uh (h standing in for agg and r*h), 12·M·d² FLOP as K1's.  No
    PyTorch call computes a folded propagate: this times its products
    alone, a yardstick the port never calls."""
    import torch

    wa, uzr, uh, _ = weights

    def products():
        for _ in range(STEPS):
            torch.matmul(h, wa)
            torch.matmul(h, uzr)
            torch.matmul(h, uh)

    return _time_ms(products, 10)


def _bwd_bound(m: int, d: int, r: int, steps: int, mask) -> tuple:
    """Least time (ms) of K3 and its term.  Operations per reverse step:
    drh (2·m·d·d), dagg (2·m·3d·d), da[:, :2d]@Uzrᵀ (2·m·2d·d) and the
    adjacency sum over E's nonzeros.  Bytes: g, mask, the four residual
    stacks and the folded weights read once; dh and da written once."""
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


def _shape_cases(enc, gen, batch, d=None, ragged=True):
    import torch

    d = D if d is None else d
    role_mask = torch.as_tensor(enc.role_mask)
    cases = [("noun", batch, 6), ("verb", batch, 1)]
    if ragged:
        cases.append(("ragged", 7, 6))
    for label, b, r in cases:
        m = b * r
        if r == 1:
            mask = torch.zeros(m)
        else:
            verbs = torch.randint(0, enc.get_num_verbs(), (b,), generator=gen)
            mask = role_mask[verbs].reshape(-1)
        h = torch.randn(m, d, generator=gen).to(torch.bfloat16).to(DEVICE)
        yield label, b, r, m, h, mask.to(DEVICE)


def phase_kernel(enc, seed: int, batch: int) -> dict:
    import torch

    from situation_recognition_tpu_torch.ops import ggnn_kernel as tk

    gen = torch.Generator().manual_seed(seed)
    params = _ggnn_params(D, gen)
    shapes, res_shapes, k3_rows = [], [], []
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
        library_ms = _folded_library_ms(h, weights)
        row = {"shape": tag, "max_abs_err": err, "mean_abs_err": mean_err,
               "equal_share": same, "tol_max": KERNEL_MAX_TOL,
               "tol_mean": KERNEL_MEAN_TOL, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": library_ms, "flop": flops, "bytes": nbytes,
               "tflops": flops / ms / 1e9,
               "tiles": tk.tile_plan(m, D, _sms())._asdict()}
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
               "bound_by": bound_by, "library_ms": library_ms,
               "flop": flops, "bytes": nbytes, "tflops": flops / ms / 1e9}
        _log("[kernel] K2 " + json.dumps(row))
        bad = [k for k, e in errs.items()
               if e[0] > KERNEL_MAX_TOL or e[1] > KERNEL_MEAN_TOL]
        if bad:
            raise SystemExit(f"K2 disagrees with its twin at {tag}: {bad}")
        res_shapes.append(row)

        # K3 from K2's residuals, against the twin on the same residuals
        k3_rows.append(_k3_row(tag, m, D, r, mask, weights, got_res, gen))
    # K3 at the ViT head's width, noun and verb
    params_1024 = _ggnn_params(1024, gen)
    for label, b, r, m, h, mask in _shape_cases(enc, gen, batch, 1024,
                                                ragged=False):
        weights = tk.fold_gate_weights(params_1024, float(r))
        _, res = tk.folded_rows_res(h, mask, weights, r, STEPS)
        k3_rows.append(_k3_row(
            f"{label} B={b} R={r} M={m} d=1024 steps={STEPS}", m, 1024, r,
            mask, weights, res, gen))
    routes = [_route_times(params, mask_case)
              for mask_case in _route_cases(enc, gen, batch)]
    return {"shapes": shapes, "res_shapes": res_shapes,
            "bwd_shapes": [row for row, _ in k3_rows],
            "k3_inputs": k3_rows, "routes": routes}


# the route's parameter products on the tensor cores vs f32 products of
# f32 copies: the same exact products of bf16 values, f32 sums of steps·M
# terms in another order, relative to each tensor's largest element
PARAM_PRODUCTS_REL = 1e-4
# K3's GEMMs by the KIND of ggnn_gemm_kernel (csrc/ggnn_folded_bwd.cu)
BWD_KINDS = {2: "drh", 3: "dagg", 4: "dh"}


def _k3_row(tag, m: int, d: int, r: int, mask, weights, res, gen):
    """K3 on the residuals ``res`` against its twin on the same residuals
    (dh and da, relative to the twin's largest element), timed, with its
    bound, its tiles, cuBLAS of its products alone and the route's
    parameter products under both products; fails if K3 disagrees.
    Returns the row and K3's inputs copied to the host, with which
    ``_k3_split`` profiles K3 by launch kind after the other phases'
    profiles: a profiler session that recorded no host copy left the later
    sessions of the process without their copies, and inputs kept on the
    card would count in the later phases' peak memory."""
    import torch

    from situation_recognition_tpu_torch.ops import ggnn_kernel as tk

    g = torch.randn(m, d, generator=gen).to(torch.bfloat16).to(DEVICE)
    want_dh, want_da = tk.folded_bwd_reference(g, mask, res, weights, r,
                                               STEPS)
    got_dh, got_da = tk.folded_bwd_rows(g, mask, res, weights, r, STEPS)
    torch.cuda.synchronize()
    errs = {}
    for name, gt_, wt_ in (("dh", got_dh, want_dh), ("da", got_da, want_da)):
        e_max, e_mean, same = _errors(gt_, wt_)
        scale = wt_.float().abs().max().item()
        errs[name] = {"max": e_max, "mean": e_mean, "equal_share": same,
                      "max_rel": e_max / scale, "mean_rel": e_mean / scale,
                      "scale": scale}
    bad = [k for k, e in errs.items()
           if e["max_rel"] > BWD_MAX_REL or e["mean_rel"] > BWD_MEAN_REL]
    if bad:
        raise SystemExit(f"K3 disagrees with its twin at {tag}: {bad} "
                         f"{json.dumps(errs)}")

    def call():
        return tk.folded_bwd_rows(g, mask, res, weights, r, STEPS)

    ms = _time_ms(call, 20)
    plain_ms = _time_ms(lambda: tk.folded_bwd_reference(
        g, mask, res, weights, r, STEPS), 5, 1)
    bound_ms, bound_by, flops, nbytes = _bwd_bound(m, d, r, STEPS, mask)
    row = {"shape": tag,
           "max_abs_err": max(e["max"] for e in errs.values()),
           "errors": errs, "tol_max_rel": BWD_MAX_REL,
           "tol_mean_rel": BWD_MEAN_REL, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "library_ms": _bwd_library_ms(got_da, weights), "flop": flops,
           "bytes": nbytes, "tflops": flops / ms / 1e9,
           "tiles": tk.bwd_tile_plan(m, d, _sms())._asdict(),
           "param_products": _param_products_row(mask, res, got_da, r)}
    _log("[kernel] K3 " + json.dumps(row))
    return row, (g.cpu(), mask.cpu(), tuple(x.cpu() for x in res),
                 tuple(w.cpu() for w in weights), r)


def _k3_split(row: dict, host_inputs) -> None:
    """``row``'s device time of K3 by launch kind (``_bwd_split``), on its
    inputs moved back to the card from ``_k3_row``'s host copies."""
    from situation_recognition_tpu_torch.ops import ggnn_kernel as tk

    g, mask, res, weights, r = host_inputs
    g, mask = g.to(DEVICE), mask.to(DEVICE)
    res = tuple(x.to(DEVICE) for x in res)
    weights = tuple(w.to(DEVICE) for w in weights)
    row["device_ms_by_launch_kind"] = _bwd_split(
        lambda: tk.folded_bwd_rows(g, mask, res, weights, r, STEPS))
    _log(f"[kernel] K3 device time by launch kind, {row['shape']}: "
         + json.dumps(row["device_ms_by_launch_kind"]))


def _bwd_library_ms(da, weights) -> float:
    """cuBLAS (``torch.matmul``) time of K3's products alone over
    ``STEPS`` reverse steps, on one step's da and the folded weights: per
    step da[:, 2d:] @ uhᵀ, da @ waᵀ and da[:, :2d] @ uzrᵀ, 12·M·d² FLOP as
    K3's.  No PyTorch call computes K3: a yardstick the port never
    calls."""
    import torch

    wa, uzr, uh, _ = weights
    d = uh.shape[0]
    x = da[0]

    def products():
        for _ in range(STEPS):
            torch.matmul(x[:, 2 * d:], uh.t())
            torch.matmul(x, wa.t())
            torch.matmul(x[:, :2 * d], uzr.t())

    return _time_ms(products, 10)


def _bwd_split(call, reps: int = 5) -> dict:
    """Device time (ms) of one K3 call by launch kind, from
    ``torch.profiler`` over ``reps`` calls after a warm one: for its three
    GEMMs (drh, dagg, dh), the E kernel and the prep pass before the first
    reverse step, the mean time of the launches recorded times the
    launches of a call (``STEPS`` of each, one prep); and the launches of
    each kind the profiler recorded (it drops some at the start of a
    window: a one-element kernel leads the window, yet one prep of five
    went missing on the card)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    kinds = ("drh", "dagg", "E", "dh", "prep")
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.ones(1, device=DEVICE).add_(1)
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
    total = {k: 0.0 for k in kinds}
    seen = {k: 0 for k in kinds}
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        gemm = re.search(r"ggnn_gemm_kernel(?:<|ILi)(\d+)", ev.key)
        if gemm:
            kind = BWD_KINDS[int(gemm.group(1))]
        elif "ggnn_bwd_agg_kernel" in ev.key:
            kind = "E"
        elif "ggnn_bwd_prep_kernel" in ev.key:
            kind = "prep"
        else:
            continue
        total[kind] += getattr(ev, "self_device_time_total", getattr(
            ev, "self_cuda_time_total", 0)) / 1e3
        seen[kind] += ev.count
    out = {k: total[k] / max(seen[k], 1) * (1 if k == "prep" else STEPS)
           for k in kinds}
    return {**out, "recorded_launches": seen, "calls": reps}


def _param_products_row(mask, res, da, r: int) -> dict:
    """The route's parameter products (``ops/ggnn_train.param_products``:
    bf16 operands, f32 accumulation and output) against f32 products of
    f32 copies (``param_products_f32``, the plain version, which the CPU
    path runs) on the same operands from K2's
    residuals and K3's da: both timed, the largest error relative to each
    tensor's largest element; fails beyond ``PARAM_PRODUCTS_REL`` or if
    TF32 is on.  Also the whole ``param_grads`` (operands, products,
    bias sum and the pull-back through the fold)."""
    import torch

    from situation_recognition_tpu_torch.ops import ggnn as tg
    from situation_recognition_tpu_torch.ops import ggnn_train as tt

    ops = tt.param_operands(mask, res, da, r)
    got = tt.param_products(*ops)
    want = tt.param_products_f32(*ops)
    torch.cuda.synchronize()
    rel = max(((a - w).abs().max() / w.abs().max()).item()
              for a, w in zip(got, want))
    if torch.backends.cuda.matmul.allow_tf32:
        raise SystemExit("TF32 is on after the parameter products")
    if rel > PARAM_PRODUCTS_REL:
        raise SystemExit(f"the parameter products disagree with f32: {rel}")
    k, d = ops[1].shape
    params = _ggnn_params(d, torch.Generator().manual_seed(0))
    params = tg.GGNNParams(*(p.to(torch.bfloat16) for p in params))
    row = {"max_rel": rel, "tol_max_rel": PARAM_PRODUCTS_REL,
           "ms": _time_ms(lambda: tt.param_products(*ops), 10),
           "f32_ms": _time_ms(lambda: tt.param_products_f32(*ops), 5, 1),
           "param_grads_ms": _time_ms(lambda: tt.param_grads(
               params, mask, res, da, r), 5, 1),
           "flop": 12 * k * d * d}
    row["tflops"] = row["flop"] / row["ms"] / 1e9
    return row


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


def _logit_errors(got, want) -> dict:
    """Max abs differences of verb logits, and of noun logits where the
    two argmax verbs agree, and whether the verb ids agree wherever the
    plain path's top-2 margin exceeds ``LOGIT_TOL``."""
    (vl, vi, nl), (pv, pi, pn) = got, want
    same = vi == pi
    top2 = pv.float().topk(2, dim=1).values
    decided = (top2[:, 0] - top2[:, 1]) > LOGIT_TOL
    return {"verb": (vl - pv).abs().max().item(),
            "noun": (nl[same] - pn[same]).abs().max().item()
            if same.any() else 0.0,
            "verb_ids_agree": same.float().mean().item(),
            "verb_ids_agree_where_decided": bool(same[decided].all()),
            "tol": LOGIT_TOL}


def _serve_bursts(fn, images, gt_verb: int) -> dict:
    """``BURSTS`` rounds of one argmax request per image and one gt-verb
    request through a ``DynamicBatcher`` over ``fn``: the last round's
    answers, the wall time of each round, the batcher's statistics."""
    import torch

    from situation_recognition_tpu_torch.server import DynamicBatcher

    batcher = DynamicBatcher(fn, max_batch=len(images), max_wait_ms=20)
    try:
        walls = []
        for _ in range(BURSTS):
            t0 = time.perf_counter()
            futs = [batcher.submit(img) for img in images]
            gt_fut = batcher.submit_gt(images[0], gt_verb)
            rows = [f.result(timeout=300) for f in futs]
            gt_row = gt_fut.result(timeout=300)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        return {"rows": rows, "gt_row": gt_row, "walls": walls,
                "stats": dict(batcher.stats),
                "latency": batcher.latency_stats()}
    finally:
        batcher.close()


def _check_bursts(bursts: dict, plain, images, gt_verb: int,
                  tag: str) -> tuple:
    """Shapes and finite values of the batcher's answers, and their
    agreement with ``plain`` (the same weights on the plain paths) within
    ``LOGIT_TOL``; verb ids must agree where the plain top-2 margin is
    decisive.  Returns the verb, noun and gt-noun max abs differences."""
    import numpy as np
    import torch

    n_req = len(images)
    rows, gt_row = bursts["rows"], bursts["gt_row"]
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

    errs = _logit_errors(
        tuple(torch.from_numpy(a) for a in (verb_logits, verb_ids, nouns)),
        tuple(x.cpu() for x in plain(images)))
    pgt = plain.gt(images[:1], np.array([gt_verb]))[0].cpu().numpy()
    gt_err = float(np.abs(gt_nouns - pgt).max())
    _log(f"[{tag}] vs the plain path: verb max|d|={errs['verb']:.5f} "
         f"noun max|d|={errs['noun']:.5f} gt-noun max|d|={gt_err:.5f} "
         f"tol={LOGIT_TOL}; verb ids agree on "
         f"{errs['verb_ids_agree'] * n_req:.0f}/{n_req}")
    if max(errs["verb"], errs["noun"], gt_err) > LOGIT_TOL:
        raise SystemExit("served logits disagree with the plain path")
    if not errs["verb_ids_agree_where_decided"]:
        raise SystemExit("verb ids disagree where the margin is decisive")
    return errs["verb"], errs["noun"], gt_err


def phase_path(enc, seed: int, batch: int, card: str) -> dict:
    import numpy as np
    import torch

    from situation_recognition_tpu_torch.ops import ggnn_kernel as tk
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

    tk.folded_rows.launches = 0
    bursts = _serve_bursts(fn, images, gt_verb)
    launches = tk.folded_rows.launches
    stats, lat, walls = bursts["stats"], bursts["latency"], bursts["walls"]
    # one gt dispatch (one propagate) per burst, the rest argmax (two each)
    expected = 2 * (stats["dispatches"] - BURSTS) + BURSTS
    _log(f"[path] dispatches={stats['dispatches']} "
         f"ggnn_folded launches={launches} expected={expected}")
    if launches != expected or launches == 0:
        raise SystemExit(f"kernel launches {launches} != {expected}")
    verb_err, noun_err, gt_err = _check_bursts(bursts, plain, images,
                                               gt_verb, "path")

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


def _profile(label: str, fn, tag: str = "train") -> dict:
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
    _log(f"[{tag}] profile of {label}: device time {total:.3f} ms over "
         f"{len(rows)} kernel names; top 15:")
    for ms, count, key in rows[:15]:
        _log(f"[{tag}]   {ms:9.3f} ms  x{count:<5d} {key}")
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
            trainer.optimizer.state.clear()
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


# ----------------------------------------------------------------- the ViT

VIT, VIT_D, VIT_HEADS, VIT_DEPTH, VIT_IMAGE = "vit_l14", 1024, 16, 24, 224
VIT_N = (VIT_IMAGE // 14) ** 2 + 1            # 257 tokens
# 264: the rows per example of the TPU's padded stream, a layout K7 takes
VIT_N8 = -(-VIT_N // 8) * 8
# the attention at ViT-L/14 at 336² (577 tokens), at a quarter batch
VIT_LONG_N, VIT_LONG_BATCH = (336 // 14) ** 2 + 1, 64
# the ViT kernels vs their twins, relative to the largest |element| of the
# twin's output: the same bf16 operands with f32 sums in other orders flip
# the last bit of a bf16 output now and then (2^-7 of its size at most) —
# in q/k/v, in the bf16 probabilities or GELU values feeding the next
# product; a wrong tile moves elements by the order of the largest one and
# the mean error with it
VIT_MAX_REL = 2 ** -6
VIT_MEAN_REL = 2 ** -10
# train steps (the first warms the trainer) and eval batches of the ViT
VIT_TRAIN_STEPS, VIT_EVAL_BATCHES = 2, 1
# K8 vs its twin, relative to each gradient's largest |element|: the same
# bf16 casts (e, ds, do·inv) of f32 values summed in other orders; a
# last-bit flip of one feeds the sums (K3's class, the other backward)
K8_MAX_REL = 2 ** -5
K8_MEAN_REL = 2 ** -10
# the ft stack vs autograd over the plain blocks, both bf16, relative to
# each gradient's largest element: the bounds of the JAX package's test of
# its ft stream (tests/test_vit_pallas.py) — x 0.03, the weights 0.08 over
# two blocks and a squared loss, and the key bias (true gradient zero)
# absolutely within 1e-2 of the largest weight gradient
FT_X_REL, FT_W_REL, FT_BK_ABS = 0.03, 0.08, 1e-2
FT_STACK_BATCH, FT_STACK_DEPTH = 16, 2
# fine-tuning steps timed after a warm one
VIT_FT_STEPS = 2


def _vit_counts() -> dict:
    from situation_recognition_tpu_torch.ops import ggnn_kernel as tk
    from situation_recognition_tpu_torch.ops import vit_kernel as vk

    return {"K1": tk.folded_rows.launches,
            "K4": vk.vit_qkv_forward.launches,
            "K5": vk.vit_attention_forward.launches,
            "K6": vk.vit_out_mlp_forward.launches,
            "K7": vk.vit_attention_stream_forward.launches,
            "K8": vk.vit_attention_backward.launches}


def _zero_vit_counts() -> None:
    from situation_recognition_tpu_torch.ops import ggnn_kernel as tk
    from situation_recognition_tpu_torch.ops import vit_kernel as vk

    tk.folded_rows.launches = 0
    for w in (vk.vit_qkv_forward, vk.vit_attention_forward,
              vk.vit_out_mlp_forward, vk.vit_attention_stream_forward,
              vk.vit_attention_backward):
        w.launches = 0


def _attention_resources() -> dict:
    """Registers, spills and stack frame per thread and static shared
    memory of the attention kernels as ``nvcc -Xptxas -v`` reported them,
    with the dynamic shared memory a block takes: by source, by kernel."""
    from situation_recognition_tpu_torch.ops import _build

    fwd = _build.load("vit_attention.cu")
    bwd = _build.load("vit_attention_bwd.cu")
    out = {"vit_attention.cu": {}, "vit_attention_bwd.cu": {}}
    for src, kern in (("vit_attention.cu", "attn_kernel"),
                      ("vit_attention_bwd.cu", "dq_kernel"),
                      ("vit_attention_bwd.cu", "dkv_kernel")):
        found = _build.kernel_resources(_build.build_log(src), kern)
        if not found:
            raise SystemExit(f"no -Xptxas -v report of {kern} in the build "
                             f"log of {src}")
        for mangled, res in found.items():
            if kern == "attn_kernel":   # attn_kernel<FOLDED>
                name = ("attn_kernel<exp2>" if "ILb1E" in mangled
                        else "attn_kernel<softmax>")
                dynamic = fwd.vit_attention_forward_smem()
            else:
                name = kern
                dynamic = bwd.vit_attention_backward_smem(
                    int(kern == "dkv_kernel"))
            out[src][name] = {**res, "dynamic_smem": dynamic}
    _log("[vit] attention kernel resources " + json.dumps(out))
    return out


# the epilogues of vit_block.cu's GEMM by template argument (its Epi enum)
GEMM_EPILOGUES = ("qkv", "out_proj", "fc1_gelu", "fc1_quick_gelu", "fc2")


def _sass_hgmma(library: str):
    """HGMMA (wgmma) instructions per kernel, by mangled name, in the SASS
    of a built library (``cuobjdump -sass``); None where the toolkit has no
    cuobjdump."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", library], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        found = re.search(r"Function : (\S+)", line)
        if found:
            fn = found.group(1)
            counts[fn] = 0
        elif fn is not None and "HGMMA" in line:
            counts[fn] += 1
    return counts


def _block_resources() -> dict:
    """Registers, spills and stack frame per thread and static shared
    memory of ``vit_block.cu``'s kernels as ``nvcc -Xptxas -v`` reported
    them, by kernel: each GEMM instantiation ``gemm_kernel<epilogue, BN>``
    and the two LayerNorms.  ptxas reports a GEMM's registers at its
    launch bound; the split that ``setmaxnreg`` makes (producer,
    consumers) and the dynamic shared memory of a block come from the
    library's own constants.  Fails if the SASS of a GEMM instantiation
    holds no HGMMA (``sass_hgmma``: their count, null without
    cuobjdump)."""
    from situation_recognition_tpu_torch.ops import _build
    from situation_recognition_tpu_torch.ops import vit_kernel as vk

    src = "vit_block.cu"
    lib = vk._lib(src, "vit_block_gemm_smem")
    vk._lib(src, "vit_block_gemm_maxnreg")
    split = {"producer": lib.vit_block_gemm_maxnreg(0),
             "consumers": lib.vit_block_gemm_maxnreg(1)}
    hgmma = _sass_hgmma(_build._target(src)[1])
    out = {}
    for kern in ("gemm_kernel", "layernorm_kernel"):
        found = _build.kernel_resources(_build.build_log(src), kern)
        if not found:
            raise SystemExit(f"no -Xptxas -v report of {kern} in the build "
                             f"log of {src}")
        for mangled, res in found.items():
            inst = re.search(r"gemm_kernelILi(\d+)ELi(\d+)E", mangled)
            if inst:
                name = (f"gemm_kernel<{GEMM_EPILOGUES[int(inst.group(1))]},"
                        f"{inst.group(2)}>")
                count = None if hgmma is None else hgmma.get(mangled, 0)
                if count == 0:
                    raise SystemExit(f"no HGMMA in the SASS of {name}")
                out[name] = {**res, "setmaxnreg": split,
                             "dynamic_smem": lib.vit_block_gemm_smem(
                                 int(inst.group(1)), int(inst.group(2))),
                             "sass_hgmma": count}
            else:
                name = ("layernorm_kernel<float>"
                        if "layernorm_kernelIf" in mangled
                        else "layernorm_kernel<bf16>")
                out[name] = {**res, "dynamic_smem": 0}
    _log("[vit] vit_block.cu kernel resources " + json.dumps(out))
    return out


# the GEMM kinds of csrc/ggnn_gemm.cuh's kernel: K1/K2's, then K3's
GGNN_GEMM_KINDS = ("gate", "cand", "drh", "dagg", "dh")


def _ggnn_resources(src: str, entry: str, kernels) -> dict:
    """Registers, spills and stack frame per thread and static shared
    memory of a GGNN source's kernels (``ggnn_folded.cu``: K1/K2;
    ``ggnn_folded_bwd.cu``: K3) as ``nvcc -Xptxas -v`` reported them, by
    kernel: each GEMM instantiation ``ggnn_gemm_kernel<kind, rows x
    columns>`` and the elementwise ``kernels``; for each GEMM the
    ``setmaxnreg`` split and the dynamic shared memory of a block, from the
    library's own constants (``<entry>_smem``, ``<entry>_maxnreg``).  Fails
    if the SASS of a GEMM instantiation holds no HGMMA (``sass_hgmma``:
    their count, null without cuobjdump) or ptxas reports spills."""
    from situation_recognition_tpu_torch.ops import _build
    from situation_recognition_tpu_torch.ops import ggnn_kernel as tk

    lib = tk._lib(src, f"{entry}_smem")
    tk._lib(src, f"{entry}_maxnreg")
    maxnreg = getattr(lib, f"{entry}_maxnreg")
    smem = getattr(lib, f"{entry}_smem")
    split = {"producer": maxnreg(0), "consumers": maxnreg(1)}
    hgmma = _sass_hgmma(_build._target(src)[1])
    out = {}
    for kern in ("ggnn_gemm_kernel",) + tuple(kernels):
        found = _build.kernel_resources(_build.build_log(src), kern)
        if not found:
            raise SystemExit(f"no -Xptxas -v report of {kern} in the build "
                             f"log of {src}")
        for mangled, res in found.items():
            if res["spill_stores"] or res["spill_loads"]:
                raise SystemExit(f"{mangled} spills: {res}")
            inst = re.search(r"ggnn_gemm_kernelILi(\d+)ELi(\d+)ELi(\d+)E",
                             mangled)
            if inst is None:
                out[kern] = {**res, "dynamic_smem": 0}
                continue
            kind, bm, bn = (int(inst.group(i)) for i in (1, 2, 3))
            name = f"ggnn_gemm_kernel<{GGNN_GEMM_KINDS[kind]},{bm}x{bn}>"
            count = None if hgmma is None else hgmma.get(mangled, 0)
            if count == 0:
                raise SystemExit(f"no HGMMA in the SASS of {name}")
            out[name] = {**res, "setmaxnreg": split,
                         "dynamic_smem": smem(bm, bn), "sass_hgmma": count}
    _log(f"[kernel] {src} kernel resources " + json.dumps(out))
    return out


def _gemm_products(x, ctx, w) -> dict:
    """Each GEMM of K4 and K6 alone, through ``vit_block_gemm`` (the kernel
    with that product's epilogue), timed with CUDA events at the stream's
    shape with its achieved TFLOP/s, beside ``torch.nn.functional.linear``
    (cuBLAS) on the same operands: no PyTorch call computes K4 or K6, so
    that yardstick times the products alone.  qkv and fc1 read the stream
    in place of the LayerNorm output; fc2 reads the hidden that fc1 wrote
    and the f32 residual that the out-projection wrote."""
    import torch
    import torch.nn.functional as F

    from situation_recognition_tpu_torch.ops import vit_kernel as vk

    lib = vk._lib("vit_block.cu", "vit_block_gemm")
    m, d = x.shape
    hid = w.fc1_w.shape[0]
    r = torch.empty((m, d), dtype=torch.float32, device=x.device)
    h = torch.empty((m, hid), dtype=torch.bfloat16, device=x.device)
    qkv = torch.empty((m, 3 * d), dtype=torch.bfloat16, device=x.device)
    out = torch.empty_like(x)
    rows = {}
    for name, code, a, wt, bias, res, dst in (
            ("qkv", 0, x, w.in_w, w.in_b, None, qkv),
            ("out_proj", 1, ctx, w.out_w, w.out_b, x, r),
            ("fc1", 2, x, w.fc1_w, w.fc1_b, None, h),
            ("fc2", 4, h, w.fc2_w, w.fc2_b, r, out)):
        n, k = wt.shape
        args = (code, a.data_ptr(), wt.data_ptr(), bias.data_ptr(),
                None if res is None else res.data_ptr(), dst.data_ptr(), m,
                n, k)

        def call():
            rc = lib.vit_block_gemm(*args,
                                    torch.cuda.current_stream().cuda_stream)
            if rc:
                raise SystemExit(f"vit_block_gemm {name} failed: {rc}")

        flops = 2 * m * n * k
        ms = _time_ms(call, 10)
        cublas_ms = _time_ms(lambda: F.linear(a, wt), 10)
        rows[name] = {"shape": f"({m}, {k}) x ({n}, {k})^T", "ms": ms,
                      "tflops": flops / ms / 1e9, "cublas_ms": cublas_ms,
                      "cublas_tflops": flops / cublas_ms / 1e9}
    del r, h, qkv, out
    _log("[vit] K4/K6 products " + json.dumps(rows))
    return rows


def _rel_errors(got, want) -> dict:
    diff = (got.float() - want.float()).abs()
    scale = want.float().abs().max().item()
    return {"max": diff.max().item(), "mean": diff.mean().item(),
            "equal_share": (got == want).float().mean().item(),
            "scale": scale, "max_rel": diff.max().item() / scale,
            "mean_rel": diff.mean().item() / scale}


def _vit_row(name, shape, errs, ms, plain_ms, bound, library_ms=None,
             tol=(VIT_MAX_REL, VIT_MEAN_REL), **extra) -> dict:
    bound_ms, bound_by, flops, nbytes = bound
    row = {"shape": shape, "errors": errs,
           "max_abs_err": max(e["max"] for e in errs.values()),
           "tol_max_rel": tol[0], "tol_mean_rel": tol[1],
           "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": bound_ms, "bound_by": bound_by, "flop": flops,
           "bytes": nbytes, "tflops": flops / ms / 1e9, **extra}
    _log(f"[vit] {name} " + json.dumps(row))
    bad = [k for k, e in errs.items()
           if e["max_rel"] > tol[0] or e["mean_rel"] > tol[1]]
    if bad:
        raise SystemExit(f"{name} disagrees with its twin at {shape}: {bad}")
    return row


def _k1_rows_at(enc, gen, batch: int, d: int) -> list:
    """K1 against its twin at the noun and verb shapes of a head of width
    ``d``, timed, with its bound."""
    import torch

    from situation_recognition_tpu_torch.ops import ggnn_kernel as tk

    params = _ggnn_params(d, gen)
    rows = []
    for label, b, r, m, h, mask in _shape_cases(enc, gen, batch, d,
                                                ragged=False):
        weights = tk.fold_gate_weights(params, float(r))
        want = tk.folded_reference(h, mask, weights, r, STEPS)
        got = tk.folded_rows(h, mask, weights, r, STEPS)
        torch.cuda.synchronize()
        err, mean_err, same = _errors(got, want)
        ms = _time_ms(lambda: tk.folded_rows(h, mask, weights, r, STEPS), 20)
        plain_ms = _time_ms(
            lambda: tk.folded_reference(h, mask, weights, r, STEPS), 5, 1)
        bound_ms, bound_by, flops, nbytes = _folded_bound(m, d, r, STEPS,
                                                          mask)
        row = {"shape": f"{label} B={b} R={r} M={m} d={d} steps={STEPS}",
               "max_abs_err": err, "mean_abs_err": mean_err,
               "equal_share": same, "tol_max": KERNEL_MAX_TOL,
               "tol_mean": KERNEL_MEAN_TOL, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": _folded_library_ms(h, weights), "flop": flops,
               "bytes": nbytes, "tflops": flops / ms / 1e9,
               "tiles": tk.tile_plan(m, d, _sms())._asdict()}
        _log("[vit] K1 " + json.dumps(row))
        if err > KERNEL_MAX_TOL or mean_err > KERNEL_MEAN_TOL:
            raise SystemExit(f"GGNN kernel disagrees with its twin at "
                             f"{row['shape']}: max {err} mean {mean_err}")
        rows.append(row)
    return rows


def _attention_row(kname: str, q, k, v, batch: int, n: int, stride: int,
                   heads: int) -> dict:
    """The attention kernel through K5's wrapper (``stride == n``) or K7's
    against its twin in both softmax flavours (pad rows exactly zero),
    timed with CUDA events beside its bound and SDPA on the same real
    rows as (B, h, N, 64) tensors."""
    import torch
    import torch.nn.functional as F

    from situation_recognition_tpu_torch.ops import vit as tv
    from situation_recognition_tpu_torch.ops import vit_kernel as vk

    d = q.shape[1]
    if kname == "K5":
        def call(folded):
            return vk.vit_attention_forward(
                *(t.reshape(batch, n, d) for t in (q, k, v)), heads,
                folded).reshape(-1, d)
    else:
        def call(folded):
            return vk.vit_attention_stream_forward(q, k, v, heads, folded,
                                                   stride, n)
    scale = 1.0 / 8.0
    rows = {}
    for flavour, folded in (("exp2", True), ("softmax", False)):
        want = tv.attn_core_reference(q, k, v, heads, scale, folded, stride,
                                      n)
        got = call(folded)
        torch.cuda.synchronize()
        errs = _rel_errors(got, want)
        pad_zero = bool((got.reshape(batch, stride, d)[:, n:] == 0).all())
        del got, want
        if not pad_zero:
            raise SystemExit(f"{kname} wrote nonzero pad rows")
        rows[flavour] = {
            "errors": errs, "pad_rows_zero": pad_zero,
            "ms": _time_ms(lambda: call(folded), 10),
            "plain_ms": _time_ms(lambda: tv.attn_core_reference(
                q, k, v, heads, scale, folded, stride, n), 3, 1)}
    flops = 4 * batch * heads * n * n * (d // heads)
    nbytes = 3 * batch * n * d * 2 + batch * stride * d * 2
    q4, k4, v4 = (t.reshape(batch, stride, heads, d // heads)[:, :n]
                  .transpose(1, 2).contiguous() for t in (q, k, v))
    sdpa_ms = _time_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4),
                       10)
    del q4, k4, v4
    head = rows["exp2"]
    return _vit_row(
        f"{kname} attention", f"B={batch} heads={heads} N={n} "
        f"row_stride={stride} dh={d // heads} exp2",
        {f"{f}:ctx": r["errors"] for f, r in rows.items()},
        head["ms"], head["plain_ms"], _bound(flops, nbytes),
        library_ms=sdpa_ms, softmax_ms=rows["softmax"]["ms"],
        softmax_plain_ms=rows["softmax"]["plain_ms"],
        pad_rows_zero=all(r["pad_rows_zero"] for r in rows.values()))


def _attention_bwd_row(q, k, v, o, do, batch: int, n: int, stride: int,
                       heads: int) -> dict:
    """K8 against its twin (pad rows exactly zero), timed with CUDA events
    beside its bound and the backward alone of SDPA on the same real rows
    as (B, h, N, 64) tensors.  The bound counts the five real-row inputs
    read once and the three gradients written once (pad rows included),
    and five products of 2·N²·64 per head and example."""
    import torch
    import torch.nn.functional as F

    from situation_recognition_tpu_torch.ops import vit as tv
    from situation_recognition_tpu_torch.ops import vit_kernel as vk

    d = q.shape[1]
    want = tv.attn_bwd_reference(q, k, v, o, do, heads, 1.0 / 8.0, stride, n)
    got = vk.vit_attention_backward(q, k, v, o, do, heads, stride, n)
    torch.cuda.synchronize()
    errs = {name: _rel_errors(g, w)
            for name, g, w in zip(("dq", "dk", "dv"), got, want)}
    pad_zero = all(bool((g.reshape(batch, stride, d)[:, n:] == 0).all())
                   for g in got)
    del got, want
    if not pad_zero:
        raise SystemExit("K8 wrote nonzero pad rows")
    ms = _time_ms(lambda: vk.vit_attention_backward(q, k, v, o, do, heads,
                                                    stride, n), 10)
    plain_ms = _time_ms(lambda: tv.attn_bwd_reference(
        q, k, v, o, do, heads, 1.0 / 8.0, stride, n), 3, 1)
    flops = 5 * 2 * batch * heads * n * n * (d // heads)
    nbytes = 5 * batch * n * d * 2 + 3 * batch * stride * d * 2
    q4, k4, v4, do4 = (t.reshape(batch, stride, heads, d // heads)[:, :n]
                       .transpose(1, 2).contiguous() for t in (q, k, v, do))
    for t in (q4, k4, v4):
        t.requires_grad_()
    out4 = F.scaled_dot_product_attention(q4, k4, v4)
    sdpa_ms = _time_ms(lambda: torch.autograd.grad(
        out4, (q4, k4, v4), do4, retain_graph=True), 10)
    del q4, k4, v4, do4, out4
    return _vit_row(
        "K8 attention backward", f"B={batch} heads={heads} N={n} "
        f"row_stride={stride} dh={d // heads}", errs, ms, plain_ms,
        _bound(flops, nbytes), library_ms=sdpa_ms,
        tol=(K8_MAX_REL, K8_MEAN_REL), pad_rows_zero=pad_zero)


def phase_vit_kernel(enc, seed: int, batch: int) -> dict:
    """K4, K5/K7 and K6 against their twins on the card at the shapes the
    ViT-L/14 paths give them (batch 256, 257 tokens: a stream of
    256·257 rows), timed with CUDA events beside their bounds; the
    attention also in the TPU stream's padded layout (264-row stride) and
    at 577 tokens (ViT-L/14 at 336²), with SDPA on the same (B, h, N, 64)
    tensors as its library yardstick; and K1 at the head width 1024 that
    the ViT gives it."""
    import torch
    import torch.nn.functional as F

    from situation_recognition_tpu_torch.ops import vit as tv
    from situation_recognition_tpu_torch.ops import vit_kernel as vk

    gen = torch.Generator().manual_seed(seed + 7)
    d, hid, h, n, n8 = VIT_D, 4 * VIT_D, VIT_HEADS, VIT_N, VIT_N8

    def rnd(*shape, scale=1.0, base=0.0):
        return base + torch.randn(shape, generator=gen) * scale

    bound = 1.0 / d ** 0.5
    w = vk.kernel_weights(tv.BlockWeights(
        rnd(d, base=1.0, scale=0.05), rnd(d, scale=0.05),
        rnd(3 * d, d, scale=bound), rnd(3 * d, scale=bound),
        rnd(d, d, scale=bound), rnd(d, scale=bound),
        rnd(d, base=1.0, scale=0.05), rnd(d, scale=0.05),
        rnd(hid, d, scale=bound), rnd(hid, scale=bound),
        rnd(d, hid, scale=hid ** -0.5), rnd(d, scale=bound)))
    w = tv.BlockWeights(*(t.to(DEVICE) for t in w))
    m = batch * n
    x = rnd(m, d).to(torch.bfloat16).to(DEVICE)
    out = {}

    # K4 on the stream
    want = tv.qkv_reference(x, w, 1e-6)
    got = vk.vit_qkv_forward(x, w, 1e-6)
    torch.cuda.synchronize()
    errs = {k: _rel_errors(g, t) for k, g, t in zip("qkv", got, want)}
    del got, want
    flops = 6 * m * d * d
    nbytes = m * d * 2 + 3 * d * d * 2 + 5 * d * 4 + 3 * m * d * 2
    out["K4"] = _vit_row(
        "K4 qkv", f"M={m} (B={batch} x {n}) D={d}", errs,
        _time_ms(lambda: vk.vit_qkv_forward(x, w, 1e-6), 10),
        _time_ms(lambda: tv.qkv_reference(x, w, 1e-6), 3, 1),
        _bound(flops, nbytes))

    # K7 and K5 at the paths' shapes (stride 257), both softmax flavours;
    # q, k, v from K4 so that the scores have its spread
    q, k, v = vk.vit_qkv_forward(x, w, 1e-6)
    out["K7"] = [_attention_row("K7", q, k, v, batch, n, n, h)]
    out["K5"] = [_attention_row("K5", q, k, v, batch, n, n, h)]
    # the TPU stream's layout, which K7 also takes: 264 rows per example,
    # the pad rows never read and written as exactly zero
    def padded(t):
        return F.pad(t.reshape(batch, n, d), (0, 0, 0, n8 - n)).reshape(-1, d)

    out["K7"].append(_attention_row("K7", *(padded(t) for t in (q, k, v)),
                                    batch, n, n8, h))
    ctx = vk.vit_attention_stream_forward(q, k, v, h, True, n, n)
    # K8 on the same q, k, v, the exp2 context as the ft stream saves it,
    # and a cotangent of the context's spread; then in the TPU stream's
    # layout with pad rows
    do = rnd(m, d, scale=float(ctx.float().std())).to(torch.bfloat16).to(
        DEVICE)
    out["K8"] = [_attention_bwd_row(q, k, v, ctx, do, batch, n, n, h)]
    out["K8"].append(_attention_bwd_row(
        *(padded(t) for t in (q, k, v, ctx, do)), batch, n, n8, h))
    del q, k, v, do
    # ViT-L/14 at 336²: 577 tokens, ten key tiles per query tile
    xl = rnd(VIT_LONG_BATCH * VIT_LONG_N, d).to(torch.bfloat16).to(DEVICE)
    out["K5"].append(_attention_row(
        "K5", *vk.vit_qkv_forward(xl, w, 1e-6), VIT_LONG_BATCH, VIT_LONG_N,
        VIT_LONG_N, h))
    del xl

    # K6 on the stream, both GELUs
    flops = 18 * m * d * d
    nbytes = 2 * m * d * 2 + 9 * d * d * 2 + (4 * d + hid) * 4 + m * d * 2
    errs, times = {}, {}
    for flavour, quick in (("erf", False), ("quick", True)):
        want = tv.out_mlp_reference(x, ctx, w, 1e-6, quick)
        got = vk.vit_out_mlp_forward(x, ctx, w, 1e-6, quick)
        torch.cuda.synchronize()
        errs[f"{flavour}:out"] = _rel_errors(got, want)
        del got, want
        times[flavour] = (
            _time_ms(lambda: vk.vit_out_mlp_forward(x, ctx, w, 1e-6, quick),
                     10),
            _time_ms(lambda: tv.out_mlp_reference(x, ctx, w, 1e-6, quick),
                     3, 1))
    products = _gemm_products(x, ctx, w)
    out["K6"] = _vit_row(
        "K6 out-MLP", f"M={m} (B={batch} x {n}) D={d} H={hid} erf", errs,
        times["erf"][0], times["erf"][1], _bound(flops, nbytes),
        quick_ms=times["quick"][0], quick_plain_ms=times["quick"][1],
        products={k: products[k] for k in ("out_proj", "fc1", "fc2")})
    out["K4"]["products"] = {"qkv": products["qkv"]}
    del x, ctx
    out["K1"] = _k1_rows_at(enc, gen, batch, d)
    return out


def _random_vit_model(enc, seed: int):
    """ViT-L/14 + FCGGNN(1024) at bf16 with random weights from ``seed``,
    on the host."""
    import torch

    from situation_recognition_tpu_torch.serving import SituationModel

    model = SituationModel(enc, backbone=VIT, hidden=VIT_D,
                           image_size=VIT_IMAGE, dtype=torch.bfloat16)
    gen = torch.Generator().manual_seed(seed)
    model.backbone.reset_parameters(gen)
    model.head.reset_parameters(gen)
    return model.eval()


def phase_vit_path(enc, seed: int, batch: int, card: str) -> dict:
    """The ViT serving path: an artifact exported from ``--seed`` weights,
    loaded on the card; batch 256 through the stream stack and the
    per-block path against the plain path on the card; batch timing and a
    profile; the batcher's bursts.  The kernel counts are zeroed before
    each path and read after it."""
    import numpy as np
    import torch

    from situation_recognition_tpu_torch.serving import (
        export_inference, load_inference)

    n_req = 8
    t = time.perf_counter()
    model = _random_vit_model(enc, seed)
    tmp = tempfile.mkdtemp(prefix="srtorch_vit_artifact_")
    try:
        export_inference(model, tmp, batch_size=n_req)
        del model
        fn = load_inference(tmp, device="cuda")
        plain = load_inference(tmp, device="cuda", ggnn_impl="masked",
                               block_impl="plain")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    _phase("vit: random weights + export + load", t)
    vit = fn.model.backbone
    if vit.resolved_impl(DEVICE) != "kernel" or \
            fn.model.head.ggsnn.impl != "kernel":
        raise SystemExit(f"the served ViT did not resolve to the kernels: "
                         f"{vit.resolved_impl(DEVICE)}, "
                         f"{fn.model.head.ggsnn.impl}")
    if (vit.width, vit.depth, vit.heads, vit.n_tokens) != (
            VIT_D, VIT_DEPTH, VIT_HEADS, VIT_N):
        raise SystemExit("not the full-width ViT-L/14")

    rng = np.random.default_rng(seed + 11)
    big = torch.from_numpy(rng.integers(0, 256, (batch, 256, 256, 3),
                                        dtype=np.uint8)).cuda()
    result = {"card": card, "batch": batch, "launches": {}}
    old_env = os.environ.get("SRTPU_VIT_STREAM")
    try:
        with torch.inference_mode():
            want = plain.model.serve(big)
            feats_plain = plain.model.features(big)
            for label, stream in (("stream", "1"), ("block", "0")):
                os.environ["SRTPU_VIT_STREAM"] = stream
                fn.model.serve(big)                       # warm-up
                torch.cuda.synchronize()
                _zero_vit_counts()
                got = fn.model.serve(big)
                torch.cuda.synchronize()
                result["launches"][label] = _vit_counts()
                errs = _logit_errors(got, want)
                feats = fn.model.features(big)
                errs["features_rel"] = ((feats - feats_plain).norm()
                                        / feats_plain.norm()).item()
                t0 = time.perf_counter()
                reps = 3 if label == "stream" else 1
                for _ in range(reps):
                    last = fn.model.serve(big)
                torch.cuda.synchronize()
                per_batch = (time.perf_counter() - t0) / reps
                if not all(torch.isfinite(x).all() for x in (last[0],
                                                             last[2])):
                    raise SystemExit(f"non-finite logits on the {label} "
                                     f"path")
                result[label] = {"errors": errs,
                                 "batch_ms": per_batch * 1e3,
                                 "img_per_s": batch / per_batch}
                _log(f"[vit] serve {label} " + json.dumps(
                    {"launches": result["launches"][label],
                     **result[label]}))
                if max(errs["verb"], errs["noun"]) > LOGIT_TOL or not \
                        errs["verb_ids_agree_where_decided"]:
                    raise SystemExit(f"the {label} path disagrees with the "
                                     f"plain path")
            os.environ["SRTPU_VIT_STREAM"] = "1"
            result["profile"] = _profile(
                "one served batch (stream)",
                lambda: fn.model.serve(big), tag="vit")
    finally:
        if old_env is None:
            os.environ.pop("SRTPU_VIT_STREAM", None)
        else:
            os.environ["SRTPU_VIT_STREAM"] = old_env
    per_call = {"K1": 2, "K4": VIT_DEPTH, "K6": VIT_DEPTH, "K8": 0}
    want_counts = {"stream": {**per_call, "K5": 0, "K7": VIT_DEPTH},
                   "block": {**per_call, "K5": VIT_DEPTH, "K7": 0}}
    if result["launches"] != want_counts:
        raise SystemExit(f"ViT path launches {result['launches']}, want "
                         f"{want_counts}")

    images = rng.integers(0, 256, (n_req, 256, 256, 3), dtype=np.uint8)
    gt_verb = int(rng.integers(0, enc.get_num_verbs()))
    fn(images)
    fn.gt(images[:1], np.array([gt_verb]))
    torch.cuda.synchronize()
    _zero_vit_counts()
    bursts = _serve_bursts(fn, images, gt_verb)
    result["launches"]["batcher"] = _vit_counts()
    # every dispatch runs the encoder once; one gt dispatch (one propagate)
    # per burst, the rest argmax (two each)
    dispatches = bursts["stats"]["dispatches"]
    want_batcher = {"K1": 2 * (dispatches - BURSTS) + BURSTS, "K5": 0,
                    "K8": 0,
                    **{k: VIT_DEPTH * dispatches for k in ("K4", "K6",
                                                           "K7")}}
    if result["launches"]["batcher"] != want_batcher:
        raise SystemExit(f"ViT batcher launches "
                         f"{result['launches']['batcher']}, want "
                         f"{want_batcher}")
    _check_bursts(bursts, plain, images, gt_verb, "vit")
    result["batcher"] = {"burst_wall_s": bursts["walls"],
                         "latency_ms": bursts["latency"],
                         "dispatches": bursts["stats"]["dispatches"],
                         "launches": result["launches"]["batcher"]}
    _log("[vit] batcher " + json.dumps(result["batcher"]))
    return result


def phase_vit_train(enc, seed: int, batch: int) -> dict:
    """A frozen-backbone ViT-L/14 ``Trainer`` at batch 256: train steps
    and an eval batch, their launches, losses, scores and img/s."""
    import numpy as np
    import torch

    from situation_recognition_tpu_torch.train import Trainer, TrainerConfig

    trainer = Trainer(enc, TrainerConfig(
        hidden=VIT_D, batch_size=batch, backbone=VIT,
        image_size=VIT_IMAGE, compute_dtype=torch.bfloat16, seed=seed),
        device=DEVICE)
    if trainer.backbone.resolved_impl(DEVICE) != "kernel" or \
            trainer.head.ggsnn.impl != "kernel":
        raise SystemExit("the ViT trainer did not resolve to the kernels")
    batches = _train_batches(enc, seed + 3, batch,
                             VIT_TRAIN_STEPS + VIT_EVAL_BATCHES + 1)
    steps, losses = [], []
    for i in range(VIT_TRAIN_STEPS):
        torch.cuda.synchronize()
        _zero_vit_counts()
        t0 = time.perf_counter()
        _, _, step_losses = trainer.train_epoch([batches[i]], i)
        torch.cuda.synchronize()
        steps.append({"ms": (time.perf_counter() - t0) * 1e3,
                      "launches": _vit_counts()})
        losses.append(list(step_losses))
    profile = _profile("one frozen-backbone train step",
                       lambda: trainer.train_epoch([batches[-1]],
                                                   VIT_TRAIN_STEPS),
                       tag="vit train")
    _zero_vit_counts()
    t0 = time.perf_counter()
    top1, top5, val_losses, avg = trainer.evaluate(
        batches[VIT_TRAIN_STEPS:-1], logging=True)
    torch.cuda.synchronize()
    eval_s = (time.perf_counter() - t0) / VIT_EVAL_BATCHES
    eval_launches = _vit_counts()
    scores = [100 * v for v in (
        list(top1.get_average_results_both().values())
        + list(top5.get_average_results_both().values()))]
    last = steps[-1]["ms"]
    result = {"steps": steps, "losses": losses, "val_losses": val_losses,
              "scores": scores, "mean_of_eight": avg,
              "train_step_ms": last, "train_img_per_s": batch / last * 1e3,
              "eval_batch_ms": eval_s * 1e3,
              "eval_img_per_s": batch / eval_s,
              "eval_launches": eval_launches,
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
              "profile": profile}
    _log("[vit] train " + json.dumps(result))
    if not np.isfinite(np.asarray(losses)).all() or not all(
            np.isfinite(v) for v in val_losses.values()):
        raise SystemExit("non-finite ViT trainer losses")
    if len(scores) != 8 or not all(0 <= v <= 100 for v in scores):
        raise SystemExit(f"bad ViT trainer scores: {scores}")
    per_step = {"K1": 1, "K4": VIT_DEPTH, "K5": 0, "K6": VIT_DEPTH,
                "K7": VIT_DEPTH, "K8": 0}
    if any(s["launches"] != per_step for s in steps):
        raise SystemExit(f"ViT train-step launches "
                         f"{[s['launches'] for s in steps]}, want {per_step}")
    per_eval = {"K1": 3 * VIT_EVAL_BATCHES, "K4": VIT_DEPTH * VIT_EVAL_BATCHES,
                "K5": 0, "K6": VIT_DEPTH * VIT_EVAL_BATCHES,
                "K7": VIT_DEPTH * VIT_EVAL_BATCHES, "K8": 0}
    if eval_launches != per_eval:
        raise SystemExit(f"ViT eval launches {eval_launches}, want "
                         f"{per_eval}")
    return result


def phase_vit_ft_stack(seed: int) -> dict:
    """The ft stack on the card: ``FT_STACK_DEPTH`` blocks at ViT-L/14
    width (1024, 16 heads of 64, MLP 4096), batch ``FT_STACK_BATCH``, 257
    tokens, bf16.  Its gradients with respect to x and each block's
    parameters (K7 forward, K8 backward) against autograd over the plain
    ``reference_block``s, under a squared loss of the CLS rows."""
    import torch

    from situation_recognition_tpu_torch.ops import vit as tv
    from situation_recognition_tpu_torch.ops import vit_kernel as vk
    from situation_recognition_tpu_torch.ops.vit_train import ft_cls_stack

    gen = torch.Generator().manual_seed(seed + 13)
    d, hid, h, n = VIT_D, 4 * VIT_D, VIT_HEADS, VIT_N
    bound = d ** -0.5

    def rnd(*shape, scale, base=0.0):
        return (base + torch.randn(shape, generator=gen) * scale).to(DEVICE)

    def weights():
        return [tv.BlockWeights(
            rnd(d, base=1.0, scale=0.05), rnd(d, scale=0.05),
            rnd(3 * d, d, scale=bound), rnd(3 * d, scale=bound),
            rnd(d, d, scale=bound), rnd(d, scale=bound),
            rnd(d, base=1.0, scale=0.05), rnd(d, scale=0.05),
            rnd(hid, d, scale=bound), rnd(hid, scale=bound),
            rnd(d, hid, scale=hid ** -0.5), rnd(d, scale=bound))
            for _ in range(FT_STACK_DEPTH)]

    base = weights()
    x0 = rnd(FT_STACK_BATCH, n, d, scale=1.0).to(torch.bfloat16)

    def grads(stack):
        blocks = [tv.BlockWeights(*(t.clone().requires_grad_() for t in w))
                  for w in base]
        x = x0.clone().requires_grad_()
        (stack(x, blocks).float() ** 2).sum().backward()
        return x.grad, blocks

    before = (vk.vit_attention_stream_forward.launches,
              vk.vit_attention_backward.launches)
    gx_k, w_k = grads(lambda x, b: ft_cls_stack(x, b, h, 1e-6, False, True,
                                                False))
    torch.cuda.synchronize()
    launched = (vk.vit_attention_stream_forward.launches - before[0],
                vk.vit_attention_backward.launches - before[1])
    gx_p, w_p = grads(lambda x, b: tv.reference_cls_stack(x, b, h, 1e-6,
                                                          False))
    torch.cuda.synchronize()

    def rel(a, w):
        return ((a.float() - w.float()).abs().max()
                / w.float().abs().max()).item()

    gscale = max(t.grad.abs().max().item() for w in w_p for t in w)
    errs = {"x": rel(gx_k, gx_p)}
    bk = {}
    for i, (wk, wp) in enumerate(zip(w_k, w_p)):
        for name in tv.BlockWeights._fields:
            a, b = getattr(wk, name).grad, getattr(wp, name).grad
            if name == "in_b":
                for j, part in enumerate(("bq", "bk", "bv")):
                    sl = slice(j * d, (j + 1) * d)
                    if part == "bk":
                        bk[i] = [a[sl].abs().max().item() / gscale,
                                 b[sl].abs().max().item() / gscale]
                    else:
                        errs[f"{i}.{part}"] = rel(a[sl], b[sl])
            else:
                errs[f"{i}.{name}"] = rel(a, b)
    result = {"shape": f"{FT_STACK_DEPTH} blocks B={FT_STACK_BATCH} N={n} "
                       f"D={d} heads={h} bf16",
              "launches": {"K7": launched[0], "K8": launched[1]},
              "x_rel": errs["x"], "weight_rel_max": max(
                  v for k, v in errs.items() if k != "x"),
              "bk_abs_over_scale": bk, "rel": errs,
              "tol": {"x": FT_X_REL, "weights": FT_W_REL, "bk": FT_BK_ABS}}
    _log("[vit ft] stack " + json.dumps(result))
    if launched != (FT_STACK_DEPTH, FT_STACK_DEPTH):
        raise SystemExit(f"the ft stack launched K7/K8 {launched} times, "
                         f"want {FT_STACK_DEPTH} each")
    bad = [k for k, v in errs.items()
           if v > (FT_X_REL if k == "x" else FT_W_REL)]
    bad += [f"{i}.bk" for i, v in bk.items() if max(v) > FT_BK_ABS]
    if bad:
        raise SystemExit(f"the ft stack's gradients disagree with autograd "
                         f"over the plain blocks: {bad}")
    return result


def phase_vit_ft(enc, seed: int, batch: int) -> dict:
    """Fine-tuning ViT-L/14 + FCGGNN at batch 256 with ``remat_backbone``:
    a warm step, timed steps with their launches, a profiled step, the
    backbone parameters that moved, peak memory, and an eval batch."""
    import numpy as np
    import torch

    from situation_recognition_tpu_torch.train import Trainer, TrainerConfig

    t = time.perf_counter()
    trainer = Trainer(enc, TrainerConfig(
        hidden=VIT_D, batch_size=batch, backbone=VIT,
        image_size=VIT_IMAGE, compute_dtype=torch.bfloat16, seed=seed,
        train_backbone=True, remat_backbone=True), device=DEVICE)
    vit = trainer.backbone
    if vit.resolved_impl(DEVICE) != "kernel" or not vit.remat or \
            trainer.head.ggsnn.impl != "kernel":
        raise SystemExit("the fine-tuning trainer did not resolve to the "
                         "kernels with remat")
    start = {k: p.detach().to("cpu", copy=True)
             for k, p in vit.named_parameters()}
    batches = _train_batches(enc, seed + 5, batch, VIT_FT_STEPS + 3)
    _phase("vit ft: trainer", t)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps, losses = [], []
    for i in range(1 + VIT_FT_STEPS):
        torch.cuda.synchronize()
        _zero_vit_counts()
        t0 = time.perf_counter()
        _, _, step_losses = trainer.train_epoch([batches[i]], i)
        torch.cuda.synchronize()
        steps.append({"ms": (time.perf_counter() - t0) * 1e3,
                      "launches": _vit_counts()})
        losses.append(list(step_losses))
    peak = torch.cuda.max_memory_allocated() / 1e9
    moved = {k: (p.detach().cpu() - start[k]).abs().max().item()
             for k, p in vit.named_parameters()}
    del start
    profile = _profile("one fine-tuning step", lambda: trainer.train_epoch(
        [batches[1 + VIT_FT_STEPS]], 1 + VIT_FT_STEPS), tag="vit ft")
    _zero_vit_counts()
    t0 = time.perf_counter()
    _, _, val_losses, _ = trainer.evaluate(batches[2 + VIT_FT_STEPS:])
    torch.cuda.synchronize()
    eval_ms = (time.perf_counter() - t0) * 1e3
    eval_launches = _vit_counts()
    timed = [s["ms"] for s in steps[1:]]
    step_ms = sum(timed) / len(timed)
    result = {"batch": batch, "remat": True, "steps": steps,
              "losses": losses, "val_losses": val_losses,
              "train_step_ms": step_ms, "train_img_per_s": batch / step_ms
              * 1e3, "peak_mem_gb": peak,
              "backbone_tensors_moved": sum(v > 0 for v in moved.values()),
              "backbone_tensors": len(moved),
              "max_move": max(moved.values()),
              "eval_batch_ms": eval_ms, "eval_img_per_s": batch / eval_ms
              * 1e3, "eval_launches": eval_launches, "profile": profile}
    _log("[vit ft] train " + json.dumps(result))
    if not np.isfinite(np.asarray(losses)).all() or not all(
            np.isfinite(v) for v in val_losses.values()):
        raise SystemExit("non-finite fine-tuning losses")
    if result["backbone_tensors_moved"] != len(moved):
        raise SystemExit(f"backbone parameters that did not move: "
                         f"{[k for k, v in moved.items() if v == 0]}")
    per_step = {"K1": 1, "K4": 0, "K5": 0, "K6": 0, "K7": 2 * VIT_DEPTH,
                "K8": VIT_DEPTH}
    if any(s["launches"] != per_step for s in steps):
        raise SystemExit(f"fine-tuning launches per step "
                         f"{[s['launches'] for s in steps]}, want {per_step}")
    per_eval = {"K1": 3, "K4": VIT_DEPTH, "K5": 0, "K6": VIT_DEPTH,
                "K7": VIT_DEPTH, "K8": 0}
    if eval_launches != per_eval:
        raise SystemExit(f"eval launches after fine-tuning {eval_launches},"
                         f" want {per_eval}")
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
            line for line in _build.build_log(src).splitlines()
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
    # the parameter products of the train step's two K3 launches (its noun
    # and verb shapes), under both products, from the kernel phase
    train["param_products"] = {row["shape"]: row["param_products"]
                               for row in kernel["bwd_shapes"]
                               if f" d={D} " in row["shape"]}
    _log("[train] param_grads products " + json.dumps(
        train["param_products"]))
    _phase("train", t)

    if not all(train_launches.values()):
        raise SystemExit(f"a kernel of the training path never launched: "
                         f"{train_launches}")

    t = time.perf_counter()
    vit_kernel = phase_vit_kernel(enc, args.seed, BATCH)
    _phase("vit kernel", t)
    torch.cuda.empty_cache()
    t = time.perf_counter()
    vit_path = phase_vit_path(enc, args.seed, BATCH, smi)
    _phase("vit path", t)
    torch.cuda.empty_cache()
    t = time.perf_counter()
    vit_train = phase_vit_train(enc, args.seed, BATCH)
    _phase("vit train", t)
    torch.cuda.empty_cache()
    t = time.perf_counter()
    vit_ft_stack = phase_vit_ft_stack(args.seed)
    _phase("vit ft stack", t)
    torch.cuda.empty_cache()
    t = time.perf_counter()
    vit_ft = phase_vit_ft(enc, args.seed, BATCH)
    _phase("vit ft", t)
    vit_launches = {k: {path: c[k] for path, c in (
        ("serve_stream", vit_path["launches"]["stream"]),
        ("serve_block", vit_path["launches"]["block"]),
        ("batcher", vit_path["launches"]["batcher"]),
        ("train", vit_train["steps"][-1]["launches"]),
        ("ft_train", vit_ft["steps"][-1]["launches"]),
        ("ft_eval", vit_ft["eval_launches"]))}
        for k in ("K1", "K4", "K5", "K6", "K7", "K8")}
    for k, by_path in vit_launches.items():
        if not sum(by_path.values()):
            raise SystemExit(f"{k} never launched on the ViT path")

    t = time.perf_counter()
    for row, host_inputs in kernel.pop("k3_inputs"):
        _k3_split(row, host_inputs)
    _phase("K3 by launch kind", t)

    vit_pallas = "vit_pallas.py"
    res = _attention_resources()
    res["vit_block.cu"] = _block_resources()
    res["ggnn_folded.cu"] = _ggnn_resources(
        "ggnn_folded.cu", "ggnn_folded", ("ggnn_agg_kernel",))
    res["ggnn_folded_bwd.cu"] = _ggnn_resources(
        "ggnn_folded_bwd.cu", "ggnn_folded_bwd",
        ("ggnn_bwd_agg_kernel", "ggnn_bwd_prep_kernel"))
    print(json.dumps({"kernels": [
        _kernel_line("ggnn_folded", "ggnn_folded.cu", 217,
                     kernel["shapes"] + vit_kernel["K1"],
                     {"serve": path["launches"],
                      "train": train_launches["K1"],
                      **{f"vit_{p}": c
                         for p, c in vit_launches["K1"].items()}},
                     resources=res["ggnn_folded.cu"]),
        _kernel_line("ggnn_folded_res", "ggnn_folded.cu", 492,
                     kernel["res_shapes"], {"train": train_launches["K2"]},
                     resources=res["ggnn_folded.cu"]),
        _kernel_line("ggnn_folded_bwd", "ggnn_folded_bwd.cu", 521,
                     kernel["bwd_shapes"], {"train": train_launches["K3"]},
                     routes=kernel["routes"],
                     resources=res["ggnn_folded_bwd.cu"]),
        _kernel_line("vit_qkv", "vit_block.cu", 159, [vit_kernel["K4"]],
                     vit_launches["K4"], replaces=vit_pallas,
                     resources=res["vit_block.cu"]),
        _kernel_line("vit_attention_block", "vit_attention.cu", 174,
                     vit_kernel["K5"], vit_launches["K5"],
                     replaces=vit_pallas,
                     resources=res["vit_attention.cu"]),
        _kernel_line("vit_out_mlp", "vit_block.cu", 218, [vit_kernel["K6"]],
                     vit_launches["K6"], replaces=vit_pallas,
                     resources=res["vit_block.cu"]),
        _kernel_line("vit_attention_stream", "vit_attention.cu", 308,
                     vit_kernel["K7"], vit_launches["K7"],
                     replaces=vit_pallas,
                     resources=res["vit_attention.cu"]),
        _kernel_line("vit_attention_bwd", "vit_attention_bwd.cu", 467,
                     vit_kernel["K8"], vit_launches["K8"],
                     replaces=vit_pallas, ft_stack=vit_ft_stack,
                     resources=res["vit_attention_bwd.cu"]),
    ]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": kind,
                                             "count": count}}), flush=True)
    return 0


def _kernel_line(name, source, line, shapes, launches,
                 replaces="ggnn_pallas.py", **extra) -> dict:
    """One entry of the ``kernels`` line, timed at the first shape (the
    noun shape of the GGNN kernels) of ``shapes``; ``replaces`` is the
    TPU kernel's file under ``situation_recognition_tpu/ops``."""
    head = shapes[0]
    return {"name": name, "route": "cuda",
            "source": f"situation_recognition_tpu_torch/csrc/{source}",
            "replaces": f"situation_recognition_tpu/ops/{replaces}:{line}",
            "launches": sum(launches.values()),
            "launches_by_path": launches, "checked": True,
            "max_abs_err": max(s["max_abs_err"] for s in shapes),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head.get("library_ms"),
            "timed_shape": head["shape"], "shapes": shapes, **extra}


if __name__ == "__main__":
    sys.exit(main())
