#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card (H100).

    python3 chip_smoke.py [--seed 0] [--phase dist]

(``--phase dist`` runs the dist phase alone, after the device and its
kernel's build.)

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
             (``torch.profiler``: drh, dagg, E, dh, prep).  K3 and K1
             also at d=512 (resnet18/34's head, noun and verb shapes),
             and K1 at single-image inference's M = 6 (nouns) and M = 1
             (verb) at d=2048.  Then the
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
5b. accum  — gradient accumulation at the flagship (ResNet-152, d=2048,
             bf16): ``grad_accum`` 2 at microbatch 128 against batch 256.
             A group of two microbatches A and B (B: A's verbs in
             another order, so that the noun losses' denominators agree)
             against one step on [A; B] (dropout 0, eval-mode BN): the
             mean gradient of every head tensor as the clip receives it
             within ``ACCUM_GRAD_REL``, and the clip's global norm; the
             launches
             of one microbatch (K1 once; K2 and K3 twice each under
             ``pallas``); three microbatches end an epoch in two optimizer
             steps; then with train-mode BN, the steady optimizer step of
             20 groups at 128 beside 20 steps at 256 from the same rows
             (the fill left out), and a profiled one's device time.
5c. resnets — resnet18, 34, 50 and 101 at their published widths (head
             512, 512, 2048, 2048) and depths + FCGGNN, bf16, batch 256,
             random weights from ``--seed``: a warm train step and a loop
             of 20, a warm eval batch and a loop of 20; finite losses, K1
             once a train step and 3 times an eval batch, train and eval
             img/s of the steady loops (the fill left out) beside a
             profiled step's and batch's device time.
6. cli     — the reference CLI's path through ``cli.main`` in this
             process, at full width (ResNet-152 + FCGGNN, d=2048, batch
             256, bf16): a synthetic imSitu folder in a temporary directory
             (train.json of 512 images taking every verb of
             ``synthetic_full(--seed)`` in turn and every label, so the
             encoder built from it has the flagship's 504 / 190 / 2001 / 6;
             dev.json and test.json of 256; a packed store of 256² numpy
             windows), then (a) train one epoch with a snapshot after each
             step, ``--keep_best`` and ``--metrics_jsonl``, (b) resume to
             epoch 2 with ``--cache_device``, (c) ``--evaluate_dev`` of the
             checkpoint.  Checks the stats block, finite losses and scores
             in [0, 100], (b) continuing (a)'s histories, K1 launched once
             per train step (and twice more in (b)'s memory probe) and 3
             times per eval batch in each run, the device memory (a) and
             (b) took beside the windows within what (b)'s probe reserved,
             strict loads of the checkpoint into a fresh model and a save /
             load / save on the card bit-equal.  Prints the CLI's epochs'
             img/s (fill included), the steady step of the CLI trainer's
             loop over 20 in-memory batches apart from its fill and drain,
             and of its eval loop, the host's idle time per step against
             the device time of a profiled step, the packed loader's host
             time per batch, a batch's upload from pinned against pageable
             memory, the checkpoint's size and save and load seconds.
             Then a ``--grad_accum 2`` training run (microbatch 128;
             snapshots with ``--save_steps 1`` after each group only; K1
             once a microbatch and 3 times an eval batch), and from the
             folder's root (whose ``imSitu/imsitu_space.json`` the
             inference reads) on the trained checkpoint ``--test_img``
             without and with ``--verb`` and ``--subset 2``: each
             transcript in the form of its golden under ``tests/golden``,
             K1 twice an image for a predicted verb and once for a given
             one; and the per-image latency of single-image inference.
7. vit     — ViT-L/14 + FCGGNN(1024) at full width (224², 257 tokens, 24
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
8. vit ft  — fine-tuning.  First the ft stack on the card: 2 blocks at
             ViT-L/14 width, batch 16, its gradients (K7 forward, K8
             backward, torch products) against autograd over the plain
             blocks, per tensor.  Then a ``Trainer`` with
             ``train_backbone`` and ``remat_backbone`` (ViT-L/14 +
             FCGGNN(1024), bf16, batch 256, weights from ``--seed``): a
             warm step, 2 timed steps with their launches (K7 48, K8 24, K1
             1, K4/K6 0 per step), a profile of one step, the backbone
             parameters that moved, peak memory, then an eval batch
             through the forward kernels.  Then ``grad_accum`` 2 at
             microbatch 128 against batch 256 (dropout 0, each trainer
             alone on the card): a group of A and B against a step on
             [A; B] (the mean gradient of every head and backbone tensor
             as the clip receives it, within ``ACCUM_GRAD_REL``), and a
             loop of 8 groups with its launches (K7 48 and K8 24 a
             microbatch), steady optimizer step and peak memory beside
             the step's; ``--cache_device``'s reserve, probed for the
             accumulating run, covers what that trainer took.

6b. dist   — multi-process data parallelism at the flagship width
             (ResNet-152 + FCGGNN, d=2048, bf16, batch 256).  (a) A NCCL
             world of one through the CLI (``--distributed --coordinator
             127.0.0.1:<port> --num_processes 1 --process_id 0``) on a
             synthetic imSitu folder as the cli phase's: one epoch and the
             dev eval, against the same command without ``--distributed``
             (losses within ``ROUTE_LOSS_REL``, scores in [0, 100], K1 once
             a train step and 3 times an eval batch); then both CLI
             trainers' steady step over ``DIST_STEPS`` in-memory steps
             (the fill left out; plain, dist, dist, plain), the
             collectives a step (``parallel.distributed.COUNTS``: one
             all-reduce per BatchNorm and one gradient all-reduce), and a
             profiled step of each (device time, NCCL kernels, the
             profiler's collective events); the host µs of one all-reduce
             and of one BN layer, global against native; a fine-tuned
             step (remat) on the world of one against one process (first
             losses, steady step, device time, host operators, BN
             all-reduces of the forward, the recomputation and the
             backward).  (b) A world of two ranks on
             this one card over gloo on CUDA tensors (this script, one
             process a rank), global batch 256 (128 a rank), 2 train
             steps, against one process at 256 (``DIST_MODES``): per-step
             losses, the first step's summed head gradients, the head
             after the steps and the BN running statistics — bf16 with
             eval-mode BN (not the statistics) and with train-mode BN
             (losses and statistics) within ``ACCUM_GRAD_REL``, f32 with
             train-mode BN within ``DIST_F32_REL`` (the head within
             ``ACCUM_GRAD_REL``).  (c)
             Where the machine has 2 or more cards: a NCCL world of up to
             4, held as (b), and its steady step; else a line says why it
             did not run.
9. export  — the serving artifact's exported programs at full width.  The
             flagship (ResNet-152 + FCGGNN, d=2048, bf16, ``--seed``
             weights, BN statistics from one batch) through
             ``export_serving.export_model`` in f32, bf16 and int8 for
             ``cuda`` (the programs call K1 as a custom op) and f32
             ``portable``; then ViT-L/14's CLIP tower at 336² from a
             CLIP-layout state dict at the 224 grid through the CLI's
             ``_load_backbone`` (its position embedding resampled, 257 →
             577 tokens), exported f32 and int8 for ``cuda`` (K1, K4, K7
             and K6 as custom ops).  Each artifact is loaded with
             ``load_inference`` and serves batch 256 (a warm call, 3 timed)
             beside the eager model rebuilt from the same artifact
             (``rebuild=True``) on the same images: bytes, export and load
             seconds, img/s of both, the kernels' launches per served
             batch from the program (counted from 0 around the timed
             calls), the program within ``LOGIT_TOL`` of the eager model
             and of the plain paths (the masked GGNN and plain ViT blocks
             rebuilt from the same artifact) with equal verb ids where the
             plain paths' top-2 margin is decisive, each decoded weight
             within its encoding's rounding, and the bf16 / int8 logits
             beside the f32 artifact's as a share of its max |logit|.

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
# the head width of resnet18/34 (BasicBlock stacks)
SMALL_D = 512
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
    # K3 at the ViT head's width and at resnet18/34's, noun and verb
    for d in (1024, SMALL_D):
        params_d = _ggnn_params(d, gen)
        for label, b, r, m, h, mask in _shape_cases(enc, gen, batch, d,
                                                    ragged=False):
            weights = tk.fold_gate_weights(params_d, float(r))
            _, res = tk.folded_rows_res(h, mask, weights, r, STEPS)
            k3_rows.append(_k3_row(
                f"{label} B={b} R={r} M={m} d={d} steps={STEPS}", m, d, r,
                mask, weights, res, gen))
    # K1 at single-image inference's shapes (M = 6 nouns, M = 1 verb) and
    # at resnet18/34's width
    k1_more = (_k1_rows_at(enc, gen, 1, D, tag="kernel")
               + _k1_rows_at(enc, gen, batch, SMALL_D, tag="kernel"))
    routes = [_route_times(params, mask_case)
              for mask_case in _route_cases(enc, gen, batch)]
    return {"shapes": shapes, "res_shapes": res_shapes,
            "k1_more": k1_more,
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
        # the default artifact (portable programs): on the card its bf16
        # model is served rebuilt, through K1 (fn.model)
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


def _train_batches(enc, seed: int, batch: int, count: int, verbs=None):
    """``count`` host batches of ``batch`` synthetic uint8 windows, verbs
    drawn from the ``synthetic_full`` tables (or each batch a permutation
    of ``verbs``) and labels with the ignore index outside each verb's
    roles."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n_labels, roles = enc.get_num_labels(), enc.max_role_count
    given = verbs
    out = []
    for _ in range(count):
        verbs = rng.integers(0, enc.get_num_verbs(), batch) \
            if given is None else rng.permutation(given)
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


def _profile(label: str, fn, tag: str = "train", top: int = 15,
             host_top: int = 0) -> dict:
    """Device time of ``fn()`` by kernel name (torch.profiler); the
    ``top`` kernels are logged.  Also the device time of NCCL's kernels and
    the host-side events of collectives by name (``nccl:all_reduce``,
    ``c10d::allreduce_`` ...), and with ``host_top`` that many host
    operators by their own host time (logged and returned)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows, collectives, host = [], {}, []
    for ev in prof.key_averages():
        # kernels and copies only: an operator's device time is that of
        # the kernels it launched, which are listed too
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            if "allreduce" in ev.key.lower().replace("_", ""):
                collectives[ev.key] = ev.count
            host.append((ev.self_cpu_time_total / 1e3, ev.count,
                         ev.key[:60]))
            continue
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        if dev_us > 0:
            rows.append((dev_us / 1e3, ev.count, ev.key[:90]))
    rows.sort(reverse=True)
    total = sum(r[0] for r in rows)
    _log(f"[{tag}] profile of {label}: device time {total:.3f} ms over "
         f"{len(rows)} kernel names; top {top}:")
    for ms, count, key in rows[:top]:
        _log(f"[{tag}]   {ms:9.3f} ms  x{count:<5d} {key}")
    host.sort(reverse=True)
    if host_top:
        _log(f"[{tag}] host time of {label} by operator (own time; the "
             f"profiler's own cost included): top {host_top} of "
             f"{sum(r[0] for r in host):.1f} ms")
        for ms, count, key in host[:host_top]:
            _log(f"[{tag}]   host {ms:9.3f} ms  x{count:<5d} {key}")
    return {"device_ms": total,
            "host_top": [{"ms": ms, "count": c, "op": k}
                         for ms, c, k in host[:host_top]],
            "nccl_device_ms": sum(r[0] for r in rows
                                  if "nccl" in r[2].lower()),
            "collectives": collectives,
            "top": [{"ms": ms, "count": c, "kernel": k}
                    for ms, c, k in rows[:25]]}


def _steady_loop(obj, method: str, run, fill: int, unit: int = 1) -> dict:
    """Host-clock timing of ``run()``, a loop that calls ``obj.<method>``
    once a step (a train step or microbatch, an eval batch): the steady
    step is the mean gap between step starts once ``fill`` steps have
    filled the pipeline, over whole groups of ``unit`` steps (a group of
    ``grad_accum`` microbatches takes one optimizer step); the fill (loop
    start to that step) and the drain (the last start to the loop's end)
    apart, and the host's time to enqueue each step."""
    import torch

    starts, dispatch = [], []
    step = getattr(obj, method)

    def timed_step(*args, **kwargs):
        t0 = time.perf_counter()
        starts.append(t0)
        out = step(*args, **kwargs)
        dispatch.append(time.perf_counter() - t0)
        return out

    setattr(obj, method, timed_step)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
    finally:
        delattr(obj, method)
    steps = len(starts)
    gaps = (steps - 1 - fill) // unit * unit
    if gaps <= 0:
        raise SystemExit(f"{steps} calls of {method}: none after the fill "
                         f"of {fill}")
    return {"steps": steps,
            "steady_ms": (starts[fill + gaps] - starts[fill]) * 1e3 / gaps,
            "fill_ms": (starts[fill] - t0) * 1e3,
            "drain_ms": (t1 - starts[-1]) * 1e3,
            "whole_ms_per_step": (t1 - t0) * 1e3 / steps,
            "dispatch_ms": [x * 1e3 for x in dispatch]}


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


# ------------------------------------------------- gradient accumulation

#: microbatches per optimizer step in the accumulation parts; the
#: flagship's timed groups, and the leading calls (microbatches or steps)
#: that fill the pipeline, left out of the steady step (``_steady_loop``)
ACCUM, ACCUM_TIMED_GROUPS, ACCUM_FILL = 2, 20, 4
# a group of two different microbatches A and B against one step on
# [A; B] at twice the batch, bf16, dropout 0, eval-mode BN: the same rows
# through the same kernels.  The noun losses divide by the batch's count
# of labelled roles, so a group's mean of microbatch means (JAX's too)
# equals the big batch's only where the microbatches hold equal counts: B
# takes A's verbs in another order (other windows, flips and labels), and
# exact arithmetic gives the same mean gradient.  It is compared as
# ``apply_step`` hands it to the clip (summed, divided by the count), so
# that the clip cannot hide a wrong sum or count.  A bf16 product's weight
# gradient sums over the batch's rows and is rounded to bf16 once per
# microbatch here, once for the batch there (2^-9 relative per element),
# and cuDNN and cuBLAS may pick other kernels (and f32 sum orders) at the
# two batch sizes, which flips the last bit of bf16 intermediates now and
# then; relative Frobenius error of each tensor's mean gradient, 10x what
# those roundings give.  The verb logits of random weights are bf16 values
# that often tie: such a flip can move a row's argmax verb, and with it
# which rows of the embedding tables its noun branch reaches (one row of
# 128 moves ~10% of verb_emb's gradient), so the check first makes one
# verb decisive (``_decisive_verb``)
ACCUM_GRAD_REL = 2e-2
# its margin over the other verbs' logits (theirs are of order 1)
DECISIVE_MARGIN = 8.0


def _decisive_verb(*trainers) -> None:
    """The same verb the argmax of every row: ``DECISIVE_MARGIN`` added
    to verb 0's classifier bias in each trainer (their heads are equal)."""
    import torch

    for trainer in trainers:
        with torch.no_grad():
            trainer.head.verb_classifier[1].bias[0] += DECISIVE_MARGIN


def _group_grads(trainer, batches) -> tuple:
    """The mean gradient of one group of ``batches`` as ``apply_step``
    hands it to the clip (``accum_step`` sums each batch into ``.grad``,
    ``apply_step`` divides by their count), as f32 copies, and the global
    norm that the clip finds (above 1 the clip scales it down); the
    optimizer step itself runs."""
    import torch

    seen = []
    clip = torch.nn.utils.clip_grad_norm_

    def capture(params, *args, **kwargs):
        seen.append([torch.zeros_like(p, dtype=torch.float32)
                     if p.grad is None else p.grad.detach().float().clone()
                     for p in trainer._trainable])
        norm = clip(params, *args, **kwargs)
        seen.append(float(norm))
        return norm

    torch.nn.utils.clip_grad_norm_ = capture
    try:
        for i, batch in enumerate(batches):
            args, _ = trainer._upload(batch)
            trainer.accum_step(*args, first=i == 0)
        trainer.apply_step(len(batches))
    finally:
        torch.nn.utils.clip_grad_norm_ = clip
    return seen[0], seen[1]


def _grad_rel(got, want, names) -> dict:
    """Relative Frobenius error of each tensor of ``got`` against
    ``want`` (on the card, one tensor at a time)."""
    out = {}
    for name, g, w in zip(names, got, want):
        g, w = g.to(DEVICE), w.to(DEVICE)
        out[name] = ((g - w).norm() / (w.norm() + 1e-30)).item()
    return out


def _cat(*batches) -> dict:
    """[A; B; ...]: host batches stacked into one."""
    import numpy as np

    return {k: np.concatenate([b[k] for b in batches]) for k in batches[0]}


def phase_accum(enc, seed: int, batch: int) -> dict:
    """Gradient accumulation at the flagship (ResNet-152 + FCGGNN, d=2048,
    bf16): ``grad_accum`` 2 at microbatch batch/2 (see the module
    docstring)."""
    import os

    import numpy as np
    import torch

    from situation_recognition_tpu_torch.data.transforms import (
        eval_transform)
    from situation_recognition_tpu_torch.train import Trainer, TrainerConfig

    micro = batch // ACCUM
    t = time.perf_counter()

    def make(b, accum):
        return Trainer(enc, TrainerConfig(
            hidden=D, batch_size=b, backbone=BACKBONE,
            compute_dtype=torch.bfloat16, seed=seed, grad_accum=accum,
            dropout_rate=0.0, frozen_backbone_bn="eval"), device=DEVICE)

    acc, big = make(micro, ACCUM), make(batch, 1)
    host = _train_batches(enc, seed + 7, micro, 8)
    # B for the check: A's verbs in another order (see ACCUM_GRAD_REL)
    b = _train_batches(enc, seed + 8, micro, 1, verbs=host[0]["verbs"])[0]
    _set_bn_statistics(acc.backbone, eval_transform(
        torch.from_numpy(host[0]["images"][:64]).to(DEVICE),
        dtype=torch.bfloat16))
    big.backbone.load_state_dict(acc.backbone.state_dict())
    _phase("accum: trainers + BN statistics", t)
    result = {"micro": micro, "grad_accum": ACCUM, "batch": batch}

    # the group of A and B against the big batch [A; B]
    a = host[0]
    _decisive_verb(acc, big)
    _zero_counts()
    got, got_norm = _group_grads(acc, [a, b])
    torch.cuda.synchronize()
    result["check_launches"] = _counts()
    want, want_norm = _group_grads(big, [_cat(a, b)])
    names = [n for n, _ in acc.head.named_parameters()]
    rel = _grad_rel(got, want, names)
    del got, want
    result["grad_rel"] = rel
    result["grad_rel_max"] = max(rel.values())
    result["tol_grad_rel"] = ACCUM_GRAD_REL
    result["preclip_norm"] = {"accum": got_norm, "batch": want_norm}
    _log("[accum] a group of A and B vs one step on [A; B]: " + json.dumps(
        {"grad_rel_max": result["grad_rel_max"], "tol": ACCUM_GRAD_REL,
         "preclip_norm": result["preclip_norm"],
         "launches": result["check_launches"]}))
    if result["grad_rel_max"] > ACCUM_GRAD_REL:
        raise SystemExit(f"the accumulated gradient differs from the big "
                         f"batch's: {rel}")

    # launches of one microbatch under each GGNN backward route
    old_env = os.environ.get("SRTPU_GGNN_BWD")
    per_micro = {}
    try:
        for route in ("xla", "pallas"):
            os.environ["SRTPU_GGNN_BWD"] = route
            args, _ = acc._upload(host[1])
            torch.cuda.synchronize()
            _zero_counts()
            acc.accum_step(*args, first=True)
            torch.cuda.synchronize()
            per_micro[route] = _counts()
    finally:
        if old_env is None:
            os.environ.pop("SRTPU_GGNN_BWD", None)
        else:
            os.environ["SRTPU_GGNN_BWD"] = old_env
    result["launches_per_microbatch"] = per_micro
    acc.optimizer.zero_grad(set_to_none=True)
    for route, k23 in (("xla", 0), ("pallas", 2)):
        if per_micro[route] != {"K1": 1, "K2": k23, "K3": k23}:
            raise SystemExit(f"launches per microbatch under {route}: "
                             f"{per_micro[route]}, want K1 1, K2/K3 {k23}")

    # three microbatches end an epoch in two optimizer steps
    steps0, count0 = acc.opt_steps, acc.step_count
    _, _, losses = acc.train_epoch(host[1:4], 0)
    result["three_micro"] = {"opt_steps": acc.opt_steps - steps0,
                             "step_count": acc.step_count - count0,
                             "losses": list(losses)}
    if result["three_micro"]["opt_steps"] != 2 or \
            result["three_micro"]["step_count"] != 3:
        raise SystemExit(f"3 microbatches at grad_accum {ACCUM}: "
                         f"{result['three_micro']}")
    if not np.isfinite(losses).all():
        raise SystemExit(f"non-finite accumulation losses {losses}")

    # throughput with the reference's train-mode BN: grad_accum 2 at the
    # microbatch against grad_accum 1 at the batch, the same rows; the
    # steady optimizer step of each loop, and a profiled one's device time
    for tr in (acc, big):
        tr.config.frozen_backbone_bn = "train"
    micros = [host[i % len(host)]
              for i in range(ACCUM * ACCUM_TIMED_GROUPS)]
    bigs = [_cat(*micros[ACCUM * i:ACCUM * (i + 1)])
            for i in range(ACCUM_TIMED_GROUPS)]
    acc.train_epoch(micros[:ACCUM], 0)                  # warm
    big.train_epoch(bigs[:1], 0)
    timed = {}
    for name, tr, loader, unit in (("accum", acc, micros, ACCUM),
                                   ("batch", big, bigs, 1)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        run = _steady_loop(tr, "accum_step",
                           lambda: tr.train_epoch(loader, 1), ACCUM_FILL,
                           unit)
        launches = _counts()
        step_ms = run["steady_ms"] * unit
        prof = _profile(f"one optimizer step ({name})",
                        lambda: tr.train_epoch(loader[:unit], 2),
                        tag="accum", top=5)
        timed[name] = {"ms_per_optimizer_step": step_ms,
                       "img_per_s": batch * 1e3 / step_ms,
                       "groups": run["steps"] // unit,
                       "fill_ms": run["fill_ms"], "drain_ms": run["drain_ms"],
                       "peak_mem_gb": torch.cuda.max_memory_allocated()
                       / 1e9, "launches": launches,
                       "device_ms": prof["device_ms"],
                       "idle_share": (step_ms - prof["device_ms"]) / step_ms}
    result["timed"] = timed
    result["launches"] = timed["accum"]["launches"]
    _log("[accum] " + json.dumps(result))
    if result["launches"] != {"K1": ACCUM * ACCUM_TIMED_GROUPS, "K2": 0,
                              "K3": 0}:
        raise SystemExit(f"accumulation launches {result['launches']}")
    _log(f"[accum] grad_accum {ACCUM} at {micro}, steady over "
         f"{ACCUM_TIMED_GROUPS} groups less the fill: "
         f"{timed['accum']['img_per_s']:.1f} img/s "
         f"({timed['accum']['ms_per_optimizer_step']:.2f} ms an optimizer "
         f"step, device {timed['accum']['device_ms']:.2f} ms, idle "
         f"{100 * timed['accum']['idle_share']:.1f}%) against batch {batch}: "
         f"{timed['batch']['img_per_s']:.1f} img/s "
         f"({timed['batch']['ms_per_optimizer_step']:.2f} ms, device "
         f"{timed['batch']['device_ms']:.2f} ms, idle "
         f"{100 * timed['batch']['idle_share']:.1f}%)")
    del acc, big
    torch.cuda.empty_cache()
    return result


# ------------------------------------------------------- the other ResNets

#: resnet18/34/50/101 at their published widths: the train steps and eval
#: batches of one loop each (after a warm one), the leading ones that fill
#: the pipeline left out of the steady step (``_steady_loop``)
RESNETS = ("resnet18", "resnet34", "resnet50", "resnet101")
RESNET_STEPS, RESNET_FILL = 20, 4


def phase_resnets(enc, seed: int, batch: int) -> dict:
    """Each of ``RESNETS`` at its published width and depth + FCGGNN
    (head width 512 for the BasicBlock stacks, 2048 otherwise), bf16,
    batch ``batch``, random weights from ``seed``: a warm train step, then
    ``RESNET_STEPS`` train steps in one ``train_epoch``; a warm eval
    batch, then ``RESNET_STEPS`` in one ``evaluate``.  Finite losses, K1
    once a train step and 3 times an eval batch, train and eval img/s of
    the steady loops, and the device time of a profiled train step and
    eval batch beside them (the idle share)."""
    import numpy as np
    import torch

    from situation_recognition_tpu_torch.cli import _default_hidden
    from situation_recognition_tpu_torch.train import Trainer, TrainerConfig

    host = _train_batches(enc, seed + 11, batch, 2)
    loader = [host[i % 2] for i in range(RESNET_STEPS)]
    out = {}
    for name in RESNETS:
        t = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        trainer = Trainer(enc, TrainerConfig(
            hidden=_default_hidden(name), batch_size=batch, backbone=name,
            compute_dtype=torch.bfloat16, seed=seed), device=DEVICE)
        if trainer.head.ggsnn.impl != "kernel":
            raise SystemExit(f"the {name} trainer did not resolve to the "
                             f"GGNN kernels")
        row = {"hidden": trainer.config.hidden}
        losses = {}
        for kind, method, fn in (
                ("train", "accum_step",
                 lambda bs: trainer.train_epoch(bs, 1)[2]),
                ("eval", "eval_step", lambda bs: trainer.evaluate(bs)[2])):
            fn(loader[:1])                                  # warm
            _zero_counts()

            def run():
                losses[kind] = fn(loader)

            loop = _steady_loop(trainer, method, run, RESNET_FILL)
            row[f"{kind}_launches"] = _counts()
            row[f"{kind}_ms"] = loop["steady_ms"]
            row[f"{kind}_img_per_s"] = batch * 1e3 / loop["steady_ms"]
            prof = _profile(f"one {name} {kind} batch",
                            lambda: fn(loader[:1]), tag="resnets", top=5)
            row[f"{kind}_device_ms"] = prof["device_ms"]
            row[f"{kind}_idle_share"] = \
                (loop["steady_ms"] - prof["device_ms"]) / loop["steady_ms"]
        row["losses"] = [list(losses["train"]),
                         [float(v) for v in losses["eval"].values()]]
        row["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        out[name] = row
        _log(f"[resnets] {name} " + json.dumps(row))
        _phase(f"resnets: {name}", t)
        if not np.isfinite(np.asarray(row["losses"])).all():
            raise SystemExit(f"non-finite {name} losses {row['losses']}")
        if row["train_launches"] != {"K1": RESNET_STEPS, "K2": 0,
                                     "K3": 0} or row["eval_launches"] != {
                "K1": 3 * RESNET_STEPS, "K2": 0, "K3": 0}:
            raise SystemExit(f"{name} launches: train "
                             f"{row['train_launches']}, eval "
                             f"{row['eval_launches']}")
        del trainer
        torch.cuda.empty_cache()
    _log("[resnets] steady over " + f"{RESNET_STEPS} batches less "
         f"{RESNET_FILL}: " + ", ".join(
             f"{n} (d={r['hidden']}) train {r['train_img_per_s']:.1f} img/s"
             f" (idle {100 * r['train_idle_share']:.1f}%), eval "
             f"{r['eval_img_per_s']:.1f} img/s (idle "
             f"{100 * r['eval_idle_share']:.1f}%)" for n, r in out.items()))
    return out


# ------------------------------------------------------------- the CLI path

#: the synthetic imSitu folder of the CLI phase: train images, and dev and
#: test images (test reuses dev's images under other annotations)
CLI_TRAIN, CLI_EVAL = 2 * BATCH, BATCH
#: timed host-to-device copies of one batch of windows, pageable vs pinned
UPLOAD_REPS = 10
#: timed steps of the CLI trainer's loop on in-memory batches (cycling
#: through CLI_LOOP_BATCHES host batches), the leading ones that fill the
#: pipeline left out of the steady step, and the eval loop's batches
CLI_LOOP_STEPS, CLI_LOOP_BATCHES, CLI_LOOP_FILL = 20, 4, 4
CLI_EVAL_STEPS = 10
#: epochs of the packed train split read by the loader alone
CLI_LOADER_EPOCHS = 3


def _synthetic_imsitu(root: str, enc, seed: int, n_train: int,
                      n_eval: int) -> dict:
    """An imSitu folder under ``root``: ``train.json`` whose images take
    the verbs of ``enc`` in turn (every verb appears once there are as
    many images as verbs) with their roles, and whose frames take the
    labels of ``enc`` in turn (every label appears); ``dev.json`` and
    ``test.json`` with random verbs and labels; the images a packed store
    of 256² uint8 windows made with numpy (no JPEG)."""
    import numpy as np

    from situation_recognition_tpu_torch.data.dataset import write_packed

    rng = np.random.default_rng(seed)
    verbs, labels = enc.verb_list, enc.label_list
    counter = 0

    def record(verb, pick):
        nonlocal counter
        frames = []
        for _ in range(3):
            frame = {}
            for role in enc.roles_per_verb[verb]:
                frame[role] = pick()
                counter += 1
            frames.append(frame)
        return {"verb": verb, "frames": frames}

    train = {f"train{i}.jpg": record(
        verbs[i % len(verbs)], lambda: labels[counter % len(labels)])
        for i in range(n_train)}
    # dev and test draw from what train holds (all of it at full size)
    n_verbs, n_labels = min(n_train, len(verbs)), min(counter, len(labels))
    dev = {f"eval{i}.jpg": record(
        verbs[int(rng.integers(n_verbs))],
        lambda: labels[int(rng.integers(n_labels))])
        for i in range(n_eval)}
    test = {name: record(verbs[int(rng.integers(n_verbs))],
                         lambda: labels[int(rng.integers(n_labels))])
            for name in dev}
    folder = os.path.join(root, "imSitu")
    os.makedirs(folder)
    for name, ann in (("train", train), ("dev", dev), ("test", test)):
        with open(os.path.join(folder, name + ".json"), "w") as f:
            json.dump(ann, f)
    packed = os.path.join(root, "packed")
    write_packed(packed, ((name, rng.integers(0, 256, (256, 256, 3),
                                              dtype=np.uint8))
                          for name in list(train) + list(dev)))
    return {"dataset": folder, "packed": packed,
            "bytes": os.path.getsize(os.path.join(packed, "images.bin"))}


def _upload_ms(batch: int) -> dict:
    """One batch of 256² uint8 windows to the card: a pageable host array
    (``.to``) against a pinned one (``non_blocking``), CUDA-event times."""
    import numpy as np
    import torch

    host = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (batch, 256, 256, 3), dtype=np.uint8))
    pinned = host.pin_memory()
    out = {}
    for name, src, kw in (("pageable", host, {}),
                          ("pinned", pinned, {"non_blocking": True})):
        out[name + "_ms"] = _time_ms(lambda: src.to(DEVICE, **kw),
                                     UPLOAD_REPS)
    out["bytes"] = host.numel()
    out["pinned_gb_per_s"] = host.numel() / out["pinned_ms"] / 1e6
    return out


def _run_cli(argv) -> str:
    """``cli.main(argv)`` in this process → its stdout (echoed)."""
    import contextlib
    import io

    from situation_recognition_tpu_torch import cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(argv)
    text = out.getvalue()
    for line in text.splitlines():
        _log(f"[cli] | {line}")
    return text


_STATS = re.compile(r"verb count: (\d+).*?role count: (\d+).*?"
                    r"label count: (\d+).*?max role count: (\d+)", re.S)
_LOSSES = re.compile(r"losses = \[v: (\S+), n: (\S+), gt: (\S+)\]")
_SCORE = re.compile(r"(?:1-|5-|gt-)[\w-]+: (-?[\d.]+|nan|inf)")


def _check_transcript(text: str, tag: str) -> dict:
    """Finite losses and scores in [0, 100] in a CLI transcript."""
    import numpy as np

    losses = [float(x) for m in _LOSSES.findall(text) for x in m]
    scores = [float(x) for x in _SCORE.findall(text)]
    if not losses or not np.isfinite(losses).all():
        raise SystemExit(f"{tag}: losses missing or not finite: {losses}")
    if not scores or not all(0 <= s <= 100 for s in scores):
        raise SystemExit(f"{tag}: scores missing or out of [0, 100]: "
                         f"{scores}")
    return {"losses": losses, "scores": scores}


def _assert_bit_equal(a, b, path="") -> None:
    import torch

    if torch.is_tensor(a):
        if not (torch.is_tensor(b) and a.dtype == b.dtype
                and a.shape == b.shape and torch.equal(a.cpu(), b.cpu())):
            raise SystemExit(f"checkpoint save/load/save differs at {path}")
    elif isinstance(a, dict):
        if not isinstance(b, dict) or list(a) != list(b):
            raise SystemExit(f"checkpoint keys differ at {path}")
        for k in a:
            _assert_bit_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        if not isinstance(b, (list, tuple)) or len(a) != len(b):
            raise SystemExit(f"checkpoint lengths differ at {path}")
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_bit_equal(x, y, f"{path}[{i}]")
    elif a != b:
        raise SystemExit(f"checkpoint differs at {path}: {a} vs {b}")


def phase_cli(enc, seed: int, batch: int, card: str) -> dict:
    """The reference CLI's path (see the module docstring): train, resume
    and evaluate through ``cli.main`` on a synthetic imSitu folder."""
    import numpy as np
    import torch

    from situation_recognition_tpu_torch import cli
    from situation_recognition_tpu_torch.data.dataset import (
        ImsituDataset, ImsituLoader)
    from situation_recognition_tpu_torch.data.encoder import ImsituEncoder
    from situation_recognition_tpu_torch.train import Trainer, TrainerConfig
    from situation_recognition_tpu_torch.utils.checkpoint import (
        HISTORY_KEYS, load_checkpoint, save_checkpoint)

    t_phase = time.perf_counter()
    result = {"card": card, "batch": batch, "launches": {}}
    n_train = CLI_TRAIN * batch // BATCH
    n_eval = CLI_EVAL * batch // BATCH
    timings = []
    trainers = []
    real = {"train_epoch": Trainer.train_epoch, "evaluate": Trainer.evaluate,
            "fit": Trainer.fit, "reserve": cli._working_reserve}
    reserves = []

    def timed(kind):
        def wrapper(self, loader, *args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real[kind](self, loader, *args, **kwargs)
            torch.cuda.synchronize()
            timings.append({"kind": kind, "seconds":
                            time.perf_counter() - t0,
                            "images": len(loader.dataset)})
            return out
        return wrapper

    def keep(self, *args, **kwargs):
        trainers.append(self)
        return real["fit"](self, *args, **kwargs)

    def reserve(*args, **kwargs):
        # the probe's own train step runs with the timers off
        Trainer.train_epoch = real["train_epoch"]
        Trainer.evaluate = real["evaluate"]
        try:
            reserves.append(real["reserve"](*args, **kwargs))
        finally:
            Trainer.train_epoch = timed("train_epoch")
            Trainer.evaluate = timed("evaluate")
        return reserves[-1]

    with tempfile.TemporaryDirectory(prefix="srtorch_cli_") as root:
        t = time.perf_counter()
        data = _synthetic_imsitu(root, enc, seed, n_train, n_eval)
        result["packed_bytes"] = data["bytes"]
        _phase("cli: synthetic imSitu folder", t)
        saving = os.path.join(root, "checkpoints")
        metrics = os.path.join(root, "metrics.jsonl")
        common = ["--backbone", BACKBONE, "--batch_size", str(batch),
                  "--dataset_folder", data["dataset"],
                  "--imgset_dir", os.path.join(root, "unused"),
                  "--packed_dir", data["packed"], "--saving_folder", saving,
                  "--seed", str(seed), "--num_workers", "4"]
        if DEVICE == "cpu":
            common += ["--platform", "cpu"]
        runs = {
            "train": common + ["--epochs", "1", "--save_steps", "1",
                               "--keep_best", "--metrics_jsonl", metrics],
            "resume": common + ["--resume_model", "sr", "--epochs", "2",
                                "--cache_device"],
            "evaluate": common + ["--evaluate_dev", "--resume_model", "sr"]}
        want = {"train": -(-n_train // batch) + 3 * -(-n_eval // batch)}
        # --cache_device's memory probe takes two train steps
        want["resume"] = want["train"] + 2 * (DEVICE == "cuda")
        want["evaluate"] = 3 * -(-n_eval // batch)
        texts, histories, used = {}, {}, {}
        Trainer.train_epoch = timed("train_epoch")
        Trainer.evaluate = timed("evaluate")
        Trainer.fit = keep
        cli._working_reserve = reserve
        try:
            for name, argv in runs.items():
                t = time.perf_counter()
                torch.cuda.synchronize()
                base = torch.cuda.memory_reserved()
                torch.cuda.reset_peak_memory_stats()
                _zero_counts()
                texts[name] = _run_cli(argv)
                torch.cuda.synchronize()
                used[name] = torch.cuda.max_memory_reserved() - base
                result["launches"][name] = _counts()
                _phase(f"cli: {name}", t)
                if name != "evaluate":
                    ck = load_checkpoint(os.path.join(saving, "sr"))
                    histories[name] = {k: ck[k] for k in HISTORY_KEYS}
                    del ck
                if name == "train":
                    trainers.clear()
                torch.cuda.empty_cache()
        finally:
            Trainer.train_epoch = real["train_epoch"]
            Trainer.evaluate = real["evaluate"]
            Trainer.fit = real["fit"]
            cli._working_reserve = real["reserve"]

        # the vocabulary, the transcripts and the histories
        stats = tuple(int(x) for x in _STATS.search(texts["train"]).groups())
        result["stats"] = stats
        if n_train >= len(enc.verb_list) and stats != (504, 190, 2001, 6):
            raise SystemExit(f"the encoder's widths are {stats}, not the "
                             f"flagship's (504, 190, 2001, 6)")
        for name, text in texts.items():
            result[name] = _check_transcript(text, f"cli {name}")
        if "Epoch-1, lr: " not in texts["resume"] \
                or "Epoch-0" in texts["resume"]:
            raise SystemExit("the resume did not continue at epoch 1")
        for k in HISTORY_KEYS:
            a, b = histories["train"][k], histories["resume"][k]
            if len(a) != 1 or len(b) != 2 or b[:1] != a:
                raise SystemExit(f"history {k}: {a} then {b}")
        if not os.path.exists(os.path.join(saving, "sr_best")):
            raise SystemExit("--keep_best wrote no sr_best")
        with open(metrics) as f:
            if len(f.read().splitlines()) != 1:
                raise SystemExit("--metrics_jsonl has not one record")
        _log("[cli] launches " + json.dumps(result["launches"]))
        for name, count in result["launches"].items():
            if count != {"K1": want[name], "K2": 0, "K3": 0}:
                raise SystemExit(f"launches in the cli {name} run: {count},"
                                 f" want K1 {want[name]} (1 a train step, 3"
                                 f" an eval batch)")

        # --cache_device's reserve (measured by its probe step) against
        # the device memory each run took beside its window arrays: the
        # streamed train run (a) and the cached resume (b) within it
        windows = (n_train + n_eval) * 256 * 256 * 3
        result["memory_gb"] = {
            "reserve": reserves[0] / 1e9 if reserves else None,
            "train_streamed": used["train"] / 1e9,
            "resume_cached_less_windows": (used["resume"] - windows) / 1e9,
            "evaluate_streamed": used["evaluate"] / 1e9,
            "windows": windows / 1e9}
        if DEVICE == "cuda":
            if len(reserves) != 1:
                raise SystemExit(f"--cache_device measured {len(reserves)}"
                                 f" reserves in the resume, want 1")
            for name, took in (("train", used["train"]),
                               ("resume", used["resume"] - windows)):
                if took > reserves[0]:
                    raise SystemExit(
                        f"the cli {name} run took {took / 1e9:.2f} GB of "
                        f"device memory beside its windows, more than the "
                        f"{reserves[0] / 1e9:.2f} GB --cache_device "
                        f"reserved")

        # the CLI's epochs (one and two steps: fill and drain included):
        # the first streams pinned uploads (and writes a snapshot after
        # each step), the resumed one gathers from the device window cache
        epochs = [x for x in timings if x["kind"] == "train_epoch"]
        evals = [x for x in timings if x["kind"] == "evaluate"]
        result["train_img_per_s"] = {
            "streamed_with_snapshots": epochs[0]["images"]
            / epochs[0]["seconds"],
            "cached": epochs[-1]["images"] / epochs[-1]["seconds"]}
        result["eval_img_per_s"] = {
            "cached": evals[-2]["images"] / evals[-2]["seconds"],
            "streamed": evals[-1]["images"] / evals[-1]["seconds"]}
        result["upload"] = _upload_ms(batch)

        # the loader alone on the packed train split (crop, flip, pad on
        # the host; no JPEG): the first batch of an epoch (its workers
        # start) apart from the others
        with open(os.path.join(data["dataset"], "train.json")) as f:
            ds = ImsituDataset(os.path.join(root, "unused"), json.load(f),
                               trainers[-1].encoder, train=True)
        ds.enable_packed(data["packed"])
        reader = ImsituLoader(ds, batch_size=batch, shuffle=True,
                              seed=seed, num_workers=4)
        first, later = [], []
        for epoch in range(CLI_LOADER_EPOCHS):
            reader.set_epoch(epoch)
            t = time.perf_counter()
            for i, _ in enumerate(reader):
                (later if i else first).append(
                    (time.perf_counter() - t) * 1e3)
                t = time.perf_counter()
        result["loader_ms_per_batch"] = {"first": first, "later": later}
        del ds, reader

        # the CLI trainer's step loop on in-memory batches (uploads through
        # the pinned side stream, no snapshots), timed by _steady_loop
        trainer = trainers[-1]
        host = _train_batches(trainer.encoder, seed + 5, batch,
                              CLI_LOOP_BATCHES)
        loader = [host[i % len(host)] for i in range(CLI_LOOP_STEPS)]
        trainer.train_epoch(loader[:1], 99)            # warm
        result["loop"] = _steady_loop(
            trainer, "accum_step", lambda: trainer.train_epoch(loader, 100),
            CLI_LOOP_FILL)
        result["eval_loop"] = _steady_loop(
            trainer, "eval_step",
            lambda: trainer.evaluate(loader[:CLI_EVAL_STEPS]), CLI_LOOP_FILL)
        steady = result["loop"]["steady_ms"]
        result["loop_img_per_s"] = batch * 1e3 / steady
        result["eval_loop_img_per_s"] = \
            batch * 1e3 / result["eval_loop"]["steady_ms"]
        prof = _profile("one CLI-trainer train step",
                        lambda: trainer.train_epoch(loader[:1], 101),
                        tag="cli")
        result["step_device_ms"] = prof["device_ms"]
        result["idle_ms_per_step"] = steady - prof["device_ms"]
        result["idle_share"] = result["idle_ms_per_step"] / steady
        trainers.clear()
        del trainer, loader, host
        torch.cuda.empty_cache()

        # the checkpoint: strict loads into a fresh model, and a save /
        # load / save on the card is bit-equal
        from situation_recognition_tpu_torch.convert import from_reference

        path = os.path.join(saving, "sr")
        result["checkpoint_bytes"] = os.path.getsize(path)
        cfg = TrainerConfig(hidden=D if BACKBONE == "resnet152" else 64,
                            batch_size=batch, backbone=BACKBONE,
                            compute_dtype=torch.bfloat16 if DEVICE == "cuda"
                            else torch.float32, seed=seed + 1)
        t = time.perf_counter()
        ck = load_checkpoint(path)
        fresh = Trainer(ImsituEncoder.load(os.path.join(saving, "encoder")),
                        cfg, device=DEVICE)
        bb, head = from_reference(ck["model_state_dict"])
        fresh.backbone.load_state_dict(bb, strict=True)
        fresh.head.load_state_dict(head, strict=True)
        fresh.load_model_state(ck)
        torch.cuda.synchronize()
        result["load_s"] = time.perf_counter() - t
        t = time.perf_counter()
        again = os.path.join(root, "again")
        own = fresh.model_state_dict()
        # the epoch and the histories are the fit loop's, copied through
        save_checkpoint(again, {"epoch": ck["epoch"],
                                **{k: ck[k] for k in HISTORY_KEYS}, **own})
        result["save_s"] = time.perf_counter() - t
        back = load_checkpoint(again)
        checked = ("model_state_dict", "optimizer_state_dict", "step_count",
                   "opt_steps")
        if sorted(own) != sorted(checked):
            raise SystemExit(f"the trainer's checkpoint state has keys "
                             f"{sorted(own)}, want {sorted(checked)}")
        for key in checked:
            _assert_bit_equal(ck[key], back[key], key)
        result["save_load_save"] = "bit-equal"
        del fresh, ck, back
        torch.cuda.empty_cache()
        result.update(_cli_accum_and_inference(root, data, saving, common,
                                               enc, batch))
    result["phase_s"] = time.perf_counter() - t_phase
    _log("[cli] " + json.dumps(result))
    run, ev, mem = result["loop"], result["eval_loop"], result["memory_gb"]
    disp = run["dispatch_ms"][CLI_LOOP_FILL:]
    _log(f"[cli] {card}: CLI train epochs (fill included) "
         f"{result['train_img_per_s']['streamed_with_snapshots']:.1f} img/s"
         f" streamed with snapshots, {result['train_img_per_s']['cached']:.1f}"
         f" cached; eval {result['eval_img_per_s']['cached']:.1f} img/s "
         f"cached / {result['eval_img_per_s']['streamed']:.1f} streamed; "
         f"step loop over {run['steps']} steps: steady "
         f"{run['steady_ms']:.2f} ms/step ({result['loop_img_per_s']:.1f} "
         f"img/s; the host enqueues a steady step in {min(disp):.2f}-"
         f"{max(disp):.2f} ms), fill {run['fill_ms']:.1f} ms for "
         f"{CLI_LOOP_FILL} steps, drain {run['drain_ms']:.1f} ms; device "
         f"{result['step_device_ms']:.2f} ms, idle "
         f"{result['idle_ms_per_step']:.2f} ms "
         f"({100 * result['idle_share']:.1f}%); eval loop over "
         f"{ev['steps']} batches: steady {ev['steady_ms']:.2f} ms/batch "
         f"({result['eval_loop_img_per_s']:.1f} img/s); packed loader "
         f"{min(result['loader_ms_per_batch']['later']):.1f}-"
         f"{max(result['loader_ms_per_batch']['later']):.1f} ms/batch "
         f"(first of an epoch {max(result['loader_ms_per_batch']['first']):.1f}"
         f"); device memory beside the windows: reserve "
         f"{mem['reserve'] or 0:.2f} GB, train run {mem['train_streamed']:.2f},"
         f" cached resume {mem['resume_cached_less_windows']:.2f}; upload of a "
         f"batch {result['upload']['pinned_ms']:.3f} ms pinned vs "
         f"{result['upload']['pageable_ms']:.3f} pageable; checkpoint "
         f"{result['checkpoint_bytes'] / 1e6:.1f} MB, save "
         f"{result['save_s']:.2f} s, load {result['load_s']:.2f} s; phase "
         f"{result['phase_s']:.1f} s")
    return result


#: per-image latency: calls of single-image inference (predicted verb,
#: then its nouns) timed after the CLI's inference runs, the first left out
INFER_REPS = 10
_PIL = re.compile(r"<PIL\.[\w.]+ image ")


def _transcript_form(text: str) -> list:
    """An inference transcript's form from its first ``&`` or "No ground
    truth" line: numbers, addresses and image names masked, the verb and
    role lines (whose count and names follow the weights) as markers."""
    lines = text.splitlines()
    start = next(i for i, x in enumerate(lines)
                 if x.startswith(("&", "No ground truth")))
    out = []
    for x in lines[start:]:
        x = re.sub(r"0x[0-9A-Fa-f]{6,}", "0xADDR", x)
        x = re.sub(r"-?\d+\.\d+|\d+", "#", _PIL.sub("<PIL image ", x))
        if x.startswith("Analizing: "):
            x = "Analizing: NAME"
        elif x.startswith("action"):
            x = x.split(":")[0] + ": VERB"
        elif re.fullmatch(r"\S+ \(#%\): \S.*", x):
            x = "ROLES"
        elif re.fullmatch(r"\S+ = \[.*\]", x):
            x = "GROUND TRUTH ROLES"
        if x in ("ROLES", "GROUND TRUTH ROLES") and out and out[-1] == x:
            continue
        out.append(x)
    return out


def _cli_accum_and_inference(root: str, data: dict, saving: str, common,
                             enc, batch: int) -> dict:
    """The CLI's ``--grad_accum 2`` training run (snapshots at group ends
    only) and its inference modes on the trained checkpoint: ``--test_img``
    without and with ``--verb``, ``--subset 2`` (K1 twice an image for a
    predicted verb, once for a given one), each transcript in the form of
    its golden (``tests/golden``); then the per-image latency of the
    inference (``INFER_REPS`` calls on the last run's trainer)."""
    import numpy as np
    import torch
    from PIL import Image

    from situation_recognition_tpu_torch import inference
    from situation_recognition_tpu_torch import train as train_mod
    from situation_recognition_tpu_torch.data.transforms import host_window
    from situation_recognition_tpu_torch.utils.checkpoint import (
        load_checkpoint)

    out = {"launches_more": {}}
    # imsitu_space.json, read from the working directory's imSitu/ (the
    # reference's quirk): the glosses of every label, every verb's roles
    with open(os.path.join(data["dataset"], "imsitu_space.json"),
              "w") as f:
        json.dump({"nouns": {lab: {"gloss": [lab + "_gloss"]}
                             for lab in enc.label_list
                             if lab not in ("", "UNK")},
                   "verbs": {v: {"roles": {r: {} for r in roles}}
                             for v, roles in enc.roles_per_verb.items()}},
                  f)
    image = os.path.join(root, "test.jpg")
    Image.fromarray(np.random.default_rng(3).integers(
        0, 256, (256, 256, 3), dtype=np.uint8)).save(image, quality=95)

    def at(folder):
        argv = list(common)
        argv[argv.index("--saving_folder") + 1] = folder
        return argv

    # --grad_accum 2: microbatch batch/2, snapshots at group ends only
    mids = []
    real_save = train_mod.AsyncSaver.save

    def save(self, path, state, *args, **kwargs):
        if "mid" in state:
            mids.append(state["mid"]["batch_in_epoch"])
        return real_save(self, path, state, *args, **kwargs)

    accum_folder = os.path.join(root, "accum")
    t = time.perf_counter()
    train_mod.AsyncSaver.save = save
    try:
        _zero_counts()
        text = _run_cli(at(accum_folder) + ["--epochs", "1", "--save_steps",
                                            "1", "--grad_accum", "2"])
        torch.cuda.synchronize()
        out["launches_more"]["grad_accum"] = _counts()
    finally:
        train_mod.AsyncSaver.save = real_save
    _phase("cli: --grad_accum 2", t)
    micro = batch // 2
    sizes = {}
    for split in ("train", "dev"):
        with open(os.path.join(data["dataset"], split + ".json")) as f:
            sizes[split] = len(json.load(f))
    n_train, n_eval = sizes["train"], sizes["dev"]
    micros = -(-n_train // micro)
    ck = load_checkpoint(os.path.join(accum_folder, "sr"))
    out["grad_accum_run"] = {
        "snapshots_after": mids, "opt_steps": ck["opt_steps"],
        "step_count": ck["step_count"],
        "transcript": _check_transcript(text, "cli --grad_accum")}
    del ck
    want_mids = list(range(2, micros + 1, 2))
    if mids != want_mids or out["grad_accum_run"]["opt_steps"] != \
            -(-micros // 2) or out["grad_accum_run"]["step_count"] != micros:
        raise SystemExit(f"the --grad_accum 2 run: {out['grad_accum_run']}"
                         f", want snapshots after {want_mids}")
    want_k1 = micros + 3 * -(-n_eval // micro)
    if out["launches_more"]["grad_accum"] != {"K1": want_k1, "K2": 0,
                                              "K3": 0}:
        raise SystemExit(f"launches of the --grad_accum run "
                         f"{out['launches_more']['grad_accum']}, want K1 "
                         f"{want_k1}")

    # the inference modes on the trained checkpoint, from the folder's
    # root (imSitu/imsitu_space.json)
    trainers = []
    real_predict = inference._predict

    def predict(trainer, window, verb_id=None):
        trainers.append(trainer)
        return real_predict(trainer, window, verb_id)

    verb = enc.verb_list[int(np.argmax(enc.role_counts))]
    modes = {"test_img": (["--test_img", image], "test_img_pred.txt", 2),
             "test_img_verb": (["--test_img", image, "--verb", verb],
                               "test_img_verb.txt", 1),
             "subset": (["--subset", "2"], "subset.txt", 4)}
    cwd = os.getcwd()
    inference._predict = predict
    os.chdir(root)
    try:
        for name, (flags, golden, k1) in modes.items():
            t = time.perf_counter()
            _zero_counts()
            text = _run_cli(at(saving) + ["--resume_model", "sr"] + flags)
            torch.cuda.synchronize()
            out["launches_more"][name] = _counts()
            out[name + "_s"] = time.perf_counter() - t
            _phase(f"cli: {' '.join(flags)}", t)
            with open(os.path.join(_REPO, "tests", "golden", golden)) as f:
                want = _transcript_form(f.read())
            got = _transcript_form(text)
            if got != want:
                raise SystemExit(f"the {name} transcript's form {got} is "
                                 f"not the golden's {want}")
            if out["launches_more"][name] != {"K1": k1, "K2": 0, "K3": 0}:
                raise SystemExit(f"launches of {name}: "
                                 f"{out['launches_more'][name]}, want K1 "
                                 f"{k1}")
    finally:
        os.chdir(cwd)
        inference._predict = real_predict

    # per-image latency: window upload, the backbone at batch 1, K1 at
    # M = 1 and M = 6, the logits back to the host
    trainer = trainers[-1]
    window = host_window(np.asarray(Image.open(image)), train=False)[None]
    lat = []
    for _ in range(INFER_REPS + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        real_predict(trainer, window)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    out["infer_ms_per_image"] = lat[1:]
    del trainer, trainers
    torch.cuda.empty_cache()
    _log(f"[cli] --grad_accum 2: snapshots after microbatches {mids}; "
         f"single-image inference {min(lat[1:]):.2f}-{max(lat[1:]):.2f} ms "
         f"an image (predicted verb: 2 K1 launches); the inference runs "
         f"{out['test_img_s']:.1f} / {out['test_img_verb_s']:.1f} / "
         f"{out['subset_s']:.1f} s whole (trainer built, checkpoint "
         f"loaded)")
    return out


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


def _k1_rows_at(enc, gen, batch: int, d: int, tag: str = "vit") -> list:
    """K1 against its twin at the noun and verb shapes of a head of width
    ``d``, timed, with its bound (batch 1: single-image inference's M = 6
    and M = 1)."""
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
        _log(f"[{tag}] K1 " + json.dumps(row))
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
        # the default artifact (portable programs): on the card its bf16
        # model is served rebuilt, through the kernels (fn.model)
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


#: the fine-tuning accumulation's timed loop: groups (steps of the batch
#: trainer), and the leading calls left out as its fill
VIT_FT_ACCUM_GROUPS, VIT_FT_ACCUM_FILL = 8, 2


def phase_vit_ft_accum(enc, seed: int, batch: int) -> dict:
    """Fine-tuning ViT-L/14 + FCGGNN with ``remat_backbone`` and
    ``grad_accum`` 2 at microbatch batch/2 against one step at ``batch``
    (dropout 0, bf16), each trainer alone on the card: a group of two
    different microbatches A and B against a step on [A; B] — the mean
    gradient of every head and backbone tensor as the clip receives it —
    then a loop of ``VIT_FT_ACCUM_GROUPS`` groups (steps) with its launches
    (K7 48 and K8 24 a microbatch), its steady optimizer step and its peak
    memory.  ``--cache_device``'s reserve, probed for the accumulating
    configuration, must cover what the accumulating trainer took."""
    import numpy as np
    import torch

    from situation_recognition_tpu_torch.cli import _working_reserve
    from situation_recognition_tpu_torch.train import Trainer, TrainerConfig

    micro = batch // ACCUM
    a = _train_batches(enc, seed + 9, micro, 1)[0]
    b = _train_batches(enc, seed + 10, micro, 1, verbs=a["verbs"])[0]
    runs, grads = {}, {}
    for name, size, accum, group in (("accum", micro, ACCUM, [a, b]),
                                     ("batch", batch, 1, [_cat(a, b)])):
        t = time.perf_counter()
        cfg = TrainerConfig(
            hidden=VIT_D, batch_size=size, backbone=VIT, image_size=VIT_IMAGE,
            compute_dtype=torch.bfloat16, seed=seed, train_backbone=True,
            remat_backbone=True, dropout_rate=0.0, grad_accum=accum)
        reserve = None
        if name == "accum":
            reserve = _working_reserve(enc, cfg, torch.device(DEVICE), 256,
                                       train=True)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_reserved()
        torch.cuda.reset_peak_memory_stats()
        trainer = Trainer(enc, cfg, device=DEVICE)
        names = [f"head.{n}" for n, _ in trainer.head.named_parameters()] \
            + [f"backbone.{n}" for n, _ in
               trainer.backbone.named_parameters()]
        _decisive_verb(trainer)
        got, norm = _group_grads(trainer, group)
        grads[name] = [g.to("cpu") for g in got]
        del got
        # the timed loop, its peak alone (without the check's copies)
        loader = group * VIT_FT_ACCUM_GROUPS
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _zero_vit_counts()
        out = []
        loop = _steady_loop(
            trainer, "accum_step",
            lambda: out.append(trainer.train_epoch(loader, 1)[2]),
            VIT_FT_ACCUM_FILL, accum)
        ms = loop["steady_ms"] * accum
        launches = _vit_counts()
        took = torch.cuda.max_memory_reserved() - base
        runs[name] = {"batch": size, "grad_accum": accum,
                      "ms_per_optimizer_step": ms,
                      "img_per_s": batch * 1e3 / ms,
                      "fill_ms": loop["fill_ms"],
                      "drain_ms": loop["drain_ms"],
                      "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                      "reserved_gb": took / 1e9,
                      "reserve_gb": None if reserve is None else reserve / 1e9,
                      "preclip_norm": norm,
                      "launches": launches, "losses": list(out[0])}
        _log(f"[vit ft accum] {name} " + json.dumps(runs[name]))
        del trainer
        torch.cuda.empty_cache()
        _phase(f"vit ft accum: {name}", t)
        if not np.isfinite(out[0]).all():
            raise SystemExit(f"non-finite fine-tuning losses ({name})")
        if reserve is not None and took > reserve:
            raise SystemExit(f"--cache_device's reserve {reserve} B is below"
                             f" what the accumulating fine-tuning trainer "
                             f"took ({took} B)")
    rel = _grad_rel(grads["accum"], grads["batch"], names)
    del grads
    worst = sorted(rel.items(), key=lambda kv: -kv[1])[:5]
    result = {"micro": micro, "runs": runs, "grad_rel_max": worst[0][1],
              "grad_rel_worst": dict(worst), "tol_grad_rel": ACCUM_GRAD_REL,
              "tensors": len(rel), "launches": runs["accum"]["launches"]}
    _log("[vit ft accum] " + json.dumps(result))
    if result["grad_rel_max"] > ACCUM_GRAD_REL:
        raise SystemExit(f"the accumulated fine-tuning gradient differs "
                         f"from the big batch's: {dict(worst)}")
    want = {"K1": ACCUM, "K4": 0, "K5": 0, "K6": 0,
            "K7": 2 * VIT_DEPTH * ACCUM, "K8": VIT_DEPTH * ACCUM}
    if result["launches"] != {
            k: v * VIT_FT_ACCUM_GROUPS for k, v in want.items()}:
        raise SystemExit(f"launches of {VIT_FT_ACCUM_GROUPS} accumulating "
                         f"fine-tuning groups {result['launches']}, want "
                         f"{want} a group")
    _log(f"[vit ft accum] grad_accum {ACCUM} at {micro}, steady over "
         f"{VIT_FT_ACCUM_GROUPS} groups less the fill: "
         f"{runs['accum']['ms_per_optimizer_step']:.1f} ms an optimizer step"
         f", peak {runs['accum']['peak_mem_gb']:.2f} GB (reserved "
         f"{runs['accum']['reserved_gb']:.2f} GB, --cache_device's reserve "
         f"{runs['accum']['reserve_gb']:.2f} GB); batch {batch}: "
         f"{runs['batch']['ms_per_optimizer_step']:.1f} ms, peak "
         f"{runs['batch']['peak_mem_gb']:.2f} GB; gradients within "
         f"{result['grad_rel_max']:.2e} (relative Frobenius, "
         f"{result['tensors']} tensors; pre-clip norms "
         f"{runs['accum']['preclip_norm']:.3g} / "
         f"{runs['batch']['preclip_norm']:.3g})")
    return result


# ------------------------------------------------------------- the export

# timed calls of each served artifact after a warm one
EXPORT_REPS = 3
# bf16 / int8 artifacts against the f32 one, as a share of the f32 max
# |logit|: the JAX package's bounds for its encodings
# (tests/test_serving.py::test_quantized_weight_exports), which the CPU
# tests hold the port to at mini size.  Printed here, not enforced: a
# random 152-layer network is not a trained one, and carries a weight's
# rounding far along (int8 shares of 0.27-0.34 there on an H100, 0.02 for
# ViT-L/14);
# what is enforced is each decoded weight within its encoding's rounding
# (``_check_decoded``) and the program on those weights against the eager
# model on the same ones
ENCODING_TOL = {"bf16": 0.01, "int8": 0.03}
# the flagship's artifacts (encoding, target) and the ViT's
FLAGSHIP_EXPORTS = (("f32", "cuda"), ("bf16", "cuda"), ("int8", "cuda"),
                    ("f32", "portable"))
CLIP_VIT, CLIP_IMAGE = "vit_l14_clip", 336
CLIP_N = (CLIP_IMAGE // 14) ** 2 + 1          # 577 tokens
CLIP_EXPORTS = (("f32", "cuda"), ("int8", "cuda"))


def _clip_state(seed: int) -> dict:
    """A CLIP visual tower's state dict at the published 224 grid (keys
    under ``visual.``, ``proj`` included) with random weights from
    ``seed``: the port's ``vit_l14_clip`` written in CLIP's layout."""
    import torch

    from situation_recognition_tpu_torch.models.vit import build_vit

    vit = build_vit(CLIP_VIT, image_size=VIT_IMAGE)
    gen = torch.Generator().manual_seed(seed)
    vit.reset_parameters(gen)
    sd = vit.state_dict()
    out = {"visual.class_embedding": sd["class_token"].reshape(VIT_D),
           "visual.positional_embedding": sd["encoder.pos_embedding"][0],
           "visual.conv1.weight": sd["conv_proj.weight"],
           "visual.proj": torch.randn(VIT_D, 768, generator=gen) * 0.02}
    for ours, theirs in (("ln_pre", "ln_pre"), ("encoder.ln", "ln_post")):
        for p in ("weight", "bias"):
            out[f"visual.{theirs}.{p}"] = sd[f"{ours}.{p}"]
    names = (("ln_1", "ln_1"), ("self_attention.in_proj_weight",
                                "attn.in_proj_weight"),
             ("self_attention.in_proj_bias", "attn.in_proj_bias"),
             ("self_attention.out_proj", "attn.out_proj"),
             ("ln_2", "ln_2"), ("mlp.0", "mlp.c_fc"), ("mlp.3", "mlp.c_proj"))
    for k, v in sd.items():
        if not k.startswith("encoder.layers."):
            continue
        layer, rest = k[len("encoder.layers.encoder_layer_"):].split(".", 1)
        for ours, theirs in names:
            if rest.startswith(ours):
                out[f"visual.transformer.resblocks.{layer}."
                    f"{theirs}{rest[len(ours):]}"] = v
                break
    return out


def _served(fn, images, reps: int) -> tuple:
    """A warm call, then ``reps`` timed calls of ``fn`` (host clock around
    a synchronised call) → (the last outputs, ms per call, launches per
    call of K1 and the ViT kernels, counted from 0 over the timed
    calls)."""
    import torch

    fn(images)
    torch.cuda.synchronize()
    _zero_vit_counts()
    ms = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(images)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    counts = _vit_counts()
    return out, ms, {k: v / reps for k, v in counts.items()}


def _encoding_errors(got, f32, tol: float) -> dict:
    """Max |d logits| of an encoded artifact against the f32 one as a
    share of the f32 max |logit| (verb logits; noun logits of the rows
    whose argmax verbs agree, the others being another verb's nouns), and
    whether the verb ids agree wherever the f32 top-2 margin exceeds
    2·tol·max."""
    (vl, vi, nl), (fv, fi, fn_) = got, f32
    top2 = fv.float().topk(2, dim=1).values
    stable = (top2[:, 0] - top2[:, 1]) > 2 * tol * fv.abs().max()
    same = vi == fi
    noun = ((nl[same] - fn_[same]).abs().max() / fn_.abs().max()).item() \
        if same.any() else 0.0
    return {"verb_share": ((vl - fv).abs().max() / fv.abs().max()).item(),
            "noun_share": noun, "verb_ids_agree": same.float().mean().item(),
            "stable_rows": int(stable.sum()),
            "verb_ids_agree_where_stable": bool(same[stable].all()),
            "tol": tol}


def _check_decoded(tag: str, model, path: str, weights: str) -> dict:
    """Every decoded weight of the artifact at ``path`` against the
    model's f32 one: bf16 within bf16 rounding of each element (2^-8 of
    it), int8 within half a step of its channel's scale, which is at most
    max |w| / 254 of the tensor (+1e-4 of a step for the f32 rounding of
    w / scale and q · scale); an f32 artifact exact.  → the largest error
    of each kind."""
    import torch

    from situation_recognition_tpu_torch.serving import (
        _state_dicts, decode_weights)

    want = _state_dicts(model)
    worst = {"f32": 0.0, "bf16_rel": 0.0, "int8_steps": 0.0}
    for got_sd, want_sd in zip(decode_weights(path), want):
        if set(got_sd) != set(want_sd):
            raise SystemExit(f"[{tag}] {weights}: decoded names differ")
        for k, w in want_sd.items():
            g = got_sd[k].to(w.dtype)
            if k.endswith("num_batches_tracked"):
                continue                  # unused in eval; JAX keeps none
            if not w.is_floating_point():
                if not torch.equal(g, w):
                    raise SystemExit(f"[{tag}] {weights}: {k} changed")
                continue
            err = (g - w).abs()
            if weights == "f32":
                worst["f32"] = max(worst["f32"], err.max().item())
            elif weights == "bf16":
                rel = (err / w.abs().clamp_min(1e-30)).max().item()
                worst["bf16_rel"] = max(worst["bf16_rel"], rel)
            else:
                step = w.abs().max().item() / 127.0
                if step > 0:
                    worst["int8_steps"] = max(worst["int8_steps"],
                                              err.max().item() / step)
    if worst["f32"] > 0 or worst["bf16_rel"] > 2 ** -8 \
            or worst["int8_steps"] > 0.5 + 1e-4:
        raise SystemExit(f"[{tag}] {weights}: decoded weights beyond their "
                         f"encoding's rounding: {worst}")
    return worst


def _export_case(tag: str, model, images, specs, want_launches: dict,
                 card: str) -> dict:
    """Each (encoding, target) of ``specs``: ``export_serving.export_model``
    into a temporary directory, ``load_inference`` on the card, and the
    program beside the eager model rebuilt from the same artifact
    (``rebuild=True``; the plain paths for a portable artifact), on the
    same batch: bytes, export and load seconds, img/s, launches per batch
    (``want_launches`` by target), the program against the eager model
    within ``LOGIT_TOL`` and, for a ``cuda`` program, whose eager model
    runs the same kernels, also against the plain paths rebuilt from the
    artifact (the masked GGNN, plain ViT blocks; untimed), its decoded
    weights within their encoding's rounding (``_check_decoded``), and an
    encoded artifact's logits beside the f32 one's (``_encoding_errors``,
    printed)."""
    import torch

    from situation_recognition_tpu_torch.export_serving import export_model
    from situation_recognition_tpu_torch.serving import load_inference

    batch = images.shape[0]
    rows, outs = {}, {}
    for weights, target in specs:
        name = f"{weights}_{target}"
        tmp = tempfile.mkdtemp(prefix="srtorch_export_")
        try:
            t0 = time.perf_counter()
            nbytes = export_model(model, tmp, batch_size=batch,
                                  weights=weights, target=target)
            export_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            # the programs, also the portable ones of this bf16 model
            # (which the default would serve rebuilt, through K1)
            fn = load_inference(tmp, device="cuda", rebuild=False)
            load_s = time.perf_counter() - t0
            plain = {"ggnn_impl": "masked", "block_impl": "plain"}
            eager = load_inference(tmp, device="cuda", rebuild=True,
                                   **({} if target == "cuda" else plain))
            decoded = _check_decoded(tag, model, tmp, weights)
            if set(fn.meta["platforms"]) != ({"cuda"} if target == "cuda"
                                             else {"cpu", "cuda"}):
                raise SystemExit(f"[{tag}] {name}: platforms "
                                 f"{fn.meta['platforms']}")
            got, ms, launches = _served(fn, images, EXPORT_REPS)
            want, eager_ms, _ = _served(eager, images, EXPORT_REPS)
            del fn, eager
            torch.cuda.empty_cache()
            vs_plain = None
            if target == "cuda":
                ref = load_inference(tmp, device="cuda", rebuild=True,
                                     **plain)
                vs_plain = _logit_errors(got, ref(images))
                del ref
                torch.cuda.empty_cache()
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        for out in got[0], got[2]:
            if out.shape[0] != batch or not torch.isfinite(out).all():
                raise SystemExit(f"[{tag}] {name}: bad logits")
        expect = want_launches[target]
        if {k: launches[k] for k in expect} != expect or any(
                launches[k] for k in launches if k not in expect):
            raise SystemExit(f"[{tag}] {name}: launches per batch "
                             f"{launches}, want {expect}")
        errs = _logit_errors(got, want)
        for against, e in (("the eager model", errs),
                           ("the plain paths", vs_plain)):
            if e is not None and (max(e["verb"], e["noun"]) > LOGIT_TOL
                                  or not e["verb_ids_agree_where_decided"]):
                raise SystemExit(f"[{tag}] {name}: the program disagrees "
                                 f"with {against}: {e}")
        row = {"bytes": nbytes, "export_s": export_s, "load_s": load_s,
               "ms": ms, "img_per_s": batch / (min(ms) / 1e3),
               "eager_ms": eager_ms,
               "eager_img_per_s": batch / (min(eager_ms) / 1e3),
               "launches_per_batch": launches, "vs_eager": errs,
               "vs_plain": vs_plain, "decoded": decoded, "card": card}
        if weights != "f32":
            row["vs_f32"] = _encoding_errors(got, outs[f"f32_{target}"],
                                             ENCODING_TOL[weights])
        outs[name] = got
        rows[name] = row
        _log(f"[{tag}] {name}: {nbytes} bytes, export {export_s:.2f} s, "
             f"load {load_s:.2f} s; program {row['img_per_s']:.1f} img/s "
             f"(ms {[round(x, 2) for x in ms]}) beside the eager model "
             f"{row['eager_img_per_s']:.1f} img/s (ms "
             f"{[round(x, 2) for x in eager_ms]}) at batch {batch}; "
             f"launches per batch {launches}; decoded weights "
             f"{json.dumps(decoded)}; vs eager {json.dumps(errs)}"
             + (f"; vs plain {json.dumps(vs_plain)}" if vs_plain else "")
             + (f"; vs f32 {json.dumps(row['vs_f32'])}"
                if "vs_f32" in row else "") + f" ({card})")
    return rows


def phase_export(enc, seed: int, batch: int, card: str) -> dict:
    """The serving artifact's programs at full width: the flagship
    (ResNet-152 + FCGGNN, d=2048, bf16, random weights from ``--seed``, BN
    statistics from one batch) exported f32 / bf16 / int8 for ``cuda`` and
    f32 ``portable``; then ViT-L/14's CLIP tower at 336² from a CLIP-layout
    state dict at the 224 grid through the CLI's ``_load_backbone`` (257 →
    577 tokens), exported f32 and int8 for ``cuda``.  Each artifact is
    loaded and serves a batch of ``batch`` (``_export_case``)."""
    import numpy as np
    import torch

    from situation_recognition_tpu_torch import convert
    from situation_recognition_tpu_torch.cli import _load_backbone
    from situation_recognition_tpu_torch.serving import SituationModel
    from situation_recognition_tpu_torch.train import Trainer, TrainerConfig

    rng = np.random.default_rng(seed + 21)
    images = torch.from_numpy(rng.integers(0, 256, (batch, 256, 256, 3),
                                           dtype=np.uint8)).cuda()
    none = {"K1": 0, "K4": 0, "K5": 0, "K6": 0, "K7": 0, "K8": 0}
    t = time.perf_counter()
    model = _random_model(enc, seed).to(DEVICE)
    flagship = _export_case(
        "export", model, images, FLAGSHIP_EXPORTS,
        {"cuda": {**none, "K1": 2}, "portable": none}, card)
    del model
    torch.cuda.empty_cache()
    _phase("export: the flagship", t)

    t = time.perf_counter()
    state = _clip_state(seed)
    tmp = tempfile.mkdtemp(prefix="srtorch_clip_")
    try:
        ckpt = os.path.join(tmp, "clip_visual.pth")
        torch.save(state, ckpt)
        trainer = Trainer(enc, TrainerConfig(
            hidden=VIT_D, batch_size=batch, backbone=CLIP_VIT,
            image_size=CLIP_IMAGE, compute_dtype=torch.bfloat16,
            seed=seed), device=DEVICE)
        _load_backbone(trainer, ckpt)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    loaded = trainer._backbone_source()
    pos = loaded["encoder.pos_embedding"]
    want_pos = convert.interpolate_pos_embed(
        state["visual.positional_embedding"][None], CLIP_N)
    if tuple(pos.shape) != (1, CLIP_N, VIT_D) or not torch.equal(
            pos.cpu(), want_pos):
        raise SystemExit(f"the CLIP tower's position embedding was not "
                         f"resampled to {CLIP_N} tokens: "
                         f"{tuple(pos.shape)}")
    last = VIT_DEPTH - 1
    if not torch.equal(
            loaded[f"encoder.layers.encoder_layer_{last}.mlp.3.weight"].cpu(),
            state[f"visual.transformer.resblocks.{last}.mlp.c_proj.weight"]):
        raise SystemExit("the CLIP tower's weights did not load")
    model = SituationModel(enc, backbone=CLIP_VIT, hidden=VIT_D,
                           image_size=CLIP_IMAGE, dtype=torch.bfloat16)
    model.backbone.load_state_dict(
        {k: v.float() if v.is_floating_point() else v
         for k, v in loaded.items()}, strict=True)
    model.head.load_state_dict(trainer.head.state_dict(), strict=True)
    del trainer, loaded, state
    model.eval().to(DEVICE)
    vit = _export_case(
        "export vit", model, images, CLIP_EXPORTS,
        {"cuda": {**none, "K1": 2, "K4": VIT_DEPTH, "K6": VIT_DEPTH,
                  "K7": VIT_DEPTH}}, card)
    del model
    torch.cuda.empty_cache()
    _phase("export: ViT-L/14 CLIP at 336", t)
    return {"flagship": flagship, "vit": vit, "card": card,
            "launches": {
                tag: {k: round(EXPORT_REPS * sum(
                    r["launches_per_batch"][k] for r in rows.values()))
                    for k in none}
                for tag, rows in (("flagship", flagship), ("vit", vit))}}


# ------------------------------------------------------------- the dist phase

#: the dist phase's steady loops (as the cli phase's) and its world of two
#: on one card: train steps compared with one process
DIST_STEPS, DIST_FILL, DIST_CHECK_STEPS = 20, 4, 2
#: part (a)'s fine-tuning steps a timed loop (ResNet-152 fine-tuned under
#: remat) and the loop's fill
DIST_FT_STEPS, DIST_FT_FILL = 6, 2
#: the world of two's checks by BN mode: (BN mode, compute type).  bf16
#: eval-mode BN holds losses, gradients and head; bf16 train-mode BN only
#: the losses and the statistics (the global statistics' f32 sums in
#: another order flip bf16 roundings that a random ResNet-152 amplifies
#: layer by layer, to 0.2 of a gradient); train-mode BN in f32 (TF32 off)
#: holds all of them: losses, gradients and statistics at
#: ``DIST_F32_REL``, the head at ``ACCUM_GRAD_REL`` as in eval mode
DIST_MODES = {"eval": ("eval", "bf16"), "train": ("train", "bf16"),
              "train_f32": ("train", "f32")}
#: the f32 train-mode check's bound for what scales with the rounding
#: (losses, gradients, statistics): a tenth of ``ACCUM_GRAD_REL``.  A
#: split that took per-rank statistics instead of global ones would move
#: a statistic by ~1/sqrt(128) of itself, far above it.  The head after
#: Adamax's steps does not scale so: its first step is about lr times the
#: sign of each gradient element, so an element whose gradient is near 0
#: in either run moves the other way at any precision; it keeps the bf16
#: head's bound
DIST_F32_REL = ACCUM_GRAD_REL / 10
#: the most ranks of part (c)
DIST_MAX_CARDS = 4


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _dist_spec(seed: int, batch: int, world: int, backend: str) -> dict:
    """What a rank of part (b) or (c) builds: this run's width, batch and
    device (``_dist_rank``)."""
    return {"seed": seed, "batch": batch, "world": world,
            "backend": backend, "backbone": BACKBONE, "hidden": D,
            "device": DEVICE, "steps": DIST_CHECK_STEPS}


def _dist_trainer(enc, spec: dict, device, mesh=None, mode: str = "train"):
    """The flagship trainer of a dist check in ``mode`` (``DIST_MODES``:
    bf16 or f32 on the card, f32 in a CPU rehearsal), its verb decisive
    (``_decisive_verb``).  Eval-mode BN has its running statistics set
    from one batch of 64 windows by the one-batch path (the same bytes in
    every process)."""
    import torch

    from situation_recognition_tpu_torch.data.transforms import (
        eval_transform)
    from situation_recognition_tpu_torch.models.resnet import set_stats_group
    from situation_recognition_tpu_torch.train import Trainer, TrainerConfig

    bn, compute = DIST_MODES[mode]
    dtype = torch.bfloat16 if spec["device"] == "cuda" \
        and compute == "bf16" else torch.float32
    tr = Trainer(enc, TrainerConfig(
        hidden=spec["hidden"], batch_size=spec["batch"],
        backbone=spec["backbone"], compute_dtype=dtype, seed=spec["seed"],
        frozen_backbone_bn=bn), device=device, mesh=mesh)
    if bn == "eval":
        images = _train_batches(enc, spec["seed"] + 8, 64, 1)[0]["images"]
        set_stats_group(tr.backbone, None)
        _set_bn_statistics(tr.backbone, eval_transform(
            torch.from_numpy(images).to(device), dtype=dtype))
        set_stats_group(tr.backbone, tr._data_group)
    _decisive_verb(tr)
    return tr


def _dist_steps(tr, enc, spec: dict, timed: int = 0) -> dict:
    """``spec["steps"]`` train steps on the global batches of the check
    (each rank cuts its rows), the first step's summed gradients as the
    clip receives them, then the head and the BN running statistics; with
    ``timed``, the steady step of that many more (the fill left out)."""
    import numpy as np
    import torch

    from situation_recognition_tpu_torch.models.resnet import BatchNorm

    seen = []
    real_clip = tr._clip

    def clip():
        if not seen:
            seen.append({n: p.grad.detach().float().cpu() for n, p in
                         tr.head.named_parameters()})
        real_clip()

    tr._clip = clip
    batches = _train_batches(enc, spec["seed"] + 9, spec["batch"],
                             spec["steps"])
    losses = []
    _zero_counts()
    for b in batches:
        args, _ = tr._upload(b)
        losses.append(tr.train_step(*args)[0].float().cpu().numpy())
        tr.step_count += 1
    out = {"losses": np.stack(losses).tolist(), "launches": _counts(),
           "grads": seen[0],
           "head": {n: p.detach().float().cpu()
                    for n, p in tr.head.named_parameters()},
           "stats": torch.cat([b.reshape(-1).float().cpu() for m in
                               tr.backbone.modules()
                               if isinstance(m, BatchNorm)
                               for b in (m.running_mean, m.running_var)])}
    if timed:
        loader = [batches[i % len(batches)] for i in range(timed)]
        run = _steady_loop(tr, "accum_step",
                           lambda: tr.train_epoch(loader, 7), DIST_FILL)
        out["steady_ms"] = run["steady_ms"]
    return out


def _dist_host_costs(group) -> dict:
    """Host µs a call, queued without a sync between calls: an all-reduce
    of 512 floats over ``group`` (200 calls), and a train-mode BN layer
    of 256 x 256 x 56 x 56 bf16 channels-last windows (ResNet-152's first
    stage) with its statistics over ``group`` against the layer's
    ``native_batch_norm`` path (50 calls each, no gradient)."""
    import torch

    from situation_recognition_tpu_torch.models.resnet import BatchNorm
    from situation_recognition_tpu_torch.parallel import distributed

    def host_us(fn, n):
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        us = (time.perf_counter() - t0) / n * 1e6
        torch.cuda.synchronize()
        return us

    dtype = torch.bfloat16 if DEVICE == "cuda" else torch.float32
    t = torch.zeros(512, device=DEVICE)
    out = {"all_reduce_us": host_us(
        lambda: distributed.all_reduce(t, group, "probe"), 200)}
    x = torch.randn(256 if DEVICE == "cuda" else 4, 256, 56, 56,
                    device=DEVICE, dtype=dtype).contiguous(
        memory_format=torch.channels_last)
    for name, grp in (("global", group), ("native", None)):
        bn = BatchNorm(256, eps=1e-5).to(DEVICE).train()
        bn.stats_group = grp
        with torch.no_grad():
            out[f"bn_layer_{name}_us"] = host_us(lambda: bn(x), 50)
    _log("[dist] (a) host costs " + json.dumps(out))
    return out


def _dist_ft(enc, seed: int, batch: int) -> dict:
    """Part (a)'s fine-tuning step: ResNet-152 + FCGGNN fine-tuned under
    ``remat_backbone`` (JAX's recipe at the flagship width), bf16, batch
    ``batch``, on the world of one (its backward runs the card's global
    BN backward) against one process, from the same seeded weights: the
    first step's losses within ``ROUTE_LOSS_REL``, the steady step in turns
    (dist, plain) over ``DIST_FT_STEPS`` with ``DIST_FT_FILL`` left out, a
    profiled step of each and the collectives a step (BN: the forward,
    the recomputed forward of every residual block and the backward)."""
    import numpy as np
    import torch

    from situation_recognition_tpu_torch.parallel import (
        distributed, make_mesh)
    from situation_recognition_tpu_torch.train import (
        GRAD_BUCKET_BYTES, Trainer, TrainerConfig)

    cfg = TrainerConfig(hidden=D, batch_size=batch, backbone=BACKBONE,
                        compute_dtype=torch.bfloat16 if DEVICE == "cuda"
                        else torch.float32, seed=seed, train_backbone=True,
                        remat_backbone=True)
    plain = Trainer(enc, cfg, device=DEVICE)
    trainers = {"dist": Trainer(enc, cfg, device=DEVICE, mesh=make_mesh(),
                                backbone_state=plain.backbone.state_dict(),
                                head_state=plain.head.state_dict()),
                "plain": plain}
    host = _train_batches(enc, seed + 6, batch, DIST_FT_STEPS)
    first = {}
    for name, tr in trainers.items():
        args, _ = tr._upload(host[0])
        first[name] = tr.train_step(*args)[0].float().cpu().numpy()
        tr.step_count += 1
    rel = float(np.max(np.abs(first["dist"] - first["plain"])
                       / np.maximum(np.abs(first["plain"]), 1e-6)))
    out = {"first_losses": {n: v.tolist() for n, v in first.items()},
           "loss_rel": rel, "tol": ROUTE_LOSS_REL, "steady_ms": {},
           "collectives_per_step": {}}
    if not (rel <= ROUTE_LOSS_REL and all(np.isfinite(v).all()
                                          for v in first.values())):
        raise SystemExit(f"dist (a) fine-tuning: the world of one's first "
                         f"losses differ from one process's: {out}")
    for name in ("dist", "plain"):
        tr = trainers[name]
        distributed.COUNTS.clear()
        run = _steady_loop(tr, "accum_step",
                           lambda: tr.train_epoch(host, 102), DIST_FT_FILL)
        out["steady_ms"][name] = run["steady_ms"]
        out["collectives_per_step"][name] = {
            k: v / DIST_FT_STEPS for k, v in distributed.COUNTS.items()}
    out["host_ms"] = out["steady_ms"]
    profiles = {n: _profile(f"one {n} fine-tuning step",
                            lambda tr=tr: tr.train_epoch(host[:1], 103),
                            tag="dist", top=25, host_top=12)
                for n, tr in trainers.items()}
    out["device_ms"] = {n: p["device_ms"] for n, p in profiles.items()}
    out["profile_top"] = {n: {"device": p["top"], "host": p["host_top"]}
                          for n, p in profiles.items()}
    out["idle_share"] = {n: (out["host_ms"][n] - out["device_ms"][n])
                         / out["host_ms"][n] for n in trainers}
    tr = trainers["dist"]
    buckets = -(-sum(p.numel() * 4 for p in tr._trainable)
                // GRAD_BUCKET_BYTES)
    bb = tr.backbone
    n_bn = sum(isinstance(m, torch.nn.BatchNorm2d) for m in bb.modules())
    in_blocks = sum(isinstance(m, torch.nn.BatchNorm2d) for name, m in
                    bb.named_modules() if name.startswith("layer"))
    want = 2 * n_bn + in_blocks
    out["bn_all_reduces_want"] = want
    _log("[dist] (a) fine-tuning " + json.dumps(out))
    got = out["collectives_per_step"]
    if got["plain"] or got["dist"].get("bn") != want \
            or got["dist"].get("grad") != buckets:
        raise SystemExit(f"dist (a) fine-tuning: collectives a step {got}, "
                         f"want none plain and {want} BN all-reduces and "
                         f"{buckets} gradient all-reduces (one a bucket of "
                         f"{GRAD_BUCKET_BYTES} bytes) in the world of one")
    return out


def _dist_rank(spec: dict, rank: int, port: int, out: str) -> int:
    """One rank of part (b) or (c), in its own process: join the world,
    train the check's steps on this rank's rows, write what it saw."""
    import torch

    from situation_recognition_tpu_torch.data.encoder import ImsituEncoder
    from situation_recognition_tpu_torch.parallel import (
        destroy, init_distributed, make_mesh)
    from situation_recognition_tpu_torch.parallel import distributed

    if spec["device"] == "cuda":
        # part (b) shares card 0 between the ranks, part (c) takes one each
        device = ("cuda:0" if spec["backend"] == "gloo"
                  else f"cuda:{rank}")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    else:
        device = "cpu"
    device = init_distributed(f"127.0.0.1:{port}", spec["world"], rank,
                              backend=spec["backend"], device=device)
    try:
        enc = ImsituEncoder.synthetic_full(spec["seed"])
        mesh = make_mesh()
        res = {}
        for bn in DIST_MODES:
            tr = _dist_trainer(enc, spec, device, mesh, bn)
            distributed.COUNTS.clear()
            res[bn] = _dist_steps(tr, enc, spec, timed=spec.get("timed", 0)
                                  if bn == "train" else 0)
            res[bn]["collectives"] = dict(distributed.COUNTS)
            if rank != 0:
                res[bn] = {k: res[bn][k] for k in (
                    "losses", "launches", "collectives", "steady_ms")
                    if k in res[bn]}
            del tr
            if spec["device"] == "cuda":
                torch.cuda.empty_cache()
        torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    finally:
        destroy()
    return 0


def _run_world(spec: dict, tag: str) -> list:
    """Start ``spec["world"]`` ranks (this script, one process each),
    wait for all with a time limit, → their results; a rank's failure
    fails the phase with its output."""
    import torch

    port = _free_port()
    with tempfile.TemporaryDirectory(prefix="srtorch_dist_") as out:
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--dist-rank",
             str(r), "--dist-port", str(port), "--dist-out", out,
             "--dist-spec", json.dumps(spec)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(spec["world"])]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=300)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, text) in enumerate(zip(procs, outs)):
            for line in text.splitlines()[-40:]:
                _log(f"[dist] {tag} rank {r} | {line}")
            if p.returncode != 0:
                raise SystemExit(f"dist {tag}: rank {r} exited "
                                 f"{p.returncode}")
        return [torch.load(os.path.join(out, f"rank{r}.pt"),
                           weights_only=False)
                for r in range(spec["world"])]


def _rel(got, want) -> float:
    return float((got.float() - want.float()).norm()
                 / (want.float().norm() + 1e-30))


def _compare(r0: dict, one: dict) -> dict:
    import numpy as np

    got_l, want_l = np.asarray(r0["losses"]), np.asarray(one["losses"])
    return {"loss_rel": float(np.max(np.abs(got_l - want_l)
                                     / np.abs(want_l))),
            "grad_rel_by_tensor": {n: _rel(r0["grads"][n], g)
                                   for n, g in one["grads"].items()},
            "head_rel_by_tensor": {n: _rel(r0["head"][n], p)
                                   for n, p in one["head"].items()},
            "stats_rel": _rel(r0["stats"], one["stats"]),
            "losses": r0["losses"], "one_losses": one["losses"],
            "collectives": r0["collectives"], "launches": r0["launches"]}


def _hold_world(tag: str, ranks: list, one: dict) -> dict:
    """A world's results against one process's, relative (per tensor for
    gradients and the head), by ``DIST_MODES``: with bf16 eval-mode BN
    (running statistics set by the same bytes everywhere, so the features
    are the one process's) per-step losses, the first step's summed head
    gradients and the head after the steps within ``ACCUM_GRAD_REL``; with
    bf16 train-mode BN the losses and the BN running statistics within it
    (its gradients and head are printed); with f32 train-mode BN the
    losses, gradients and statistics within ``DIST_F32_REL`` and the head
    within ``ACCUM_GRAD_REL``.  Every rank's losses equal rank 0's; K1
    launches once a step at bf16 (f32 takes the masked GGNN)."""
    res = {bn: _compare(ranks[0][bn], one[bn]) for bn in DIST_MODES}
    for part in res.values():
        part["grad_rel"] = max(part["grad_rel_by_tensor"].values())
        part["head_rel"] = max(part["head_rel_by_tensor"].values())
    tols = {"bf16": ACCUM_GRAD_REL, "f32": DIST_F32_REL}
    _log(f"[dist] {tag}: " + json.dumps({**res, "tol": tols}))
    for bn, (_, compute) in DIST_MODES.items():
        for r in ranks[1:]:
            if r[bn]["losses"] != ranks[0][bn]["losses"]:
                raise SystemExit(f"dist {tag}: the ranks' losses differ: "
                                 f"{[x[bn]['losses'] for x in ranks]}")
        want = DIST_CHECK_STEPS if compute == "bf16" else 0
        if res[bn]["launches"]["K1"] != want and DEVICE == "cuda":
            raise SystemExit(f"dist {tag}: K1 launches {res[bn]}")
    held = [("eval", "loss_rel"), ("eval", "grad_rel"), ("eval", "head_rel"),
            ("train", "loss_rel"), ("train", "stats_rel")] + [
        ("train_f32", k) for k in ("loss_rel", "grad_rel", "head_rel",
                                   "stats_rel")]
    for bn, key in held:
        tol = tols["bf16" if key == "head_rel" else DIST_MODES[bn][1]]
        if not res[bn][key] <= tol:
            raise SystemExit(f"dist {tag}: {bn} {key} {res[bn][key]:.3e} "
                             f"above {tol}")
    res["tol"] = tols
    return res


def phase_dist(enc, seed: int, batch: int, card: str) -> dict:
    """Multi-process data parallelism on the card (see the module
    docstring): (a) a NCCL world of one through the CLI against the CLI
    without ``--distributed``, (b) a gloo world of two on this card
    against one process, (c) a NCCL world of the cards, where there are
    two or more."""
    import numpy as np
    import torch

    from situation_recognition_tpu_torch import cli
    from situation_recognition_tpu_torch.parallel import (
        destroy, distributed, init_distributed)
    from situation_recognition_tpu_torch.train import Trainer

    t_phase = time.perf_counter()
    result = {"card": card, "batch": batch}
    n_train = CLI_TRAIN * batch // BATCH
    n_eval = CLI_EVAL * batch // BATCH
    want_k1 = -(-n_train // batch) + 3 * -(-n_eval // batch)
    trainers = {}
    real_fit = Trainer.fit

    # (a) the CLI on a NCCL world of one, and without --distributed
    with tempfile.TemporaryDirectory(prefix="srtorch_dist_") as root:
        data = _synthetic_imsitu(root, enc, seed, n_train, n_eval)
        common = ["--backbone", BACKBONE, "--batch_size", str(batch),
                  "--dataset_folder", data["dataset"],
                  "--imgset_dir", os.path.join(root, "unused"),
                  "--packed_dir", data["packed"], "--seed", str(seed),
                  "--num_workers", "4", "--epochs", "1"]
        if DEVICE == "cpu":
            common += ["--platform", "cpu"]
        port = _free_port()
        runs = {"plain": common + ["--saving_folder",
                                   os.path.join(root, "plain")],
                "dist": common + ["--saving_folder",
                                  os.path.join(root, "dist"),
                                  "--distributed", "--coordinator",
                                  f"127.0.0.1:{port}", "--num_processes",
                                  "1", "--process_id", "0"]}
        texts, launches, collectives = {}, {}, {}
        try:
            # the world outlives the CLI run, for the timing below
            init_distributed(f"127.0.0.1:{port}", 1, 0,
                             device="cpu" if DEVICE == "cpu" else "cuda:0")
            backend = torch.distributed.get_backend()
            result["backend"] = backend
            if DEVICE == "cuda" and backend != "nccl":
                raise SystemExit(f"the world of one is {backend}, not nccl")
            for name, argv in runs.items():
                def keep(self, *args, _name=name, **kwargs):
                    trainers[_name] = self
                    return real_fit(self, *args, **kwargs)

                Trainer.fit = keep
                t = time.perf_counter()
                _zero_counts()
                distributed.COUNTS.clear()
                texts[name] = _run_cli(argv)
                torch.cuda.synchronize()
                launches[name] = _counts()
                collectives[name] = dict(distributed.COUNTS)
                _phase(f"dist: cli {name}", t)
            Trainer.fit = real_fit
            checks = {n: _check_transcript(x, f"dist cli {n}")
                      for n, x in texts.items()}
            a = np.asarray(checks["dist"]["losses"])
            b = np.asarray(checks["plain"]["losses"])
            rel = float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-6)))
            result["cli"] = {"losses": checks, "loss_rel": rel,
                             "tol": ROUTE_LOSS_REL, "launches": launches,
                             "collectives": collectives}
            _log("[dist] (a) cli " + json.dumps(result["cli"]))
            if not rel <= ROUTE_LOSS_REL:
                raise SystemExit(f"dist (a): the world of one's losses "
                                 f"differ from the plain CLI's by {rel:.3e}")
            for name, count in launches.items():
                if count != {"K1": want_k1, "K2": 0, "K3": 0} \
                        and DEVICE == "cuda":
                    raise SystemExit(f"dist (a) {name}: launches {count}, "
                                     f"want K1 {want_k1}")

            # the steady step of each CLI trainer, in turns (plain, dist,
            # dist, plain), and a profiled one
            host = _train_batches(trainers["dist"].encoder, seed + 5, batch,
                                  CLI_LOOP_BATCHES)
            loader = [host[i % len(host)] for i in range(DIST_STEPS)]
            timed = {n: [] for n in trainers}
            per_step = {}
            for tr in trainers.values():
                tr.train_epoch(loader[:1], 99)                 # warm
            for name in ("plain", "dist", "dist", "plain"):
                tr = trainers[name]
                distributed.COUNTS.clear()
                run = _steady_loop(tr, "accum_step",
                                   lambda: tr.train_epoch(loader, 100),
                                   DIST_FILL)
                timed[name].append(run["steady_ms"])
                per_step[name] = {k: v / DIST_STEPS for k, v in
                                  distributed.COUNTS.items()}
            profiles = {n: _profile(
                f"one {n} CLI-trainer step",
                lambda tr=tr: tr.train_epoch(loader[:1], 101), tag="dist",
                top=5) for n, tr in trainers.items()}
            host_ms = {n: float(np.mean(v)) for n, v in timed.items()}
            result["timing"] = {
                "steady_ms": timed, "host_ms_per_step": host_ms,
                "device_ms": {n: p["device_ms"] for n, p in
                              profiles.items()},
                "nccl_device_ms": profiles["dist"]["nccl_device_ms"],
                "profiler_collectives": profiles["dist"]["collectives"],
                "collectives_per_step": per_step,
                "added_host_ms": host_ms["dist"] - host_ms["plain"],
                "added_device_ms": profiles["dist"]["device_ms"]
                - profiles["plain"]["device_ms"]}
            for n in trainers:
                result["timing"].setdefault("idle_share", {})[n] = (
                    host_ms[n] - profiles[n]["device_ms"]) / host_ms[n]
            _log("[dist] (a) timing " + json.dumps(result["timing"]))
            n_bn = sum(isinstance(m, torch.nn.BatchNorm2d) for m in
                       trainers["dist"].backbone.modules())
            if per_step["plain"] or per_step["dist"].get("bn") != n_bn \
                    or per_step["dist"].get("grad") != 1:
                raise SystemExit(f"collectives a step: {per_step}, want "
                                 f"none plain and {n_bn} BN all-reduces "
                                 f"and one gradient all-reduce in the "
                                 f"world of one")
            trainers.clear()
            torch.cuda.empty_cache()
            result["host_costs"] = _dist_host_costs(
                torch.distributed.group.WORLD)
            t = time.perf_counter()
            result["ft"] = _dist_ft(enc, seed, batch)
            _phase("dist: (a) fine-tuning", t)
        finally:
            Trainer.fit = real_fit
            trainers.clear()
            destroy()
    torch.cuda.empty_cache()

    # (b) two ranks on this card over gloo, against one process
    t = time.perf_counter()
    spec = _dist_spec(seed, batch, 2, "gloo")
    ranks = _run_world(spec, "(b)")
    _phase("dist: (b) world of two", t)
    one = {}
    for bn in DIST_MODES:
        one_tr = _dist_trainer(enc, spec, DEVICE, mode=bn)
        one[bn] = _dist_steps(one_tr, enc, spec)
        del one_tr
        torch.cuda.empty_cache()
    result["gloo_two_ranks"] = _hold_world("(b) gloo, 2 ranks, 1 card",
                                           ranks, one)

    # (c) a NCCL world of the cards
    cards = torch.cuda.device_count() if DEVICE == "cuda" else 0
    if cards >= 2:
        world = min(cards, DIST_MAX_CARDS)
        spec = dict(_dist_spec(seed, batch, world, "nccl"),
                    timed=DIST_STEPS)
        ranks = _run_world(spec, "(c)")
        result["nccl_cards"] = _hold_world(f"(c) nccl, {world} cards",
                                           ranks, one)
        result["nccl_cards"]["steady_ms"] = ranks[0]["train"]["steady_ms"]
    else:
        result["nccl_cards"] = None
        _log(f"[dist] (c) did not run: it needs 2 or more cards, and this "
             f"machine has {cards}")
    result["phase_s"] = time.perf_counter() - t_phase
    tm, gw = result["timing"], result["gloo_two_ranks"]
    gf, ft = gw["train_f32"], result["ft"]
    _log(f"[dist] {card}: world of one over NCCL through the CLI: "
         f"{tm['host_ms_per_step']['dist']:.2f} ms a step against "
         f"{tm['host_ms_per_step']['plain']:.2f} plain (host, steady over "
         f"{DIST_STEPS - DIST_FILL} steps, +{tm['added_host_ms']:.2f} ms), "
         f"device {tm['device_ms']['dist']:.2f} against "
         f"{tm['device_ms']['plain']:.2f} ms (+{tm['added_device_ms']:.2f});"
         f" collectives a step {tm['collectives_per_step']['dist']}; gloo "
         f"world of two on one card, eval-mode BN: loss rel "
         f"{gw['eval']['loss_rel']:.2e}, grad rel "
         f"{gw['eval']['grad_rel']:.2e}, head rel "
         f"{gw['eval']['head_rel']:.2e}; train-mode BN: loss rel "
         f"{gw['train']['loss_rel']:.2e}, BN statistics rel "
         f"{gw['train']['stats_rel']:.2e} (tol {ACCUM_GRAD_REL}); f32 "
         f"train-mode BN: loss rel {gf['loss_rel']:.2e}, grad rel "
         f"{gf['grad_rel']:.2e}, BN statistics rel {gf['stats_rel']:.2e} "
         f"(tol {DIST_F32_REL}), head rel {gf['head_rel']:.2e} (tol "
         f"{ACCUM_GRAD_REL}); "
         f"fine-tuning (remat) a step {ft['host_ms']['dist']:.2f} ms "
         f"against {ft['host_ms']['plain']:.2f} plain, device "
         f"{ft['device_ms']['dist']:.2f} against "
         f"{ft['device_ms']['plain']:.2f} ms, collectives a step "
         f"{ft['collectives_per_step']}; phase {result['phase_s']:.1f} s")
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phase", choices=("dist",), default=None,
                    help="run this phase alone, after the device phase and "
                         "the build of the kernels it runs, and print its "
                         "result as the last line (not the smoke's)")
    # a rank of the dist phase's worlds (the phase starts them)
    ap.add_argument("--dist-rank", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--dist-port", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--dist-out", help=argparse.SUPPRESS)
    ap.add_argument("--dist-spec", help=argparse.SUPPRESS)
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

    if args.dist_rank is not None:
        spec = json.loads(args.dist_spec)
        global BACKBONE, D, DEVICE
        BACKBONE, D, DEVICE = spec["backbone"], spec["hidden"], \
            spec["device"]
        return _dist_rank(spec, args.dist_rank, args.dist_port,
                          args.dist_out)

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
    sources = ("ggnn_folded.cu",) if args.phase == "dist" else SOURCES
    _build.build(sources)
    for src in sources:
        _build.load(src)
        _log(f"[build] {src}:\n" + "\n".join(
            line for line in _build.build_log(src).splitlines()
            if line.strip()))
    _phase("build", t)

    enc = ImsituEncoder.synthetic_full(args.seed)
    if args.phase == "dist":
        t = time.perf_counter()
        dist = phase_dist(enc, args.seed, BATCH, smi)
        _phase("dist", t)
        print(json.dumps(dist, default=str), flush=True)
        return 0
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

    torch.cuda.empty_cache()
    t = time.perf_counter()
    accum = phase_accum(enc, args.seed, BATCH)
    accum["card"] = smi
    _phase("accum", t)

    t = time.perf_counter()
    resnets = phase_resnets(enc, args.seed, BATCH)
    _phase("resnets", t)

    torch.cuda.empty_cache()
    t = time.perf_counter()
    cli = phase_cli(enc, args.seed, BATCH, smi)
    cli_k1 = sum(c["K1"] for c in cli["launches"].values())
    _phase("cli", t)

    torch.cuda.empty_cache()
    t = time.perf_counter()
    dist = phase_dist(enc, args.seed, BATCH, smi)
    _phase("dist", t)

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
    torch.cuda.empty_cache()
    t = time.perf_counter()
    vit_ft_accum = phase_vit_ft_accum(enc, args.seed, BATCH)
    _phase("vit ft accum", t)
    torch.cuda.empty_cache()
    t = time.perf_counter()
    export = phase_export(enc, args.seed, BATCH, smi)
    _phase("export", t)
    vit_launches = {k: {path: c[k] for path, c in (
        ("export_program", export["launches"]["vit"]),
        ("serve_stream", vit_path["launches"]["stream"]),
        ("serve_block", vit_path["launches"]["block"]),
        ("batcher", vit_path["launches"]["batcher"]),
        ("train", vit_train["steps"][-1]["launches"]),
        ("ft_train", vit_ft["steps"][-1]["launches"]),
        ("ft_eval", vit_ft["eval_launches"]),
        ("ft_accum", vit_ft_accum["launches"]))}
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
                     kernel["shapes"] + kernel["k1_more"] + vit_kernel["K1"],
                     {"serve": path["launches"],
                      "train": train_launches["K1"],
                      "accum": accum["launches"]["K1"],
                      **{f"resnets_{n}": r["train_launches"]["K1"]
                         + r["eval_launches"]["K1"]
                         for n, r in resnets.items()},
                      "cli": cli_k1,
                      "dist_cli": sum(c["K1"] for c in
                                      dist["cli"]["launches"].values()),
                      "dist_gloo_rank0": sum(
                          dist["gloo_two_ranks"][bn]["launches"]["K1"]
                          for bn in DIST_MODES),
                      "export_program": export["launches"]["flagship"]["K1"],
                      **{f"cli_{p}": c["K1"]
                         for p, c in cli["launches_more"].items()},
                      **{f"vit_{p}": c
                         for p, c in vit_launches["K1"].items()}},
                     resources=res["ggnn_folded.cu"]),
        _kernel_line("ggnn_folded_res", "ggnn_folded.cu", 492,
                     kernel["res_shapes"],
                     {"train": train_launches["K2"],
                      "accum_pallas_microbatch": accum[
                          "launches_per_microbatch"]["pallas"]["K2"]},
                     resources=res["ggnn_folded.cu"]),
        _kernel_line("ggnn_folded_bwd", "ggnn_folded_bwd.cu", 521,
                     kernel["bwd_shapes"],
                     {"train": train_launches["K3"],
                      "accum_pallas_microbatch": accum[
                          "launches_per_microbatch"]["pallas"]["K3"]},
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
