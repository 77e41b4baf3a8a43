"""Where a train or eval step's device time goes, op by op:

    python -m situation_recognition_tpu_torch.tools.profile_step \\
        [--mode train|eval] [--steps 4] [--top 25] [--json out.json] \\
        [--keep-trace DIR] [--device cuda|cpu]

The counterpart of the JAX package's ``tools/profile_step.py``: the
bench's trainer (``BENCH_BATCH``, ``BENCH_BACKBONE``, ``BENCH_FROZEN_BN``,
``BENCH_IMAGE_SIZE``, ``BENCH_TRAIN_BACKBONE``; ``bench.bench_trainer``)
runs ``--steps`` steps on one device-resident synthetic batch, after two
warm ones, under ``torch.profiler`` (CPU and CUDA activities).  It prints
a table of the device's kernels and copies by name — ms a step, % of the
device time, calls a step — the totals by category (convolution, GEMM,
each hand kernel K1–K8 by its kernel names, elementwise, copies,
collectives, other) and the device's idle share of the profiled wall
time.  On the CPU the table is the host operators' own time instead (a
check of the tool, not a device measurement).  ``--json`` writes the
same numbers; ``--keep-trace`` also writes the Chrome trace there.
``SRTPU_PROFILE_DIR`` traces a real training run instead (``fit``'s first
epoch).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

#: the hand kernels by a substring of their CUDA kernel names
#: (``csrc/``); ``ggnn_gemm_kernel`` is told apart by its argument type
HAND_KERNELS = (
    ("K3 ggnn_folded_bwd", ("ggnn_bwd_", "BwdArgs")),
    ("K1/K2 ggnn_folded", ("ggnn_agg_kernel", "ggnn_gemm_kernel")),
    ("K8 vit_attention_bwd", ("dq_kernel", "dkv_kernel")),
    ("K5/K7 vit_attention", ("attn_kernel",)),
    ("K4/K6 vit_block", ("layernorm_kernel", "gemm_kernel")),
)


def category(name: str) -> str:
    """A kernel's (or, on the CPU, an operator's) category."""
    for label, keys in HAND_KERNELS:
        if any(k in name for k in keys):
            return label
    n = name.lower()
    if any(k in n for k in ("nccl", "allreduce", "all_reduce", "c10d")):
        return "collective"
    if "memcpy" in n or "memset" in n or n.startswith(
            ("aten::copy_", "aten::to", "aten::_to_copy", "aten::clone",
             "aten::contiguous")):
        return "copy"
    if any(k in n for k in ("conv", "cudnn", "fprop", "dgrad", "wgrad",
                            "implicit_gemm", "winograd")):
        return "convolution"
    if any(k in n for k in ("gemm", "cutlass", "mm", "matmul", "linear",
                            "sm90_xmma", "cublas", "nvjet")):
        return "gemm"
    if any(k in n for k in ("elementwise", "reduce", "norm", "softmax",
                            "vectorized", "aten::")):
        return "elementwise"
    return "other"


def table(prof, steps: int, on_card: bool) -> dict:
    """The profile's per-name rows (device kernels and copies on the
    card; host operators' own time on the CPU), category totals and
    totals, per step."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    rows = []
    for ev in prof.key_averages():
        if on_card:
            if ev.device_type != cuda:
                continue
            us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        else:
            us = ev.self_cpu_time_total
        if us > 0:
            rows.append({"name": ev.key, "ms_per_step": us / 1e3 / steps,
                         "calls_per_step": ev.count / steps,
                         "category": category(ev.key)})
    rows.sort(key=lambda r: -r["ms_per_step"])
    total = sum(r["ms_per_step"] for r in rows)
    cats: dict = {}
    for r in rows:
        r["pct"] = 100.0 * r["ms_per_step"] / total if total else 0.0
        cats[r["category"]] = cats.get(r["category"], 0.0) + r["ms_per_step"]
    return {"rows": rows, "total_ms_per_step": total,
            "categories": dict(sorted(cats.items(), key=lambda kv: -kv[1]))}


def device_busy_ms(prof) -> float:
    """The union of the device's kernel and copy intervals, ms (kernels on
    several streams that overlap count once)."""
    import torch

    spans = []
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            spans.append((ev.time_range.start, ev.time_range.end))
    spans.sort()
    busy, end = 0.0, None
    for s, e in spans:
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy / 1e3


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mode", choices=["train", "eval"], default="train")
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--json", default=None, help="write the numbers here")
    ap.add_argument("--keep-trace", default=None,
                    help="also write the Chrome trace into this directory")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from situation_recognition_tpu_torch.bench import (
        bench_batch_backbone, bench_trainer)
    from situation_recognition_tpu_torch.device import resolve_device
    from situation_recognition_tpu_torch.tools.common import sync

    device = resolve_device(args.device)
    on_card = device.type == "cuda"
    batch, backbone = bench_batch_backbone(on_card)
    train_bb = os.environ.get("BENCH_TRAIN_BACKBONE", "0") == "1"
    trainer, (images, flip, verbs, labels, valid) = bench_trainer(
        device, batch, backbone,
        frozen_backbone_bn=os.environ.get("BENCH_FROZEN_BN", "train"),
        image_size=int(os.environ.get("BENCH_IMAGE_SIZE", "224")),
        train_backbone=train_bb, remat_backbone=train_bb)
    if args.mode == "train":
        def step():
            return trainer.train_step(images, flip, verbs, labels, valid)
    else:
        def step():
            return trainer.eval_step(images, verbs, labels, valid)
    for _ in range(2):
        step()
    sync(device)
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if on_card else [])
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step()
        sync(device)
        wall_ms = (time.perf_counter() - t0) * 1e3
    out = table(prof, args.steps, on_card)
    busy = device_busy_ms(prof) if on_card else None
    out.update({
        "mode": args.mode, "steps": args.steps, "batch": batch,
        "backbone": backbone,
        "device": (torch.cuda.get_device_name(device) if on_card
                   else "cpu"),
        "lane": "device kernels and copies" if on_card
        else "host operators (own time)",
        "wall_ms_per_step": wall_ms / args.steps,
        "device_busy_ms_per_step": None if busy is None
        else busy / args.steps,
        "idle_share": None if busy is None else max(0.0, 1 - busy / wall_ms),
    })
    print(f"[profile] {args.mode} step, batch {batch}, {backbone}, "
          f"{out['device']}: {out['lane']} {out['total_ms_per_step']:.3f} "
          f"ms a step over {len(out['rows'])} names; wall "
          f"{out['wall_ms_per_step']:.3f} ms a step"
          + ("" if busy is None else
             f"; device busy {out['device_busy_ms_per_step']:.3f} ms, idle "
             f"share {out['idle_share']:.3f}"))
    print(f"{'ms/step':>10} {'%':>6} {'calls':>7}  category / name")
    for r in out["rows"][:args.top]:
        print(f"{r['ms_per_step']:10.3f} {r['pct']:6.2f} "
              f"{r['calls_per_step']:7.1f}  {r['category']}: "
              f"{r['name'][:100]}")
    print("by category:")
    for cat, ms in out["categories"].items():
        print(f"{ms:10.3f} ms  {cat}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f)
    if args.keep_trace:
        os.makedirs(args.keep_trace, exist_ok=True)
        prof.export_chrome_trace(os.path.join(
            args.keep_trace, f"profile_step_{args.mode}.json"))
    sys.stdout.flush()
    return out


if __name__ == "__main__":
    main()
