"""Benchmark: the flagship train step's throughput, in images/s per card.

    python -m situation_recognition_tpu_torch.bench

The port's counterpart of the JAX package's ``bench.py``.  It times the
whole train step — device preprocessing of the uint8 windows, the frozen
ResNet-152 in bf16 with train-mode BatchNorm, the FCGGNN head forward and
backward (K1 for the gt-verb branch), the masked losses, the clip and
Adamax, the top-k on the device — on synthetic device-resident batches of
the ``synthetic_full`` vocabulary (504 / 190 / 2001, R=6), steady state
after two warm steps, and prints ONE JSON line:

    {"metric": "<mode>_images_per_sec_per_chip", "value", "unit",
     "vs_baseline", "step_ms", "mfu", ...}

``vs_baseline`` divides by the JAX bench's estimate of the reference's
rate on one GPU, 200 img/s (the reference publishes none).  ``mfu`` is the
step's work over the timed step over the card's dense bf16 peak
(``PEAK_BF16``, by device name; an unknown card gives ``null`` and a
stderr line).  The work is counted the same way whatever implements a
kernel: ``torch.utils.flop_counter.FlopCounterMode`` over one untimed step
of the same trainer with the kernels' plain twins (the masked GGNN, plain
ViT blocks) at the same shapes (``step_flops``).  The JAX bench's
``hbm_util`` has no counterpart: torch has no analysis of a step's bytes.

In train mode the bench then measures the eval step and a served batch of
a baked artifact (``serving.export_inference``) and adds ``eval_img_s`` and
``serving_img_s`` to the same line, while the wall clock leaves room
(``BENCH_SECONDARY=0`` skips them).  One deadline, ``BENCH_TOTAL_BUDGET``
seconds (480): past it the bench prints the train line without the
secondary numbers, or an error line if the train step was not measured
yet, and exits.

Switches (the JAX bench's): ``BENCH_MODE`` train | eval | serving,
``BENCH_BATCH`` (768 a card: the reference's 6144 over 8 chips),
``BENCH_BACKBONE``, ``BENCH_STEPS`` (20), ``BENCH_IMAGE_SIZE`` (224),
``BENCH_FROZEN_BN`` train | eval, ``BENCH_TRAIN_BACKBONE=1`` (fine-tuning,
with ``BENCH_REMAT`` 1 by default), and for serving ``BENCH_WEIGHTS`` f32 |
bf16 | int8, ``BENCH_BAKE`` (1: the weights inside the programs) and
``BENCH_TARGET`` portable | cuda (the kernels in the programs; the
default on the card, where JAX's default is its portable target, which a
bf16 model on the card would serve rebuilt through the same kernels).
It runs on the card; ``BENCH_DEVICE=cpu`` asks for the CPU (the mini
backbone, batch 8, 3 steps, f32, as the JAX bench's CPU defaults), and
without a card and without that switch it stops with an error line.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

#: the JAX bench's estimate of the reference's img/s on one GPU
REFERENCE_IMG_PER_SEC_PER_CHIP = 200.0
#: dense bf16 tensor-core peaks, FLOP/s, by a substring of the device name
PEAK_BF16 = (("H100 80GB HBM3", 989.4e12), ("H100 SXM", 989.4e12),
             ("H100 PCIe", 756.5e12), ("A100", 312e12))


def bench_batch_backbone(on_card: bool) -> tuple:
    """``BENCH_BATCH`` and ``BENCH_BACKBONE`` with their defaults: 768 and
    ResNet-152 on the card, 8 and mini on the CPU (shared with the
    tools)."""
    batch = int(os.environ.get("BENCH_BATCH", 768 if on_card else 8))
    backbone = os.environ.get("BENCH_BACKBONE",
                              "resnet152" if on_card else "mini")
    return batch, backbone


def bench_trainer(device, batch: int, backbone: str, **config):
    """A trainer of the bench's configuration on ``device`` over the
    ``synthetic_full`` vocabulary (bf16 on the card, f32 on the CPU), and
    one synthetic batch of ``batch`` rows on the device as its steps take
    it: (images, flip, verbs, labels, valid)."""
    import numpy as np
    import torch

    from situation_recognition_tpu_torch.cli import _default_hidden
    from situation_recognition_tpu_torch.data.encoder import ImsituEncoder
    from situation_recognition_tpu_torch.train import Trainer, TrainerConfig

    encoder = ImsituEncoder.synthetic_full()
    cfg = TrainerConfig(
        hidden=_default_hidden(backbone), batch_size=batch,
        backbone=backbone,
        compute_dtype=(torch.bfloat16 if torch.device(device).type == "cuda"
                       else torch.float32), **config)
    trainer = Trainer(encoder, cfg, device=device)
    rng = np.random.default_rng(0)
    host = {
        "images": rng.integers(0, 255, (batch, 256, 256, 3),
                               dtype=np.uint8),
        "flip": rng.random(batch) < 0.5,
        "verbs": rng.integers(0, encoder.get_num_verbs(), batch),
        "labels": rng.integers(0, encoder.get_num_labels(),
                               (batch, 3, encoder.max_role_count)),
    }
    return trainer, trainer._upload(host)[0]


def peak_flops(name: str):
    """The dense bf16 peak of the card called ``name``, or ``None``."""
    for key, peak in PEAK_BF16:
        if key in name:
            return peak
    return None


def count_flops(fn) -> int:
    """The FLOPs ``fn()`` runs, forward and backward, by
    ``FlopCounterMode`` (matrix products and convolutions)."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter:
        fn()
    return int(counter.get_total_flops())


@contextlib.contextmanager
def plain_twins(trainer):
    """The trainer with the kernels' plain twins in place: the masked
    GGNN and, for a ViT, plain encoder blocks."""
    ggnn = trainer.head.ggsnn
    saved = (ggnn.impl, getattr(trainer.backbone, "block_impl", None))
    ggnn.impl = "masked"
    if saved[1] is not None:
        trainer.backbone.block_impl = "plain"
    try:
        yield
    finally:
        ggnn.impl = saved[0]
        if saved[1] is not None:
            trainer.backbone.block_impl = saved[1]


def step_flops(trainer, step) -> int:
    """The work of one ``step()`` of ``trainer`` (run, untimed) through
    the plain twins at the same shapes."""
    with plain_twins(trainer):
        return count_flops(step)


def serving_model(trainer):
    """The trainer's weights as a ``serving.SituationModel`` on its
    device (eval mode)."""
    from situation_recognition_tpu_torch.serving import SituationModel

    cfg = trainer.config
    model = SituationModel(trainer.encoder, backbone=cfg.backbone,
                           hidden=cfg.hidden, image_size=cfg.image_size,
                           num_steps=cfg.num_ggnn_steps,
                           dtype=cfg.compute_dtype)
    model.backbone.load_state_dict(
        {k: v.float() if v.is_floating_point() else v
         for k, v in trainer._backbone_source().items()}, strict=True)
    model.head.load_state_dict(trainer.head.state_dict(), strict=True)
    return model.eval().to(trainer.device)


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _served(trainer, images, verbs, steps: int, weights: str, bake: bool,
            target: str) -> dict:
    """Export the trainer's model, load it on its device and time
    ``steps`` served batches after two warm calls of both entries."""
    import numpy as np

    from situation_recognition_tpu_torch.serving import (
        export_inference, load_inference)

    dev = trainer.device
    art = tempfile.mkdtemp(prefix="srtorch_bench_serving_")
    try:
        export_inference(serving_model(trainer), art,
                         batch_size=images.shape[0], weights=weights,
                         bake_weights=bake, platform=target)
        fn = load_inference(art, device=dev)
    finally:
        shutil.rmtree(art, ignore_errors=True)
    for _ in range(2):
        fn(images)[1][0].item()
        fn.gt(images, verbs)[0, 0, 0].item()
    t0 = time.perf_counter()
    for _ in range(steps):
        out = fn(images)
    out[1][0].item()
    dt = time.perf_counter() - t0
    percall = {"argmax": [], "gt": []}
    for _ in range(max(2, min(steps, 8))):
        for entry, call in (("argmax", lambda: fn(images)[1][0]),
                            ("gt", lambda: fn.gt(images, verbs)[0, 0, 0])):
            t1 = time.perf_counter()
            call().item()
            percall[entry].append(time.perf_counter() - t1)
    _sync(dev)
    return {"img_s": images.shape[0] * steps / dt,
            "step_ms": dt / steps * 1e3,
            "argmax_percall_ms": float(np.median(percall["argmax"])) * 1e3,
            "gt_entry_percall_ms": float(np.median(percall["gt"])) * 1e3}


def _nvidia_smi() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


class _Line:
    """The one JSON line, printed once: by ``emit`` at the end, or by the
    deadline (the train line without the secondary numbers, or an error
    line when no result exists yet)."""

    def __init__(self, metric: str, budget: float):
        self.metric = metric
        self.out = None
        self._lock = threading.Lock()
        self._done = False
        self._timer = threading.Timer(budget, self._deadline, (budget,))
        self._timer.daemon = True
        self._timer.start()

    def _print(self, obj) -> bool:
        with self._lock:
            if self._done:
                return False
            self._done = True
            self._timer.cancel()
        print(json.dumps(obj), flush=True)
        return True

    def _deadline(self, budget: float) -> None:
        if self.out is None:
            obj = {"metric": self.metric, "value": None,
                   "unit": "img/s/chip",
                   "error": f"the bench did not finish within {budget:.0f}s"}
            code = 2
        else:
            obj = {**self.out, "secondary_skipped":
                   "secondary phase overran the window budget"}
            code = 0
        if self._print(obj):
            sys.stderr.flush()
            os._exit(code)

    def emit(self, obj) -> None:
        self._print(obj)


def main() -> int:
    t_start = time.perf_counter()

    def phase(name: str) -> None:
        print(f"[bench] t={time.perf_counter() - t_start:.1f}s {name}",
              file=sys.stderr, flush=True)

    mode = os.environ.get("BENCH_MODE", "train")
    if mode not in ("train", "eval", "serving"):
        raise SystemExit(f"BENCH_MODE must be train|eval|serving, got "
                         f"{mode!r}")
    metric = f"{mode}_images_per_sec_per_chip"
    budget = float(os.environ.get("BENCH_TOTAL_BUDGET", "480"))
    line = _Line(metric, budget)

    import numpy as np
    import torch

    dev_name = os.environ.get("BENCH_DEVICE", "cuda")
    if dev_name not in ("cuda", "cpu"):
        raise SystemExit(f"BENCH_DEVICE must be cuda|cpu, got {dev_name!r}")
    if dev_name == "cuda" and not torch.cuda.is_available():
        line.emit({"metric": metric, "value": None, "unit": "img/s/chip",
                   "error": "no CUDA device; BENCH_DEVICE=cpu runs the "
                            "bench on the CPU"})
        return 2
    on_card = dev_name == "cuda"
    device = torch.device(dev_name)

    batch, backbone = bench_batch_backbone(on_card)
    steps = int(os.environ.get("BENCH_STEPS", 20 if on_card else 3))
    frozen_bn = os.environ.get("BENCH_FROZEN_BN", "train")
    if frozen_bn not in ("train", "eval"):
        raise SystemExit(f"BENCH_FROZEN_BN must be train|eval, got "
                         f"{frozen_bn!r}")
    image_size = int(os.environ.get("BENCH_IMAGE_SIZE", "224"))
    train_bb = os.environ.get("BENCH_TRAIN_BACKBONE", "0") == "1"
    bb_remat = train_bb and os.environ.get("BENCH_REMAT", "1") == "1"
    weights = os.environ.get("BENCH_WEIGHTS", "f32")
    bake = os.environ.get("BENCH_BAKE", "1") != "0"
    target = os.environ.get("BENCH_TARGET",
                            "cuda" if on_card else "portable")
    secondary = os.environ.get("BENCH_SECONDARY",
                               "1" if on_card else "0") == "1"
    kind = torch.cuda.get_device_name(device) if on_card else "cpu"
    if on_card:
        print(f"[bench] {_nvidia_smi()}", file=sys.stderr, flush=True)
        torch.backends.cudnn.benchmark = True

    trainer, (images, flip, verbs, labels, valid) = bench_trainer(
        device, batch, backbone, frozen_backbone_bn=frozen_bn,
        image_size=image_size, train_backbone=train_bb,
        remat_backbone=bb_remat)
    phase("trainer built, batch on the device")

    if mode == "serving":
        got = _served(trainer, images, verbs, steps, weights, bake, target)
        out = {"metric": metric, "value": round(got["img_s"], 2),
               "unit": "img/s/chip", "step_ms": round(got["step_ms"], 2),
               "argmax_percall_ms": round(got["argmax_percall_ms"], 2),
               "gt_entry_percall_ms": round(got["gt_entry_percall_ms"], 2),
               "weights": weights, "bake_weights": bake, "target": target,
               "device": kind}
        line.emit(out)
        return 0

    if mode == "eval":
        def step():
            return trainer.eval_step(images, verbs, labels, valid)[0]
    else:
        def step():
            return trainer.train_step(images, flip, verbs, labels, valid)[0]

    flops = step_flops(trainer, step)
    _sync(device)
    phase(f"work of a step through the plain twins: {flops / 1e12:.3f} "
          f"TFLOP")
    for _ in range(2):
        float(step()[0])
    phase("warm steps done")
    t0 = time.perf_counter()
    for _ in range(steps):
        losses = step()
    sync = float(losses[0])
    dt = time.perf_counter() - t0
    if not np.isfinite(sync):
        raise SystemExit(f"non-finite loss {sync}")
    img_s = batch * steps / dt
    step_ms = dt / steps * 1e3
    peak = peak_flops(kind) if on_card else None
    mfu = None
    if peak is None:
        print(f"[bench] no bf16 peak known for {kind!r}: mfu is null",
              file=sys.stderr)
    else:
        mfu = flops / (step_ms / 1e3) / peak
        print(f"[bench] step {step_ms:.1f} ms | MFU {mfu * 100:.1f}% of "
              f"{peak / 1e12:.1f} TFLOP/s", file=sys.stderr)
    out = {"metric": metric, "value": round(img_s, 2), "unit": "img/s/chip",
           "vs_baseline": round(img_s / REFERENCE_IMG_PER_SEC_PER_CHIP, 2),
           "baseline": "estimated-200-img/s-per-gpu (unpublished; the JAX "
                       "bench's derivation)",
           "step_ms": round(step_ms, 3), "step_tflop": flops / 1e12,
           "mfu": None if mfu is None else round(mfu, 4), "batch": batch,
           "backbone": backbone, "device": kind}
    if frozen_bn != "train":
        out["frozen_bn"] = frozen_bn
    if train_bb:
        out["train_backbone"] = True
    if image_size != 224:
        out["image_size"] = image_size
    line.out = dict(out)
    phase("train line ready")

    elapsed = time.perf_counter() - t_start
    if mode == "train" and not train_bb and secondary:
        try:
            if elapsed < budget - 45:
                n = max(5, steps // 2)
                float(trainer.eval_step(images, verbs, labels, valid)[0][0])
                t0 = time.perf_counter()
                for _ in range(n):
                    losses = trainer.eval_step(images, verbs, labels,
                                               valid)[0]
                float(losses[0])
                out["eval_img_s"] = round(
                    batch * n / (time.perf_counter() - t0), 2)
                phase("eval measured")
            if time.perf_counter() - t_start < budget - 120:
                got = _served(trainer, images, verbs, max(5, steps // 2),
                              weights, bake, target)
                out["serving_img_s"] = round(got["img_s"], 2)
                phase("serving measured")
        except Exception as e:  # noqa: BLE001 — never lose the train line
            out["secondary_error"] = str(e)[:200]
    line.emit(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
