"""The port's bench (``python -m situation_recognition_tpu_torch.bench``)
on the CPU: with ``BENCH_DEVICE=cpu`` it prints one JSON line with the JAX
bench's keys (the secondary eval and serving numbers on the same line);
without a card and without that switch it stops with an error line; and
its work count — ``FlopCounterMode`` over the plain twins — equals a hand
count of the masked GGNN propagate written from ``ops/ggnn.py``."""

import json
import os
import subprocess
import sys

import pytest
import torch

from situation_recognition_tpu_torch import bench
from situation_recognition_tpu_torch.ops.ggnn import (
    GGNNParams, ggnn_propagate, ggnn_propagate_verb)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = {"metric", "value", "unit", "vs_baseline", "step_ms", "mfu"}


def _bench(**env):
    full = {k: v for k, v in os.environ.items() if not k.startswith("BENCH")}
    full.update(PYTHONPATH=_REPO, OMP_NUM_THREADS="2", **env)
    return subprocess.run(
        [sys.executable, "-m", "situation_recognition_tpu_torch.bench"],
        env=full, cwd=_REPO, capture_output=True, text=True, timeout=300)


def test_cpu_run_prints_one_line_with_the_contract_keys():
    proc = _bench(BENCH_DEVICE="cpu", BENCH_STEPS="2", BENCH_SECONDARY="1")
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[-1])
    assert KEYS <= set(out)
    assert out["metric"] == "train_images_per_sec_per_chip"
    assert out["unit"] == "img/s/chip" and out["value"] > 0
    assert out["mfu"] is None          # no bf16 peak for a CPU
    assert out["step_tflop"] > 0 and out["batch"] == 8
    assert out["eval_img_s"] > 0 and out["serving_img_s"] > 0
    assert out["vs_baseline"] == round(
        out["value"] / bench.REFERENCE_IMG_PER_SEC_PER_CHIP, 2)


def test_refuses_to_start_without_a_card():
    proc = _bench(CUDA_VISIBLE_DEVICES="")
    assert proc.returncode != 0
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["value"] is None and "BENCH_DEVICE=cpu" in out["error"]


@pytest.mark.parametrize("backward", [False, True])
def test_flop_count_of_the_masked_propagate_is_the_hand_count(backward):
    """``ops/ggnn.py`` per step: agg @ W_p, then n @ W_z, h @ U_z, n @ W_r,
    h @ U_r, n @ W_h and (r·h) @ U_h — seven (M, d) @ (d, d) products of
    2·M·d² each, M = B·R (the verb branch: M = B); the backward of each
    product is two more of the same size."""
    b, r, d, steps = 3, 5, 32, 4
    g = torch.Generator().manual_seed(0)
    p = GGNNParams(*(torch.randn((d, d) if i % 2 == 0 else (d,),
                                 generator=g).requires_grad_(backward)
                     for i in range(14)))
    h = torch.randn(b, r, d, generator=g).requires_grad_(backward)
    mask = (torch.rand(b, r, generator=g) < 0.6).float()
    per_pass = 3 if backward else 1

    def run(fn):
        def go():
            out = fn()
            if backward:
                out.sum().backward()
        return go

    got = bench.count_flops(run(lambda: ggnn_propagate(p, h, mask, steps)))
    assert got == per_pass * steps * 7 * 2 * (b * r) * d * d
    got = bench.count_flops(run(lambda: ggnn_propagate_verb(p, h[:, 0],
                                                            steps)))
    assert got == per_pass * steps * 7 * 2 * b * d * d


def test_peak_table_knows_the_h100_and_no_guess():
    assert bench.peak_flops("NVIDIA H100 80GB HBM3") == 989.4e12
    assert bench.peak_flops("NVIDIA GeForce RTX 4090") is None
    assert bench.peak_flops("cpu") is None


def test_step_flops_run_the_plain_twins():
    """The work of a train step is counted on the masked GGNN whatever
    the trainer runs, and the trainer's paths are restored after."""
    tr, (images, flip, verbs, labels, valid) = bench.bench_trainer(
        torch.device("cpu"), 2, "mini", image_size=32)
    tr.head.ggsnn.impl = "kernel"
    seen = []
    orig = tr.head.ggsnn._route

    def route(hidden):
        seen.append(orig(hidden))
        return seen[-1]

    tr.head.ggsnn._route = route
    flops = bench.step_flops(tr, lambda: tr.train_step(
        images, flip, verbs, labels, valid))
    assert flops > 0 and set(seen) == {"masked"}
    assert tr.head.ggsnn.impl == "kernel"
