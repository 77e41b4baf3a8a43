"""Helpers the port's measurement tools share: the synthetic JPEG recipe,
device selection and CUDA-event timing."""

from __future__ import annotations

import time

import numpy as np


def synth_jpeg(rng: np.random.Generator, path: str, wh=(256, 256),
               quality: int = 85) -> None:
    """One synthetic JPEG: 16x16 noise upsampled to ``wh`` (PIL's (width,
    height)) — the JAX tools' recipe, so that both measure the same image
    statistics (about 10 KB a file, decoded by the real JPEG path)."""
    from PIL import Image

    low = rng.integers(0, 255, (16, 16, 3), dtype=np.uint8)
    Image.fromarray(low).resize(wh, Image.BILINEAR).save(path,
                                                         quality=quality)


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def elapsed_ms(fn, reps: int, device) -> float:
    """The time of ``reps`` calls of ``fn`` in a row, ms: CUDA events on
    the card, the host clock on the CPU."""
    import torch

    sync(device)
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end)


def slope_ms(step, x0, device, pairs: int = 5, small: int = 2,
             big: int = 8) -> float:
    """The time of one ``step`` in a chain ``x = step(x)`` as the slope
    over two repetition counts, (t(big) − t(small)) / (big − small), the
    median of ``pairs`` pairs: the launch queue's fill and the final sync
    cancel (the JAX ``perf_guard``'s method, on CUDA events)."""
    state = {"x": x0}

    def run():
        state["x"] = step(state["x"])

    run()
    sync(device)
    slopes = []
    for _ in range(pairs):
        t_small = elapsed_ms(run, small, device)
        t_big = elapsed_ms(run, big, device)
        slopes.append((t_big - t_small) / (big - small))
    return float(np.median(slopes))
