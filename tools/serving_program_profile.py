#!/usr/bin/env python3
"""The flagship's ``cuda`` serving program against the eager model rebuilt
from the same artifact, on one batch of 256 on the card:

    python3 tools/serving_program_profile.py [--reps 5]

Exports ResNet-152 + FCGGNN (d=2048, bf16, random weights and BN
statistics as ``chip_smoke.py``'s) with ``export_serving.export_model``,
loads it both ways, and prints for each, twice in turns: the host's time
to enqueue a call and its wall time (synchronised), the time of a call by
CUDA events, then the device time by kernel (``torch.profiler``).  Needs
one card.
"""

import argparse
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    import chip_smoke as cs
    from situation_recognition_tpu_torch.data.encoder import ImsituEncoder
    from situation_recognition_tpu_torch.export_serving import export_model
    from situation_recognition_tpu_torch.ops import _build
    from situation_recognition_tpu_torch.serving import load_inference

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build(cs.SOURCES)
    print(cs._nvidia_smi(), flush=True)
    model = cs._random_model(ImsituEncoder.synthetic_full(0), 0).to("cuda")
    tmp = tempfile.mkdtemp(prefix="srtorch_profile_")
    try:
        export_model(model, tmp, batch_size=cs.BATCH, weights="f32",
                     target="cuda")
        calls = {"program": load_inference(tmp),
                 "eager": load_inference(tmp, rebuild=True)}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    images = torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, (cs.BATCH, 256, 256, 3), dtype=np.uint8)).cuda()
    for fn in list(calls.values()) * 2:
        fn(images)
    torch.cuda.synchronize()
    for name in ("program", "eager") * 2:
        fn = calls[name]
        host = []
        for _ in range(args.reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(images)
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            host.append((round((t1 - t0) * 1e3, 2),
                         round((time.perf_counter() - t0) * 1e3, 2)))
        print(f"{name}: enqueue / wall ms {host}; "
              f"{cs._time_ms(lambda: fn(images), args.reps):.3f} ms a call "
              f"by CUDA events", flush=True)
    for name, fn in calls.items():
        cs._profile(name, lambda: fn(images), tag=name, top=10)


if __name__ == "__main__":
    main()
