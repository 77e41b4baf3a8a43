"""Host input pipeline throughput, for both decoders:

    python -m situation_recognition_tpu_torch.tools.bench_input \\
        [--img_dir DIR] [--n 256] [--batch 64] [--workers 4] [--epochs 2]

The counterpart of the JAX package's ``tools/bench_input.py``: the
loader's decode and window rate (img/s) over ``--img_dir`` (or ``--n``
synthetic 340×256 JPEGs written to a temporary directory, the long-axis
window path) for the native libjpeg batch decoder
(``data/native_decoder.py``) and PIL per image, then with the decoded
cache (PIL fills it in the first epoch).  One JSON line per path:
``{"decoder", "img_s": [per epoch]}``, or ``"unavailable"`` with the
reason where the native decoder does not build.  The rate to beat is
the train step's consumption (``python -m
situation_recognition_tpu_torch.bench``: batch / step time).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import time


def synth_dir(n: int, wh=(340, 256)) -> tuple:
    """``n`` synthetic JPEGs in a new temporary directory → (dir, names)."""
    import numpy as np

    from situation_recognition_tpu_torch.tools.common import synth_jpeg

    tmp = tempfile.mkdtemp(prefix="srtorch_input_bench_")
    rng = np.random.default_rng(0)
    names = []
    for i in range(n):
        name = f"synth_{i}.jpg"
        synth_jpeg(rng, os.path.join(tmp, name), wh=wh, quality=90)
        names.append(name)
    return tmp, names


def loader_rates(img_dir: str, names, decoder: str, batch: int,
                 workers: int, epochs: int, cache: bool = False) -> list:
    """img/s of each of ``epochs`` passes of a train loader."""
    from situation_recognition_tpu_torch.data.dataset import (
        ImsituDataset, ImsituLoader)
    from situation_recognition_tpu_torch.data.encoder import ImsituEncoder

    ann = {n: {"verb": "v", "frames": [{"agent": "x"}] * 3} for n in names}
    enc = ImsituEncoder(ann, verbose=False)
    ds = ImsituDataset(img_dir, ann, enc, train=True)
    if cache:
        ds.enable_decode_cache()
    loader = ImsituLoader(ds, batch_size=batch, shuffle=True,
                          num_workers=workers, decoder=decoder)
    if loader.decoder != decoder:
        raise RuntimeError(f"the loader took {loader.decoder!r}")
    rates = []
    for e in range(epochs):
        loader.set_epoch(e)
        t0 = time.perf_counter()
        count = sum(len(b["verbs"]) for b in loader)
        rates.append(count / (time.perf_counter() - t0))
    return rates


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--img_dir", default="")
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--epochs", type=int, default=2)
    args = ap.parse_args(argv)

    tmp = None
    if args.img_dir:
        img_dir = args.img_dir
        names = sorted(os.listdir(img_dir))[:args.n]
    else:
        tmp, names = synth_dir(args.n)
        img_dir = tmp
    rows = []
    try:
        for decoder, cache in (("native", False), ("python", False),
                               ("python", True)):
            row = {"decoder": decoder + (" cached" if cache else ""),
                   "images": len(names), "batch": args.batch,
                   "workers": args.workers}
            try:
                row["img_s"] = [round(r, 1) for r in loader_rates(
                    img_dir, names, decoder, args.batch, args.workers,
                    args.epochs, cache)]
            except Exception as e:  # noqa: BLE001 — a decoder that does
                row["unavailable"] = str(e)[:200]  # not build here
            print(json.dumps(row), flush=True)
            rows.append(row)
    finally:
        if tmp:
            shutil.rmtree(tmp, ignore_errors=True)
    return rows


if __name__ == "__main__":
    main()
