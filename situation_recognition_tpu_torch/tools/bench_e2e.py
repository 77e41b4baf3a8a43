"""End-to-end training throughput, stage by stage:

    python -m situation_recognition_tpu_torch.tools.bench_e2e [N_IMAGES] \\
        [--device cuda|cpu]

The counterpart of the JAX package's ``tools/bench_e2e.py``.  It writes N
(default 3072) synthetic JPEGs with reference-schema annotations over the
``synthetic_full`` vocabulary into a temporary folder and measures each
stage of the real training path, in img/s:

* ``input_cold``  — the loader's first epoch, every image JPEG-decoded
  (the native batch decoder where it builds);
* ``input_cache_fill`` / ``input_warm`` — the decoded cache being filled
  (PIL per image), then hit;
* ``h2d``         — one uint8 batch copied from pinned memory to the card
  (also in MB/s; none on the CPU);
* ``step``        — the device-resident train step (the bench's);
* ``e2e``         — ``Trainer.train_epoch`` through the loader, measured;
* ``e2e_devcache``— an epoch from the window cache on the device
  (``--cache_device``), after its one upload (``devcache_upload_s``);
* ``bottleneck``  — the slowest of ``input_warm``, ``h2d`` and ``step``.

One JSON line.  ``BENCH_BATCH`` / ``BENCH_BACKBONE`` as the bench
(``bench.bench_batch_backbone``), ``BENCH_WORKERS`` (8) loader threads,
``BENCH_E2E_EPOCH=0`` / ``BENCH_E2E_DEVCACHE=0`` skip those stages.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time


def make_dataset(root: str, n_images: int, encoder, seed: int = 0):
    """n_images synthetic JPEGs over the full vocabulary, each with three
    frames of random nouns for its verb's roles → (image dir,
    annotations)."""
    import numpy as np

    from situation_recognition_tpu_torch.tools.common import synth_jpeg

    rng = np.random.default_rng(seed)
    nouns = [n for n in encoder.label_list if n not in ("", "UNK")]
    img_dir = os.path.join(root, "images")
    os.makedirs(img_dir, exist_ok=True)
    ann = {}
    for i in range(n_images):
        v = encoder.verb_list[int(rng.integers(0, len(encoder.verb_list)))]
        frames = [{r: nouns[int(rng.integers(0, len(nouns)))]
                   for r in encoder.roles_per_verb[v]} for _ in range(3)]
        name = f"{v}_{i}.jpg"
        ann[name] = {"verb": v, "frames": frames}
        synth_jpeg(rng, os.path.join(img_dir, name))
    return img_dir, ann


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("n_images", type=int, nargs="?", default=3072)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--steps", type=int, default=8,
                    help="timed device-resident steps")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from situation_recognition_tpu_torch.bench import (
        bench_batch_backbone, bench_trainer)
    from situation_recognition_tpu_torch.data.dataset import (
        ImsituDataset, ImsituLoader)
    from situation_recognition_tpu_torch.device import resolve_device
    from situation_recognition_tpu_torch.tools.common import sync

    device = resolve_device(args.device)
    on_card = device.type == "cuda"
    batch, backbone = bench_batch_backbone(on_card)
    trainer, (images, flip, verbs, labels, valid) = bench_trainer(
        device, batch, backbone)
    encoder = trainer.encoder
    root = tempfile.mkdtemp(prefix="srtorch_e2e_")
    out = {"metric": "e2e_train_pipeline", "unit": "img/s",
           "num_images": args.n_images, "batch": batch,
           "backbone": backbone,
           "device": torch.cuda.get_device_name(device) if on_card
           else "cpu"}
    try:
        t0 = time.perf_counter()
        img_dir, ann = make_dataset(root, args.n_images, encoder)
        print(f"[e2e] wrote {args.n_images} JPEGs in "
              f"{time.perf_counter() - t0:.1f} s", file=sys.stderr)
        dataset = ImsituDataset(img_dir, ann, encoder, train=True)
        # the cold stage runs before the decode cache is on: with it, the
        # loader fills the cache through PIL and skips the native decoder
        loader = ImsituLoader(dataset, batch_size=batch, shuffle=True,
                              seed=0, num_workers=int(os.environ.get(
                                  "BENCH_WORKERS", 8)))
        out["decoder"] = loader.decoder

        def run_epoch(tag, epoch):
            loader.set_epoch(epoch)
            t0 = time.perf_counter()
            seen = sum(len(b["verbs"]) for b in loader)
            out[tag] = round(seen / (time.perf_counter() - t0), 1)
            print(f"[e2e] {tag}: {out[tag]} img/s", file=sys.stderr)

        run_epoch("input_cold", 0)
        dataset.enable_decode_cache()
        run_epoch("input_cache_fill", 1)
        run_epoch("input_warm", 2)

        if on_card:
            host = torch.from_numpy(dataset.load_window(
                0, np.random.default_rng(0))[None].repeat(batch, axis=0)) \
                .pin_memory()
            host.to(device, non_blocking=True)
            sync(device)
            t0 = time.perf_counter()
            host.to(device, non_blocking=True)
            sync(device)
            dt = time.perf_counter() - t0
            out["h2d"] = round(batch / dt, 1)
            out["h2d_MBps"] = round(host.numel() / 1e6 / dt, 1)

        for _ in range(2):
            float(trainer.train_step(images, flip, verbs, labels,
                                     valid)[0][0])
        t0 = time.perf_counter()
        for _ in range(args.steps):
            losses = trainer.train_step(images, flip, verbs, labels,
                                        valid)[0]
        if not np.isfinite(float(losses[0])):
            raise SystemExit("non-finite loss")
        out["step"] = round(batch * args.steps / (time.perf_counter() - t0),
                            1)
        print(f"[e2e] step (device-resident): {out['step']} img/s",
              file=sys.stderr)

        if os.environ.get("BENCH_E2E_EPOCH", "1") != "0":
            t0 = time.perf_counter()
            _, _, epoch_losses = trainer.train_epoch(loader, epoch=3)
            if not all(np.isfinite(epoch_losses)):
                raise SystemExit(f"non-finite losses {epoch_losses}")
            out["e2e"] = round(args.n_images / (time.perf_counter() - t0),
                               1)
            print(f"[e2e] measured epoch: {out['e2e']} img/s",
                  file=sys.stderr)

        if os.environ.get("BENCH_E2E_DEVCACHE", "1") != "0":
            n_dc = min(args.n_images, 2 * batch)
            dc_ann = {k: ann[k] for k in list(ann)[:n_dc]}
            dc = ImsituDataset(img_dir, dc_ann, encoder, train=True)
            dc.enable_window_cache()
            dc_loader = ImsituLoader(dc, batch_size=batch, shuffle=True,
                                     seed=0)
            t0 = time.perf_counter()
            trainer._device_window_cache(dc)
            sync(device)
            out["devcache_upload_s"] = round(time.perf_counter() - t0, 3)
            trainer.train_epoch(dc_loader, epoch=4)
            t0 = time.perf_counter()
            trainer.train_epoch(dc_loader, epoch=5)
            out["e2e_devcache"] = round(n_dc / (time.perf_counter() - t0), 1)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    stages = {k: out[k] for k in ("input_warm", "h2d", "step") if k in out}
    out["bottleneck"] = min(stages, key=stages.get)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
