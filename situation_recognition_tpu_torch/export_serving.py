"""Export a trained checkpoint as a serving artifact:

    python -m situation_recognition_tpu_torch.export_serving CKPT OUT \\
        [--batch_size 256] [--backbone resnet152] [--weights f32|bf16|int8] \\
        [--target portable|cuda] [--external] [--dataset_folder imSitu] \\
        [--precision fp32|bf16] [--image_size 224]

The face of ``serving.export_inference``, with the JAX package's
``tools/export_serving.py`` flags.  ``CKPT`` is this package's or the
reference's ``torch.save`` checkpoint, or the JAX package's msgpack
checkpoint (read without JAX: ``utils/msgpack.py``,
``convert.export_reference_checkpoint``).  The vocabulary is rebuilt from
``<dataset_folder>/train.json``, the reference's rule (a checkpoint holds
none).  ``--target cuda`` keeps the CUDA kernels in the programs and needs
the card (bf16 compute for the kernels); ``portable`` exports the plain
paths, on the card unless ``--platform cpu``.  As in the JAX tool the
weights are baked into the programs unless ``--external`` writes them to
``weights.pt`` beside programs that take them as their argument.  A Swin
backbone is refused: the serving programs have no Swin path.
"""

from __future__ import annotations

import argparse
import json
import os


def read_states(path: str):
    """A checkpoint file (torch or JAX msgpack) → (backbone state, head
    state) in the port's layout."""
    from situation_recognition_tpu_torch import convert
    from situation_recognition_tpu_torch.cli import _is_torch_checkpoint
    from situation_recognition_tpu_torch.utils import msgpack
    from situation_recognition_tpu_torch.utils.checkpoint import (
        load_checkpoint)

    if _is_torch_checkpoint(path):
        ckpt = load_checkpoint(path)
    else:
        ckpt = convert.export_reference_checkpoint(msgpack.read(path))
    return convert.from_reference(ckpt["model_state_dict"])


def export_model(model, out: str, batch_size: int = 1, weights: str = "f32",
                 target: str = "portable", bake: bool = False) -> int:
    """``serving.export_inference`` of ``model`` into ``out`` → the
    artifact's bytes."""
    from situation_recognition_tpu_torch.serving import export_inference

    export_inference(model, out, batch_size=batch_size, weights=weights,
                     platform=target, bake_weights=bake)
    return sum(os.path.getsize(os.path.join(out, f))
               for f in os.listdir(out))


def main(argv=None) -> None:
    from situation_recognition_tpu_torch.models.backbone import BACKBONES

    ap = argparse.ArgumentParser(
        description="Export a trained checkpoint as a serving artifact")
    ap.add_argument("checkpoint", help="torch or JAX msgpack checkpoint")
    ap.add_argument("out", help="artifact output directory")
    ap.add_argument("--batch_size", type=int, default=1,
                    help="the baked serving batch (the loader pads and "
                         "chunks any batch onto it)")
    ap.add_argument("--backbone", default="resnet152",
                    choices=list(BACKBONES))
    ap.add_argument("--weights", default="f32",
                    choices=["f32", "bf16", "int8"],
                    help="weight encoding: f32 exact; bf16 and int8 "
                         "(per-channel symmetric) 2x and 4x smaller "
                         "matrices")
    ap.add_argument("--external", action="store_true",
                    help="write the weights to weights.pt beside programs "
                         "that take them as their argument (default: "
                         "baked into each program)")
    ap.add_argument("--target", default="portable",
                    choices=["portable", "cuda"],
                    help="portable: runs on the CPU and the card (no "
                         "kernels); cuda: the CUDA kernels in the programs "
                         "(card only, faster)")
    ap.add_argument("--dataset_folder", default="imSitu",
                    help="folder whose train.json defines the vocabulary")
    ap.add_argument("--precision", default="fp32", choices=["fp32", "bf16"],
                    help="compute type baked into the programs (bf16 for "
                         "the kernels)")
    ap.add_argument("--image_size", type=int, default=224,
                    help="the model's input resolution (a ViT's position "
                         "embedding grid)")
    ap.add_argument("--platform", default="auto", choices=["auto", "cpu"],
                    help="where the programs are traced: auto, the card; "
                         "cpu for a portable artifact without one")
    args = ap.parse_args(argv)
    from situation_recognition_tpu_torch.models.swin import SWIN_CONFIGS

    if args.backbone in SWIN_CONFIGS:
        ap.error("a Swin backbone cannot be exported: the serving programs "
                 "have no Swin path (train and evaluate it with the CLI)")
    if args.target == "cuda" and args.platform == "cpu":
        ap.error("--target cuda traces the CUDA kernels: it needs the card")

    import torch

    from situation_recognition_tpu_torch.cli import _default_hidden
    from situation_recognition_tpu_torch.data.encoder import ImsituEncoder
    from situation_recognition_tpu_torch.device import resolve_device
    from situation_recognition_tpu_torch.serving import SituationModel

    with open(os.path.join(args.dataset_folder, "train.json")) as f:
        encoder = ImsituEncoder(json.load(f), verbose=False)
    device = resolve_device("cpu" if args.platform == "cpu" else "cuda")
    dtype = torch.bfloat16 if args.precision == "bf16" else torch.float32
    model = SituationModel(encoder, backbone=args.backbone,
                           hidden=_default_hidden(args.backbone),
                           image_size=args.image_size, dtype=dtype)
    backbone, head = read_states(args.checkpoint)
    model.backbone.load_state_dict(backbone, strict=True)
    model.head.load_state_dict(head, strict=True)
    model.to(device)
    total = export_model(model, args.out, batch_size=args.batch_size,
                         weights=args.weights, target=args.target,
                         bake=not args.external)
    kind = "external" if args.external else "baked"
    print(f"exported {args.out} (batch {args.batch_size}, weights "
          f"{args.weights} {kind}, target {args.target}, "
          f"{total / 1e6:.1f} MB): entries argmax + gt")


if __name__ == "__main__":
    main()
