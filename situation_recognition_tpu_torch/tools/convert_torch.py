"""The JAX package's msgpack files → the port's torch files, without JAX:

    # a JAX resume checkpoint (msgpack) → the reference's checkpoint .pth,
    # which the port (and the reference) resume from
    python -m situation_recognition_tpu_torch.tools.convert_torch \\
        checkpoint checkpoints/model model.pth [--lr 0.002]

    # a JAX backbone msgpack ({params, batch_stats}) → the port's backbone
    # state dict .pth (ResNet or ViT, sniffed)
    python -m situation_recognition_tpu_torch.tools.convert_torch \\
        backbone backbone.msgpack backbone.pth

Reads with ``utils/msgpack.py``.  Checkpoint mode is
``convert.export_reference_checkpoint``: the model in the reference's key
layout (both twin backbones), Adamax's state in ``torch.optim.Adamax``'s
layout at ``--lr``, the epoch, the six histories, the dropout step count
and a mid-epoch snapshot.  Backbone mode writes ``convert``'s
``resnet_state_from_jax`` or ``vit_state_from_jax``, which the CLI's
``--backbone_ckpt`` and ``Trainer.load_backbone_state`` read.
"""

from __future__ import annotations

import argparse
import json


def backbone_state(tree) -> dict:
    """A JAX backbone tree ({params, [batch_stats]}) → the port's state
    dict (ResNet or ViT, by its leaves)."""
    from situation_recognition_tpu_torch import convert

    params = tree["params"]
    if "cls_token" in params:
        return convert.vit_state_from_jax(params)
    return convert.resnet_state_from_jax(params, tree.get("batch_stats")
                                         or {})


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("mode", choices=["checkpoint", "backbone"])
    ap.add_argument("src", help="the JAX package's msgpack file")
    ap.add_argument("dst", help="output torch .pth path")
    ap.add_argument("--lr", type=float, default=0.002,
                    help="the rate put in Adamax's param_groups "
                         "(checkpoint mode; the reference's default)")
    args = ap.parse_args(argv)

    from situation_recognition_tpu_torch import convert
    from situation_recognition_tpu_torch.utils import msgpack
    from situation_recognition_tpu_torch.utils.checkpoint import (
        save_checkpoint)

    tree = msgpack.read(args.src)
    if args.mode == "checkpoint":
        out = convert.export_reference_checkpoint(tree, lr=args.lr)
        tensors = len(out["model_state_dict"])
    else:
        out = backbone_state(tree)
        tensors = len(out)
    save_checkpoint(args.dst, out)
    print(json.dumps({"mode": args.mode, "src": args.src, "dst": args.dst,
                      "tensors": tensors}))


if __name__ == "__main__":
    main()
