"""The port's torch files → the JAX package's msgpack files, without JAX:

    # a checkpoint in the reference's layout (the port's, or the
    # reference's) → a JAX resume checkpoint (msgpack)
    python -m situation_recognition_tpu_torch.tools.export_torch \\
        checkpoint checkpoints/sr model.msgpack [--heads 16]

    # a backbone state dict .pth (the port's ResNet or ViT) → a JAX
    # backbone msgpack ({params, batch_stats}) for --backbone_ckpt
    python -m situation_recognition_tpu_torch.tools.export_torch \\
        backbone backbone.pth backbone.msgpack [--heads 16]

The way back of ``convert_torch``, as far as ``convert``'s ``*_to_jax``
functions go: the weights (``resnet_params_to_jax`` and
``resnet_stats_to_jax`` or ``vit_params_to_jax``, ``head_params_to_jax``),
the epoch, the six histories and the dropout step count, written with
``utils/msgpack.py``.  Adamax's state is not converted (no ``*_to_jax``
counterpart of ``convert.export_adamax_state``): the JAX trainer resumes
such a checkpoint with a fresh optimizer, as its tolerant load does for a
state that does not fit.  ``--heads``: a ViT's attention heads (its q/k/v
kernels are (D, heads, dh) in JAX).
"""

from __future__ import annotations

import argparse
import json


def backbone_tree(state, heads: int) -> dict:
    """The port's backbone state dict → the JAX tree {params,
    [batch_stats]}."""
    from situation_recognition_tpu_torch import convert

    if "encoder.pos_embedding" in state:
        return {"params": convert.vit_params_to_jax(state, heads)}
    return {"params": convert.resnet_params_to_jax(state),
            "batch_stats": convert.resnet_stats_to_jax(state)}


def checkpoint_tree(ckpt, heads: int) -> dict:
    """A reference-layout checkpoint → the JAX package's checkpoint keys
    (its weights, epoch, histories and step count)."""
    from situation_recognition_tpu_torch import convert
    from situation_recognition_tpu_torch.utils.checkpoint import (
        HISTORY_KEYS, history_list)

    backbone, head = convert.from_reference(ckpt["model_state_dict"])
    bb = backbone_tree(backbone, heads)
    out = {"epoch": int(ckpt.get("epoch", 0)),
           **{k: [float(x) for x in history_list(ckpt.get(k, []))]
              for k in HISTORY_KEYS},
           "head_params": convert.head_params_to_jax(head),
           "backbone_params": bb["params"],
           "backbone_stats": bb.get("batch_stats", {})}
    if ckpt.get("step_count") is not None:
        out["step_count"] = int(ckpt["step_count"])
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("mode", choices=["checkpoint", "backbone"])
    ap.add_argument("src", help="torch .pth file")
    ap.add_argument("dst", help="output msgpack path")
    ap.add_argument("--heads", type=int, default=16,
                    help="a ViT's attention heads (16 for ViT-L, 12 for "
                         "ViT-B; ignored for ResNets)")
    args = ap.parse_args(argv)

    from situation_recognition_tpu_torch.utils import msgpack
    from situation_recognition_tpu_torch.utils.checkpoint import (
        load_checkpoint)

    src = load_checkpoint(args.src)
    tree = (checkpoint_tree(src, args.heads) if args.mode == "checkpoint"
            else backbone_tree(src, args.heads))
    msgpack.write(args.dst, tree)
    print(json.dumps({"mode": args.mode, "src": args.src,
                      "dst": args.dst}))


if __name__ == "__main__":
    main()
