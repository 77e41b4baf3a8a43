"""Checkpoints in the reference's ``torch.save`` layout.

Port of ``situation_recognition_tpu/utils/checkpoint.py``.  The file is
the dict the reference writes every epoch (its ``sr.py``): ``epoch``, the
six history lists (``HISTORY_KEYS``), ``model_state_dict`` with the
reference's key names and registration order (``role_emb``, ``verb_emb``,
``convnet_verbs.model.*``, ``convnet_nouns.model.*``, ``ggsnn.*``,
``{verb,nouns}_classifier.1.*``) and ``optimizer_state_dict`` in
``torch.optim.Adamax`` layout, indexed in the reference's order
(``Trainer.model_state_dict`` builds both).  So a reference checkpoint
resumes here with its Adamax state, and this package's checkpoint resumes
in the reference and in the JAX package's CLI, which read torch files.

Keys the reference lacks ride beside those as extra top-level keys:
``step_count`` and ``opt_steps`` (the dropout stream and the learning-rate
schedule continue across a resume) and ``mid``, the accumulators of a
mid-epoch snapshot.

Files are written atomically and durably: a temporary file, flushed and
``fsync``-ed, then ``os.replace``.  Loading uses ``weights_only=True``: a
checkpoint holds tensors, numbers, strings and containers only.
"""

from __future__ import annotations

import os
import shutil
from collections import OrderedDict
from typing import Any, Dict, Mapping

import torch

HISTORY_KEYS = ("avg_scores", "verb_losses", "nouns_losses",
                "val_avg_scores", "val_verb_losses", "val_nouns_losses")


def _durable_replace(tmp: str, path: str, f) -> None:
    f.flush()
    # the rename alone is atomic for readers but not for a crash: without
    # the fsync a power loss can commit the rename before the data, and the
    # previous checkpoint at the same path would be gone too
    os.fsync(f.fileno())
    f.close()
    os.replace(tmp, path)


def save_checkpoint(path: str, state: Dict[str, Any]) -> None:
    """``torch.save`` of host-side ``state`` to ``path``, atomically."""
    tmp = f"{path}.{os.getpid()}.tmp"
    f = open(tmp, "wb")
    try:
        torch.save(state, f)
        _durable_replace(tmp, path, f)
    finally:
        f.close()


def copy_checkpoint(src: str, dst: str) -> None:
    """Copy a written checkpoint to ``dst`` as durably as ``save``."""
    tmp = f"{dst}.{os.getpid()}.tmp"
    f = open(tmp, "wb")
    try:
        with open(src, "rb") as s:
            shutil.copyfileobj(s, f, 16 << 20)
        _durable_replace(tmp, dst, f)
    finally:
        f.close()


def history_list(x) -> list:
    """A history as a list of floats (a JAX-written file may hold an
    index dict {'0': v0, '1': v1, ...})."""
    if isinstance(x, Mapping):
        return [float(x[k]) for k in sorted(x, key=int)]
    return [float(v) for v in x]


def load_checkpoint(path: str) -> Dict[str, Any]:
    """A checkpoint file → its dict, on the CPU, with the histories as
    float lists and the mid-epoch counters as ints."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    for k in HISTORY_KEYS:
        if k in state:
            state[k] = history_list(state[k])
    mid = state.get("mid")
    if isinstance(mid, dict):
        if "loss_sums" in mid:
            mid["loss_sums"] = history_list(mid["loss_sums"])
        for k in ("batch_in_epoch", "step_count", "num_batches"):
            if k in mid:
                mid[k] = int(mid[k])
    return state


def restore_tolerant(target: Mapping[str, torch.Tensor],
                     state: Mapping[str, Any],
                     prefix: str = "") -> "OrderedDict[str, torch.Tensor]":
    """Name-matched copy in the reference's ``utils.load_net`` manner:
    the entries of ``state`` whose shape matches replace ``target``'s
    (cast to its type); a key ``state`` lacks prints ``[Missed]: <key>
    <shape>`` and a shape that differs ``[Mismatch]: <key> <shapes>``, and
    both keep ``target``'s value.  Keys only ``state`` has are ignored."""
    out: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    state = state if isinstance(state, Mapping) else {}
    for k, t in target.items():
        path = f"{prefix}.{k}" if prefix else k
        if k not in state:
            print(f"[Missed]: {path}", tuple(t.shape))
            out[k] = t
            continue
        s = torch.as_tensor(state[k])
        if tuple(s.shape) != tuple(t.shape):
            print(f"[Mismatch]: {path} {tuple(t.shape)} vs "
                  f"{tuple(s.shape)}")
            out[k] = t
            continue
        out[k] = s.to(t.dtype) if s.dtype != t.dtype else s
    return out
