"""The explicit data-parallel train step: the twin of the reference's
``nn.DataParallel`` (JAX ``parallel/spmd.py``, ``make_shardmap_train_step``).

The trainer's own step on a mesh (``train.py``) normalises with the global
batch's BN statistics and draws the global batch's dropout masks, as JAX's
jit step does.  This step keeps what JAX's ``shard_map`` step spells out:

* BatchNorm normalises with each rank's own batch statistics (per-GPU BN
  under DataParallel); the running statistics are then averaged over the
  ranks (JAX's ``pmean``), so they stay equal on every rank;
* each masked mean is this rank's numerator over the all-reduced
  denominator (JAX's ``psum`` of numerator and denominator apart), so the
  wrap-padding rows are excluded globally;
* each rank's dropout streams are folded with its rank (independent GPU
  generators);
* the gradients are summed over the ranks, then every rank applies the same
  clip and Adamax update.

Data-parallel only: ``model_axis`` > 1 raises, as JAX's does.
"""

from __future__ import annotations

import contextlib

import torch

from situation_recognition_tpu_torch.models.resnet import (
    BatchNorm, set_stats_group)
from situation_recognition_tpu_torch.parallel import distributed


@contextlib.contextmanager
def _per_rank(trainer):
    """The trainer's BN on each rank's own batch and its dropout on each
    rank's own streams, inside."""
    group = trainer._data_group
    rows = trainer.head.dropout_rows
    set_stats_group(trainer.backbone, None)
    trainer.head.dropout_rows = None
    trainer._dropout_fold = 0 if group is None else distributed.group_rank(
        group)
    try:
        yield
    finally:
        set_stats_group(trainer.backbone, group)
        trainer.head.dropout_rows = rows
        trainer._dropout_fold = None


def _pmean_running_stats(trainer) -> None:
    """Every BN's running mean and variance averaged over the data axis,
    in one all-reduce."""
    group = trainer._data_group
    bufs = [b for m in trainer.backbone.modules() if isinstance(m, BatchNorm)
            for b in (m.running_mean, m.running_var)]
    if group is None or not bufs:
        return
    flat = torch.cat([b.reshape(-1) for b in bufs])
    distributed.all_reduce(flat, group, "stats")
    flat /= distributed.group_size(group)
    torch._foreach_copy_(bufs, [f.view_as(b) for f, b in zip(
        torch.split(flat, [b.numel() for b in bufs]), bufs)])


def make_spmd_train_step(trainer):
    """→ ``step(images, flip, verbs, labels, valid)``: one optimizer step
    of this rank's batch rows as described above, returning what
    ``Trainer.train_step`` returns (the global losses and the gathered
    top-k)."""
    if trainer.config.model_axis != 1:
        raise NotImplementedError(
            "the explicit step is data-parallel only; classifier tensor "
            "parallelism (model_axis > 1) is served by the trainer's step")

    def step(images, flip, verbs, labels, valid):
        with _per_rank(trainer):
            out = trainer.accum_step(images, flip, verbs, labels, valid,
                                     first=True)
        _pmean_running_stats(trainer)
        trainer.apply_step(1)
        return out

    return step
