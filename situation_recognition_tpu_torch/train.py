"""Training and evaluation of ResNet or ViT + FCGGNN on one device, or on
one card per process of a ``torch.distributed`` world.

Port of ``situation_recognition_tpu/train.py``: ``TrainerConfig`` (the
fields this package uses), ``make_lr_fn``, and ``Trainer`` with its train
and eval steps (``train.py:697-738``), the pipelined ``train_epoch`` and
``evaluate``, checkpoint state (``model_state_dict``,
``model_state_snapshot``, ``load_model_state``) and the reference's epoch
loop ``fit`` with mid-epoch snapshots, SIGTERM preemption, ``keep_best``,
``metrics_jsonl`` and background saves (``AsyncSaver``).

A train step does what the JAX step does:

1. features from the backbone, with train-mode BatchNorm (flax's,
   ``models/resnet.BatchNorm``) updating the running statistics once per
   step (a ViT has no statistics; at bf16 on the card its encoder blocks
   run through the ViT kernels).  A frozen backbone runs outside autograd;
   with ``train_backbone`` (JAX ``train_step_ft``) it runs under autograd,
   so that the gradients reach every backbone parameter (BN scales and
   shifts too), and a ViT's blocks take the ft stream (K7 forward, K8
   backward; ``models/vit.py``);
2. under autograd: the verb branch, its argmax, the predicted-verb noun
   branch, and the masked verb CE plus the masked nouns CE;
3. backward;
4. the gt-verb noun branch, forward-only on the parameters before the
   update and on the features detached (its loss is logged, never
   backpropagated) — on the card its GGNN propagate is the folded kernel
   K1;
5. one global-norm-1 clip over every trainable parameter (the head, and
   the backbone under ``train_backbone``) and Adamax(lr), the rate from
   ``make_lr_fn`` at the optimizer-step count; the backbone's parameter
   group runs at that rate times ``backbone_lr / lr``, which is Adamax at
   ``backbone_lr`` exactly as JAX's post-scaled updates are
   (``_scale_subtree``);
6. top-5 indices by iterative argmax (ties to the lower index).

With ``grad_accum`` = N (JAX ``grad_accum_step`` / ``grad_accum_final_step``
and their ft pair) steps 1–4 run per microbatch (``accum_step``), the
backward summing into ``.grad``, which a group's first microbatch clears;
the group's last takes step 5 on the mean (``apply_step``).  BN statistics
and the dropout streams' step count advance per microbatch, the rate per
optimizer step.  ``infer_verb`` / ``infer_nouns`` are the single-image
inference of JAX ``train.py:943-980`` (eval-mode BN, no flip).

Differentiated GGNN propagates take autograd over the masked-sum math, or
with ``SRTPU_GGNN_BWD=pallas`` the K2/K3 autograd Function
(``models/fcggnn.GGNN``).  Dropout draws from ``torch.Generator``s seeded
from ``config.seed`` and the step count, one stream for the
differentiated branches and another for the gt branch.  The eval step runs
all three branches forward-only (K1 on the card) with eval-mode BN.

The trainer takes any iterable of batch dicts ``{"images": uint8 (B, 256,
256, 3), "flip": bool (B,), "verbs": (B,), "labels": (B, 3, R)}`` of at
most ``batch_size`` rows (``data/dataset.ImsituLoader`` yields them, or
``indices`` into a window cache in place of ``images``); shorter batches
are wrapped to ``batch_size`` (``_pad_batch``), so their pad rows enter
the BN statistics, as in JAX, and are masked out of the losses and scores.

Batches reach the device through an uploader thread (``_device_batches``):
on the card it stages each padded batch into pinned host buffers from a
small reused pool, issues the copies with ``non_blocking=True`` on a side
stream and records an event that the step's stream waits on, so the copy
overlaps the steps in flight; ``SRTPU_UPLOAD_DEPTH`` (default 2) batches
wait ready.  A window-cached split (``--cache_device``) is uploaded once,
in chunks of ``SRTPU_HBM_CHUNK_BYTES`` (default 256 MB), and each batch is
a gather on the device.  The step loop keeps up to
``SRTPU_PIPELINE_DEPTH`` (default 2; 0 is synchronous) steps in flight
before it reads their losses and top-k back and scores them, so the host
scores step k while the card runs step k+1.

``train_epoch`` and its uploader record spans (``utils/trace.py``) while a
``torch.profiler`` session records in the process, or inside
``trace.recording()``, and are silent otherwise: ``train.step`` (one
iteration of the loop) over ``train.fwd_bwd`` (``accum_step``),
``train.apply`` (``apply_step``), ``train.readback`` (the losses read back:
the wait on the card), ``train.fetch`` (the top-k read back) and
``train.score``; ``train.batch_wait`` (the loop waiting on the uploader
and taking the batch over);
on the uploader thread ``upload.next`` (the loader), ``upload.stage``
(with its ``upload.slot_wait`` on a pinned slot) and ``upload.put_wait``
(the queue full).  Each carries its batch's index in the epoch.
``SRTPU_STEP_TRACE=1`` records the first 16 consumed train steps and
prints their ``train.readback`` and ``train.fetch`` (the JAX package's
``[trace]`` lines).  ``SRTPU_PROFILE_DIR`` puts a ``torch.profiler`` trace
of ``fit``'s first epoch of training into that directory, the spans with
it (``utils/logging.profile_trace``).  The JAX package's switches, read
where it reads them, with its defaults.

A frozen backbone's convolutions are cast to the compute type in place on
the card; the f32 parameters they came from are kept on the host (taken
at construction and at every load) and are what a checkpoint writes, as
the JAX trainer writes its f32 ``backbone_params``.

``Trainer(..., mesh=make_mesh(model=M))`` (JAX ``Trainer(mesh=...)``) runs
the same steps on each rank of a world (``parallel/``): ``batch_size`` is
the global batch, split over the data axis, and every rank ends each step
with the same parameters, Adamax state and BN statistics.

* Batches: a sharded loader's block (``ImsituLoader(shard=...)``), or a
  whole global batch, wrapped at the global level and cut to this rank's
  rows (``_pad_batch``); the uploader thread issues no collective.
* BN: train-mode statistics over the global batch (``models/resnet.py``),
  eval mode local.
* Losses: each rank's numerator over the all-reduced denominator (a count,
  no gradient), so the ranks' backward gradients sum to the global one;
  the logged losses are all-reduced, and the top-k rows gathered
  (``distributed.fetch``) so that every rank scores the global batch.
* Dropout: every rank draws the global batch's masks from the shared
  generators and keeps its rows: a world equals one process at the global
  batch.
* Gradients: one all-reduce per optimizer step, in buckets of the flat
  gradients (``_reduce_grads``; under ``grad_accum`` the microbatches sum
  locally first, as ``no_sync``), before the mean, the clip and Adamax.
* ``model_axis`` M > 1: the classifier kernels split their input columns
  over the model group (``models/fcggnn.py``); their Adamax state follows
  the shard, the clip counts each sharded kernel once (its squared norm
  all-reduced over the model group), ``model_state_dict`` gathers the full
  kernels and ``load_model_state`` scatters them, so a checkpoint is the
  single process's key for key.
* ``fit``: only rank 0 writes checkpoints, the curve and metrics; the
  ranks agree on a preemption at every step boundary.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import queue
import signal
import sys
import threading
import time
import weakref
from collections import OrderedDict, deque
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from situation_recognition_tpu_torch.convert import from_reference
from situation_recognition_tpu_torch.data.dataset import put_until_stopped
from situation_recognition_tpu_torch.data.encoder import ImsituEncoder
from situation_recognition_tpu_torch.data.transforms import device_transform
from situation_recognition_tpu_torch.device import resolve_device
from situation_recognition_tpu_torch.metrics.scorer import (
    ImsituScorer, mean_of_eight)
from situation_recognition_tpu_torch.models.fcggnn import (
    FCGGNNHead, nouns_ce_terms, nouns_loss_masked, resolve_ggnn_impl,
    verb_ce_term, verb_loss_masked)
from situation_recognition_tpu_torch.models.backbone import build_backbone
from situation_recognition_tpu_torch.models.resnet import set_stats_group
from situation_recognition_tpu_torch.parallel import distributed
from situation_recognition_tpu_torch.parallel.mesh import (
    check_cols, head_param_sharding)
from situation_recognition_tpu_torch.utils.checkpoint import (
    HISTORY_KEYS, copy_checkpoint, history_list, restore_tolerant,
    save_checkpoint)
from situation_recognition_tpu_torch.utils import trace
from situation_recognition_tpu_torch.utils.logging import (
    StepTimer, format_dict, profile_trace)

#: the reference model's prefixes of its twin backbones
REF_BACKBONE = "convnet_verbs.model."
REF_TWIN = "convnet_nouns.model."
#: steps ``train_epoch`` and ``evaluate`` keep in flight before scoring,
#: unless ``SRTPU_PIPELINE_DEPTH`` says otherwise
PIPELINE_DEPTH = 2
#: the window cache's upload chunk, unless ``SRTPU_HBM_CHUNK_BYTES`` says
#: otherwise
HBM_CHUNK_BYTES = 256 << 20
#: consumed train steps ``SRTPU_STEP_TRACE=1`` reports
STEP_TRACE_BATCHES = 16
#: the bytes at which a gradient bucket (one all-reduce) closes
GRAD_BUCKET_BYTES = 256 << 20


def _no_span(name: str, batch: Optional[int] = None):
    """``trace.span``'s stand-in where nothing is to be recorded."""
    return trace.OFF


@dataclasses.dataclass
class TrainerConfig:
    hidden: int = 2048
    lr: float = 0.002
    batch_size: int = 6144
    num_ggnn_steps: int = 4
    dropout_rate: float = 0.5
    # resnet18|34|50|101|152 | mini | vit_l14 | vit_l14_clip | vit_b16
    # | vit_tiny
    backbone: str = "resnet152"
    # the device transform's output side; a ViT needs a multiple of its
    # patch, and its position embedding is sized for it
    image_size: int = 224
    compute_dtype: torch.dtype = torch.bfloat16
    seed: int = 0
    ggnn_impl: str = "auto"              # auto | kernel | masked
    # schedule over optimizer steps: constant (the reference's) | cosine
    # | linear, with an optional linear warmup
    lr_schedule: str = "constant"
    warmup_steps: int = 0
    total_steps: Optional[int] = None
    min_lr: float = 0.0
    # fine-tune the backbone with the head (JAX ``train_backbone``); its
    # own rate (default ``lr``), and per-block checkpointing of its
    # backward (only with train_backbone)
    train_backbone: bool = False
    backbone_lr: Optional[float] = None
    remat_backbone: bool = False
    # epochs of ``fit``
    epochs: int = 1000
    # BN mode of the backbone in train steps: "train" (batch statistics,
    # running statistics updated — the reference's) or "eval" (running
    # statistics only; JAX ``frozen_backbone_bn``)
    frozen_backbone_bn: str = "train"
    # gradient accumulation (JAX ``grad_accum``): each optimizer step takes
    # the mean of the gradients of ``grad_accum`` microbatches of
    # ``batch_size`` rows — the big batch's gradient when the microbatches
    # are balanced; train-mode BN takes each microbatch's statistics and
    # updates its running ones once per microbatch (DIVERGENCES #17)
    grad_accum: int = 1
    # the mesh's model axis: the classifier kernels split their input
    # columns over it (needs a mesh of that model size)
    model_axis: int = 1
    # recompute each GGNN step of a differentiated propagate in the
    # backward (JAX ``ggnn_remat``; ``models/fcggnn.GGNN``): the masked
    # math with each step checkpointed, never K2/K3
    ggnn_remat: bool = False


def make_lr_fn(config: TrainerConfig):
    """Optimizer-step → learning rate, or ``None`` for the constant
    ``lr`` (the reference's).  Warmup step c < warmup runs at
    ``lr*(c+1)/warmup``; cosine/linear decay ``lr → min_lr`` over
    ``t = (c-warmup)/(total_steps-warmup)`` clamped to [0, 1]."""
    sched, lr = config.lr_schedule, float(config.lr)
    if sched not in ("constant", "cosine", "linear"):
        raise ValueError(
            f"lr_schedule must be constant|cosine|linear, got {sched!r}")
    warm = int(config.warmup_steps)
    if warm < 0:
        raise ValueError(f"warmup_steps must be >= 0, got {warm}")
    lo = float(config.min_lr)
    if lo < 0 or lo > lr:
        raise ValueError(f"min_lr must be in [0, lr={lr}], got {lo}")
    if sched == "constant":
        if config.total_steps is not None:
            raise ValueError(
                "total_steps is the cosine/linear decay horizon; it has "
                "no meaning with lr_schedule='constant'")
        if warm == 0:
            return None
        horizon = 1
    else:
        if config.total_steps is None:
            raise ValueError(
                f"lr_schedule={sched!r} needs total_steps (the decay "
                "horizon in optimizer steps)")
        horizon = int(config.total_steps) - warm
        if horizon <= 0:
            raise ValueError(
                f"total_steps ({config.total_steps}) must exceed "
                f"warmup_steps ({warm})")

    def fn(count: int) -> float:
        c = float(count)
        if warm and c < warm:
            return lr * (c + 1.0) / warm
        if sched == "constant":
            return lr
        t = min(max((c - warm) / horizon, 0.0), 1.0)
        frac = (0.5 * (1.0 + math.cos(math.pi * t)) if sched == "cosine"
                else 1.0 - t)
        return lo + (lr - lo) * frac

    return fn


def _topk5(x: torch.Tensor) -> torch.Tensor:
    """Top-5 indices along the last axis by iterative argmax, ties to the
    lower index (``torch.argmax`` returns the first maximum)."""
    x = x.clone()
    idxs = []
    for _ in range(5):
        i = torch.argmax(x, dim=-1)
        idxs.append(i)
        x.scatter_(-1, i[..., None], -torch.inf)
    return torch.stack(idxs, dim=-1)


def _host_f32(t: torch.Tensor) -> torch.Tensor:
    """A contiguous f32 copy of ``t`` on the host."""
    return t.detach().to("cpu", torch.float32, copy=True,
                         memory_format=torch.contiguous_format)


def _host_copy(state):
    """``state`` (nested dicts, lists and tuples) with every CUDA tensor
    copied to pinned host memory: non-blocking copies on a side stream
    that first waits for the work queued so far, then one synchronise."""
    found = []

    def find(x):
        if torch.is_tensor(x):
            if x.is_cuda and not found:
                found.append(x.device)
        elif isinstance(x, dict):
            for v in x.values():
                find(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                find(v)

    def copy(x):
        if torch.is_tensor(x):
            if not x.is_cuda:
                return x
            out = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            return out.copy_(x, non_blocking=True)
        if isinstance(x, dict):
            return type(x)((k, copy(v)) for k, v in x.items())
        if isinstance(x, list):
            return [copy(v) for v in x]
        if isinstance(x, tuple):
            return tuple(copy(v) for v in x)
        return x

    find(state)
    if not found:
        return state
    dev = found[0]
    torch.cuda.set_device(dev)
    stream = torch.cuda.Stream(dev)
    stream.wait_stream(torch.cuda.default_stream(dev))
    with torch.cuda.stream(stream):
        out = copy(state)
    stream.synchronize()
    return out


class AsyncSaver:
    """Checkpoint writer with at most one write in flight: each save (and
    ``join``) waits for the previous one and raises its error.

    ``state`` may hold device tensors (``Trainer.model_state_snapshot``:
    private copies the loop never touches again); the writer copies them
    to the host (``_host_copy``) and then serialises, on a thread of this
    process — a process holding a CUDA context must not fork.  Writes are
    atomic and fsync-ed (``utils/checkpoint.save_checkpoint``), and the
    ``copy_to`` copy too."""

    def __init__(self):
        self._thread = None
        self._error = None

    def save(self, path: str, state: dict, background: bool = True,
             copy_to: Optional[str] = None) -> None:
        self.join()

        def write():
            save_checkpoint(path, _host_copy(state))
            if copy_to:
                copy_checkpoint(path, copy_to)

        if not background:
            write()
            return

        def run():
            try:
                write()
            except BaseException as e:           # raised by the next join
                self._error = e

        # not a daemon: the interpreter's exit waits for the write
        self._thread = threading.Thread(target=run,
                                        name="srtorch-ckpt-writer")
        self._thread.start()

    def join(self) -> None:
        """Wait for the write in flight; raise its error (a dropped
        checkpoint must not pass for a written one)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            e, self._error = self._error, None
            raise e


class _RankSaver:
    """``AsyncSaver`` of rank 0 of a world (or of a lone process): the
    other ranks write nothing, and build a checkpoint's state only where
    that is a collective (split classifiers).  ``state`` is a function
    that builds it."""

    def __init__(self, trainer):
        self.write = distributed.is_main_process()
        self._gather = bool(trainer._sharded)
        self._saver = AsyncSaver()

    def save(self, path: str, state, background: bool = True,
             copy_to: Optional[str] = None) -> None:
        if self.write or self._gather:
            state = state()
        if self.write:
            self._saver.save(path, state, background, copy_to)

    def join(self) -> None:
        self._saver.join()


class Preempted(Exception):
    """Raised out of the loop on a preemption stop (``fit(handle_sigterm=
    True)`` sets the event from SIGTERM).  ``saved``: whether a resumable
    snapshot was written before the raise."""

    def __init__(self, epoch: int, batch_in_epoch: int,
                 saved: bool = False):
        super().__init__(f"preempted at epoch {epoch}, "
                         f"batch {batch_in_epoch}")
        self.epoch = epoch
        self.batch_in_epoch = batch_in_epoch
        self.saved = saved


class _PinnedSlot:
    """One batch's pinned host buffers, reused across batches and calls
    (pinning memory is slow and can stall the device's queue); ``event``
    marks the end of the copies last issued from them."""

    def __init__(self):
        self.buffers: Dict[str, torch.Tensor] = {}
        self.event = None

    def buffer(self, key: str, like: torch.Tensor) -> torch.Tensor:
        """The pinned buffer ``key`` of ``like``'s shape and type."""
        buf = self.buffers.get(key)
        if buf is None or buf.shape != like.shape or buf.dtype != like.dtype:
            buf = torch.empty(like.shape, dtype=like.dtype, pin_memory=True)
            self.buffers[key] = buf
        return buf


def pipeline_depth() -> int:
    """``SRTPU_PIPELINE_DEPTH`` (JAX ``train.py:1274``): the steps in
    flight before the oldest is read back; 0 reads each step at once."""
    return max(0, int(os.environ.get("SRTPU_PIPELINE_DEPTH",
                                     PIPELINE_DEPTH)))


def chunk_rows(row_bytes: int) -> int:
    """Rows of ``row_bytes`` a window-cache upload chunk holds:
    ``SRTPU_HBM_CHUNK_BYTES`` (JAX ``train.py:1032``) over a row, at least
    one."""
    chunk = int(os.environ.get("SRTPU_HBM_CHUNK_BYTES", HBM_CHUNK_BYTES))
    return max(1, chunk // max(1, row_bytes))


def upload_windows(host: np.ndarray, device: torch.device) -> torch.Tensor:
    """(N, S, S, 3) uint8 windows → a tensor on ``device``, copied in
    chunks of ``chunk_rows`` through one staging buffer (pinned on the
    card, each chunk landed before the buffer is refilled), so that a
    multi-GB split never stages whole."""
    dev = torch.empty(host.shape, dtype=torch.uint8, device=device)
    rows = chunk_rows(host[0].nbytes) if len(host) else 1
    cuda = device.type == "cuda"
    staging = torch.empty((min(rows, len(host)),) + host.shape[1:],
                          dtype=torch.uint8, pin_memory=cuda)
    for start in range(0, len(host), rows):
        part = host[start:start + rows]
        staging[:len(part)].numpy()[...] = part
        dev[start:start + len(part)].copy_(staging[:len(part)],
                                           non_blocking=cuda)
        if cuda:
            torch.cuda.current_stream(device).synchronize()
    return dev


def _upload_depth() -> int:
    """Batches the uploader keeps ready: ``SRTPU_UPLOAD_DEPTH`` (2)."""
    return max(1, int(os.environ.get("SRTPU_UPLOAD_DEPTH", "2")))


#: device dtypes of a padded batch's arrays
_BATCH_DTYPES = {"images": torch.uint8, "flip": torch.bool,
                 "verbs": torch.long, "labels": torch.long,
                 "valid": torch.float32, "indices": torch.long}
_plot_warned = False


class Trainer:
    """Owns the backbone, the head, the optimizer and the steps.

    ``device``: default cuda (raises without a card), ``"cpu"`` by name.
    ``backbone_state`` / ``head_state``: state dicts in the reference
    layout (``convert.py``); without them the weights are random from
    ``config.seed``.  ``mesh``: this rank's place in a world
    (``parallel/mesh.make_mesh``; see the module docstring)."""

    def __init__(self, encoder: ImsituEncoder, config: TrainerConfig,
                 device=None, backbone_state: Optional[dict] = None,
                 head_state: Optional[dict] = None, mesh=None):
        self.encoder = encoder
        self.config = config
        self.device = resolve_device(device)
        self.mesh = mesh
        model = 1 if mesh is None else mesh.model
        if config.model_axis != model:
            raise ValueError(f"model_axis {config.model_axis} needs a mesh "
                             f"of that model size (this one's is {model})")
        # both classifiers' contraction dim (hidden) splits over model
        check_cols(config.hidden, model)
        ndata = 1 if mesh is None else mesh.data
        if config.batch_size % ndata != 0:
            raise ValueError(f"batch_size {config.batch_size} not divisible "
                             f"by data axis {ndata}")
        #: the data axis's group (None: no collective) and this rank's rows
        self._data_group = None if mesh is None else mesh.data_group
        self._rows = slice(None) if ndata == 1 \
            else mesh.rows(config.batch_size)
        #: the generators' rank fold (``parallel/spmd.py``)
        self._dropout_fold = None
        dt = config.compute_dtype
        gen = torch.Generator().manual_seed(config.seed)
        if config.image_size < 32:
            raise ValueError(f"image_size must be >= 32, got "
                             f"{config.image_size}")
        if config.frozen_backbone_bn not in ("train", "eval"):
            raise ValueError(f"frozen_backbone_bn must be train|eval, got "
                             f"{config.frozen_backbone_bn!r}")
        self._ft = bool(config.train_backbone)
        self.backbone, has_bn = build_backbone(
            config.backbone, config.hidden, config.image_size, dt,
            remat=config.remat_backbone and self._ft)
        self._has_bn = has_bn
        if backbone_state is None:
            self.backbone.reset_parameters(gen)
        else:
            self.backbone.load_state_dict(backbone_state, strict=True)
        # a frozen backbone's f32 parameters, before any cast (the source
        # of every checkpoint); a fine-tuned one keeps f32 masters live
        self._bb_host = None if self._ft else {
            n: _host_f32(p) for n, p in self.backbone.named_parameters()}
        self.head = FCGGNNHead(
            encoder.get_num_verbs(), encoder.get_num_roles(),
            encoder.get_num_labels(), encoder.max_role_count,
            hidden=config.hidden, num_steps=config.num_ggnn_steps,
            dropout_rate=config.dropout_rate, dtype=dt,
            ggnn_impl=resolve_ggnn_impl(config.ggnn_impl, dt, self.device),
            ggnn_remat=config.ggnn_remat)
        if head_state is None:
            self.head.reset_parameters(gen)
        else:
            self.head.load_state_dict(head_state, strict=True)
        if has_bn and self._data_group is not None:
            set_stats_group(self.backbone, self._data_group)
        if ndata > 1:
            self.head.dropout_rows = (self._rows.start, config.batch_size)
        #: the split classifier kernels (name → column slice)
        self._sharded = {}
        if model > 1:
            cols = mesh.cols(config.hidden)
            specs = head_param_sharding(mesh, self.head.state_dict())
            for name, p in self.head.named_parameters():
                if specs[name]:
                    mod = self.head.get_submodule(name.rsplit(".", 1)[0])
                    mod.weight = nn.Parameter(p.detach()[:, cols].clone())
                    self._sharded[name] = cols
            self.head.tp = (mesh.model_group, cols)
        self.backbone.to(self.device)
        if has_bn:
            # the ResNet's BatchNorm parameters and statistics in f32;
            # frozen, its convolutions are cast to the compute type once
            # (flax casts its f32 kernels at each use, which for a frozen
            # backbone is the same thing), fine-tuned they keep f32 master
            # weights and are cast at each use.  Channels-last on the card
            # (cuDNN's layout); the CPU keeps NCHW (models/resnet.py)
            if not self._ft:
                for m in self.backbone.modules():
                    if isinstance(m, nn.Conv2d):
                        m.to(dtype=dt)
            if self.device.type == "cuda":
                self.backbone.to(memory_format=torch.channels_last)
        self.backbone.requires_grad_(self._ft)
        self.head.to(self.device)
        self.role_ids = torch.as_tensor(encoder.role_ids, dtype=torch.long,
                                        device=self.device)
        self.role_mask = torch.as_tensor(encoder.role_mask,
                                         device=self.device)
        # the reference's optimizer: clip_grad_norm_(1.0), then Adamax;
        # fine-tuning adds the backbone as a group at backbone_lr/lr times
        # the rate
        self._lr_fn = make_lr_fn(config)
        groups = [{"params": list(self.head.parameters()), "lr_ratio": 1.0}]
        if self._ft:
            ratio = 1.0
            if config.backbone_lr is not None \
                    and config.backbone_lr != config.lr:
                if config.lr == 0:
                    raise ValueError(
                        "backbone_lr needs lr != 0 (the backbone rate is "
                        "backbone_lr/lr times the schedule's)")
                ratio = config.backbone_lr / config.lr
            groups.append({"params": list(self.backbone.parameters()),
                           "lr_ratio": ratio})
        self._trainable = [p for g in groups for p in g["params"]]
        self.optimizer = torch.optim.Adamax(groups, lr=config.lr)
        self.opt_steps = 0
        self._set_lr()
        self.step_count = 0
        self._window_caches: dict = {}
        self._current_epoch = 0
        # the uploader's pinned buffers, kept for the next call
        self._pinned: list = []
        self._pinned_lock = threading.Lock()

    def current_lr(self) -> float:
        """The rate the next optimizer step takes: ``lr``, or the schedule
        at the optimizer-step count (the backbone's group takes it times
        ``backbone_lr / lr``)."""
        if self._lr_fn is None:
            return float(self.config.lr)
        return float(self._lr_fn(self.opt_steps))

    def _set_lr(self) -> None:
        lr = self.current_lr()
        for group in self.optimizer.param_groups:
            group["lr"] = lr * group["lr_ratio"]

    # ------------------------------------------------------------- stepping

    def _generator(self, stream: int) -> torch.Generator:
        """Dropout stream ``stream`` of the current step (folded with the
        rank under ``parallel/spmd.py``)."""
        g = torch.Generator(device=self.device)
        seed = (self.config.seed * 1_000_003 + self.step_count) * 2 + stream
        if self._dropout_fold is not None:
            seed = seed * 65_537 + self._dropout_fold
        g.manual_seed(seed)
        return g

    def _features(self, images: torch.Tensor, flip, train: bool,
                  grad: bool = False):
        """Device transform + backbone → features (B, D) f32, under
        autograd with ``grad`` (fine-tuning) and without a gradient
        otherwise; in train mode BN uses batch statistics and updates its
        running ones."""
        x = device_transform(images, flip if train else None,
                             dtype=self.config.compute_dtype,
                             crop=self.config.image_size)
        # frozen_backbone_bn is a BN-mode switch only: a backbone without
        # BN keeps its true train flag
        self.backbone.train(train and (
            not self._has_bn or self.config.frozen_backbone_bn != "eval"))
        with torch.set_grad_enabled(grad):
            return self.backbone(x).float()

    def _denominators(self, labels, valid):
        """The masked means' denominators over the data axis: (4,) f32,
        the valid rows and each annotation's valid (row, role) positions
        (counts only: no gradient); None without a data group."""
        if self._data_group is None:
            return None
        ok = (labels != self.encoder.get_num_labels()) \
            & valid.bool()[:, None, None]
        den = torch.cat([valid.float().sum()[None],
                         ok.sum(dim=(0, 2)).float()])
        return distributed.all_reduce(den, self._data_group, "den")

    def _verb_loss(self, pred_verb, verbs, valid, den):
        if den is None:
            return verb_loss_masked(pred_verb, verbs, valid)
        return verb_ce_term(pred_verb, verbs, valid)[0] / den[0]

    def _nouns_loss(self, pred_nouns, labels, valid, den):
        n_labels = self.encoder.get_num_labels()
        if den is None:
            return nouns_loss_masked(pred_nouns, labels, n_labels, valid)
        terms = nouns_ce_terms(pred_nouns, labels, n_labels,
                               valid[:, None].bool())
        return sum(num / torch.clamp_min(den[1 + i], 1.0)
                   for i, (num, _) in enumerate(terms))

    def _global(self, losses, topk):
        """This rank's shares of the losses and its top-k rows → the global
        batch's (sums over the data axis; rows gathered in rank order)."""
        if self._data_group is None:
            return losses, topk
        distributed.all_reduce(losses, self._data_group, "loss")
        b = topk[0].shape[0]
        flat = distributed.fetch(torch.cat([t.reshape(b, -1) for t in topk],
                                            dim=1), self._data_group)
        widths = [t[0].numel() for t in topk]
        parts = torch.split(flat, widths, dim=1)
        return losses, tuple(p.reshape((-1,) + t.shape[1:])
                             for p, t in zip(parts, topk))

    def _losses(self, outs, verbs, labels, valid):
        pred_verb, pred_nouns, gt_pred_nouns = outs
        den = self._denominators(labels, valid)
        return torch.stack([
            self._verb_loss(pred_verb, verbs, valid, den),
            self._nouns_loss(pred_nouns, labels, valid, den),
            self._nouns_loss(gt_pred_nouns, labels, valid, den)])

    @staticmethod
    def _topk(outs):
        pred_verb, pred_nouns, gt_pred_nouns = outs
        gt1 = torch.argmax(gt_pred_nouns, dim=-1)[..., None]
        return _topk5(pred_verb), _topk5(pred_nouns), gt1

    def train_step(self, images, flip, verbs, labels, valid):
        """One optimizer step on a device batch → (losses (3,) f32:
        verb, nouns, gt nouns; top-k (pred_verb top-5, pred_nouns top-5,
        gt_nouns top-1)).  With ``train_backbone`` the backbone is in the
        backward, the clip and the update."""
        out = self.accum_step(images, flip, verbs, labels, valid, first=True)
        self.apply_step(1)
        return out

    def accum_step(self, images, flip, verbs, labels, valid,
                   first: bool):
        """A train step up to the optimizer (JAX ``grad_accum_step``):
        the backward sums this batch's gradients into ``.grad``, which
        ``first`` (a group's first microbatch) clears beforehand; BN
        updates its running statistics.  Returns what ``train_step``
        returns.  Span ``train.fwd_bwd``."""
        with trace.span("train.fwd_bwd"):
            feats = self._features(images, flip, True, grad=self._ft)
            head = self.head
            if first:
                self.optimizer.zero_grad(set_to_none=True)
            den = self._denominators(labels, valid)
            pred_verb, pred_nouns = head.predict_train(
                feats, self.role_ids, self.role_mask, train=True,
                generator=self._generator(0))
            vloss = self._verb_loss(pred_verb, verbs, valid, den)
            nloss = self._nouns_loss(pred_nouns, labels, valid, den)
            (vloss + nloss).backward()
            with torch.no_grad():
                gt_pred_nouns = head.predict_nouns(
                    feats.detach(), verbs, self.role_ids, self.role_mask,
                    train=True, generator=self._generator(1))
                gloss = self._nouns_loss(gt_pred_nouns, labels, valid, den)
            losses = torch.stack([vloss.detach(), nloss.detach(), gloss])
            return self._global(losses, self._topk(
                (pred_verb.detach(), pred_nouns.detach(), gt_pred_nouns)))

    def apply_step(self, count: int) -> None:
        """The optimizer step on the gradients that ``count`` microbatches
        summed into ``.grad`` (JAX ``grad_accum_final_step`` /
        ``apply_accum_step``): their mean, one global-norm-1 clip over
        every trainable parameter, the rate of this optimizer step and
        Adamax; the schedule's count ticks once.  No host sync.  Span
        ``train.apply``."""
        with trace.span("train.apply"):
            self._reduce_grads()
            if count > 1:
                grads = [p.grad for p in self._trainable
                         if p.grad is not None]
                torch._foreach_div_(grads, float(count))
            self._clip()
            self._set_lr()
            self.optimizer.step()
            self.opt_steps += 1

    def _reduce_grads(self) -> None:
        """Sum ``.grad`` over the data axis: the flat gradients in buckets,
        each closed at the tensor that brings it to ``GRAD_BUCKET_BYTES``
        (or a change of type), one all-reduce each."""
        if self._data_group is None:
            return
        grads = [p.grad for p in self._trainable if p.grad is not None]
        bucket, size = [], 0
        for i, g in enumerate(grads):
            bucket.append(g)
            size += g.numel() * g.element_size()
            last = i + 1 == len(grads)
            if size >= GRAD_BUCKET_BYTES or last or \
                    grads[i + 1].dtype != g.dtype:
                flat = torch.cat([t.reshape(-1) for t in bucket])
                distributed.all_reduce(flat, self._data_group, "grad")
                torch._foreach_copy_(bucket, [
                    f.view_as(t) for f, t in zip(
                        torch.split(flat, [t.numel() for t in bucket]),
                        bucket)])
                bucket, size = [], 0

    def _clip(self) -> None:
        """One global-norm-1 clip over every trainable parameter
        (``clip_grad_norm_``); with split classifiers, their squared norms
        summed over the model group, each kernel counted once."""
        if not self._sharded:
            torch.nn.utils.clip_grad_norm_(self._trainable, 1.0)
            return
        names = dict(self.head.named_parameters())
        split = {id(names[n]) for n in self._sharded}
        sq = [torch.zeros((), dtype=torch.float32, device=self.device)
              for _ in range(2)]
        for p in self._trainable:
            if p.grad is not None:
                sq[int(id(p) in split)] += p.grad.float().pow(2).sum()
        distributed.all_reduce(sq[1], self.mesh.model_group, "clip")
        coef = torch.clamp(1.0 / ((sq[0] + sq[1]).sqrt() + 1e-6), max=1.0)
        torch._foreach_mul_([p.grad for p in self._trainable
                             if p.grad is not None], coef)

    def eval_step(self, images, verbs, labels, valid):
        """All three branches forward-only with eval-mode BN → (losses,
        top-k) as ``train_step``."""
        feats = self._features(images, None, False)
        with torch.no_grad():
            outs = self.head(feats, verbs, self.role_ids, self.role_mask)
            return self._global(self._losses(outs, verbs, labels, valid),
                                self._topk(outs))

    # ------------------------------------------------------------ inference

    def _infer_features(self, images_u8) -> torch.Tensor:
        """(B, S, S, 3) uint8 windows (numpy or a tensor) → features (B,
        D) f32: the device transform without flip at ``image_size`` and
        the backbone with eval-mode BN, as ``eval_step``'s."""
        if not torch.is_tensor(images_u8):
            images_u8 = torch.tensor(np.asarray(images_u8),
                                     dtype=torch.uint8)
        return self._features(images_u8.to(self.device), None, False)

    def infer_verb(self, images_u8) -> torch.Tensor:
        """(B, S, S, 3) uint8 → verb logits (B, V) f32 on the trainer's
        device (JAX ``Trainer.infer_verb``)."""
        with torch.no_grad():
            return self.head.predict_verb(self._infer_features(images_u8))

    def infer_nouns(self, images_u8, verb_ids) -> torch.Tensor:
        """(B, S, S, 3) uint8 and verb ids (B,) → noun logits (B, R, L)
        f32 on the trainer's device (JAX ``Trainer.infer_nouns``)."""
        with torch.no_grad():
            ids = torch.as_tensor(np.asarray(verb_ids), dtype=torch.long)
            return self.head.predict_nouns(
                self._infer_features(images_u8), ids.to(self.device),
                self.role_ids, self.role_mask)

    # ------------------------------------------------------------- batching

    def _pad_batch(self, batch: Dict) -> Tuple[Dict, np.ndarray, int]:
        """Pad to config.batch_size by wrapping; returns (arrays, valid,
        n), n the global batch's real rows.  A window-cached batch carries
        ``indices`` in place of ``images``.  On a data axis: a sharded
        loader's block as it is (the loader wrapped it), or this rank's
        rows of the wrapped global batch."""
        big = self.config.batch_size
        keys = [k for k in ("images", "indices", "flip", "verbs", "labels")
                if k in batch]
        if "shard" in batch:
            return self._shard_block(batch, keys)
        n = len(batch["verbs"])
        if n > big:
            raise ValueError(
                f"loader batch of {n} exceeds config.batch_size {big}")
        if n == big:
            # a full batch passes through: the wrap-gather would copy the
            # whole uint8 image batch on the host for an identity index
            out = {k: np.asarray(batch[k])[self._rows] for k in keys}
        else:
            idx = (np.arange(big) % n)[self._rows]
            out = {k: np.asarray(batch[k])[idx] for k in keys}
        valid = (np.arange(big) < n).astype(np.float32)[self._rows]
        return out, valid, n

    def _shard_block(self, batch: Dict, keys) -> Tuple[Dict, np.ndarray,
                                                       int]:
        """A sharded loader's block (JAX ``_assemble_sharded``): its rows
        and the valid mask of this rank's rows of the global batch."""
        rank, world = batch["shard"]
        mesh = self.mesh
        ndata, index = (1, 0) if mesh is None else (mesh.data,
                                                    mesh.data_index)
        if (rank, world) != (index, ndata):
            raise ValueError(
                f"loader shard {batch['shard']} does not match this rank's "
                f"data block ({index}/{ndata}) — build the loader with "
                f"shard=(mesh.data_index, mesh.data)")
        per = self.config.batch_size // world
        out = {k: np.asarray(batch[k]) for k in keys}
        if len(out["verbs"]) != per:
            raise ValueError(f"a shard of {len(out['verbs'])} rows, want "
                             f"{per}")
        n = int(batch["global_n"])
        valid = (rank * per + np.arange(per) < n).astype(np.float32)
        return out, valid, n

    def _host_tensors(self, batch: Dict) -> Tuple[Dict, int]:
        """The padded batch (``_pad_batch``) and its ``valid`` mask as
        host tensors of the device types, and the count of real rows."""
        arrays, valid, n = self._pad_batch(batch)
        arrays["valid"] = valid
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(
            _BATCH_DTYPES[k]) for k, v in arrays.items()}, n

    def _upload(self, batch: Dict):
        """Host batch → (images, flip, verbs, labels, valid) on the device,
        and the count of real rows, synchronously on this thread."""
        host, n = self._host_tensors(batch)
        return tuple(host[k].to(self.device) for k in (
            "images", "flip", "verbs", "labels", "valid")), n

    def _device_window_cache(self, dataset) -> torch.Tensor:
        """A window-cached dataset's (N, S, S, 3) uint8 windows on the
        device, uploaded once in chunks (``upload_windows``; on the CPU
        the host array itself) and kept while the host array lives."""
        host = dataset.window_cache
        entry = self._window_caches.get(id(dataset))
        if entry is not None and entry[0]() is host:
            return entry[1]
        if self.device.type != "cuda":
            dev = torch.from_numpy(host)
        else:
            dev = upload_windows(host, self.device)
        self._window_caches[id(dataset)] = (weakref.ref(host), dev)
        return dev

    def _device_batches(self, loader, first: Optional[int] = None):
        """Iterate (device args (images, flip, verbs, labels, valid), host
        batch, n) with the next batches staged ahead by an uploader thread
        (see the module docstring).  A loader error is raised here, on the
        consumer's thread, however full the queue is.  ``first``, the
        epoch's index of the loader's first batch, turns on the spans
        (``utils/trace.py``): the uploader's ``upload.*`` and this
        thread's ``train.batch_wait``, each with its batch's index."""
        span = trace.span if first is not None else _no_span
        first = first or 0
        ds = getattr(loader, "dataset", None)
        cache = (self._device_window_cache(ds)
                 if getattr(ds, "window_cached", False) else None)
        cuda = self.device.type == "cuda"
        depth = _upload_depth()
        q: queue.Queue = queue.Queue(maxsize=depth)
        stop = threading.Event()
        end = object()
        own_pool = False
        if cuda:
            index = (self.device.index if self.device.index is not None
                     else torch.cuda.current_device())
            side = torch.cuda.Stream(index)
            # a slot for each batch queued, the one in use and the next;
            # the trainer's pool unless another call holds it
            own_pool = self._pinned_lock.acquire(blocking=False)
            pool = self._pinned if own_pool else []
            while len(pool) < depth + 2:
                pool.append(_PinnedSlot())

        def stage(batch, count):
            host, n = self._host_tensors(batch)
            if not cuda:
                if "indices" in host:
                    host["images"] = cache.index_select(
                        0, host.pop("indices"))
                return host, batch, n, None
            if count == 0:
                # every slot's buffers at once, before the first copy
                for other in pool:
                    for k, v in host.items():
                        other.buffer(k, v)
            slot = pool[count % len(pool)]
            if slot.event is not None:
                # its buffers' last copies must land before the refill
                with span("upload.slot_wait"):
                    slot.event.synchronize()
            with torch.cuda.stream(side):
                dev = {}
                for k, v in host.items():
                    dev[k] = slot.buffer(k, v).copy_(v).to(
                        self.device, non_blocking=True)
                if "indices" in dev:
                    dev["images"] = cache.index_select(0,
                                                       dev.pop("indices"))
                event = torch.cuda.Event()
                event.record(side)
            slot.event = event
            return dev, batch, n, event

        def work():
            it = iter(loader)
            try:
                if cuda:
                    torch.cuda.set_device(index)
                count = 0
                while True:
                    b = first + count
                    with span("upload.next", b):
                        batch = next(it, end)
                    if batch is end:
                        break
                    with span("upload.stage", b):
                        item = stage(batch, count)
                    with span("upload.put_wait", b):
                        if not put_until_stopped(q, item, stop):
                            return
                    count += 1
                put_until_stopped(q, end, stop)
            except BaseException as e:  # raised on the consumer's thread
                put_until_stopped(q, e, stop)
            finally:
                close = getattr(it, "close", None)
                if close is not None:
                    close()

        t = threading.Thread(target=work, name="srtorch-uploader",
                             daemon=True)
        t.start()
        try:
            got = 0
            while True:
                # the wait for the batch and its hand-over to this stream
                # (the uploader's Python may hold the interpreter then)
                with span("train.batch_wait", first + got):
                    item = q.get()
                    if item is end:
                        break
                    if isinstance(item, BaseException):
                        raise item
                    dev, batch, n, event = item
                    if event is not None:
                        cur = torch.cuda.current_stream(self.device)
                        cur.wait_event(event)
                        # made on the side stream, used on this one
                        for x in dev.values():
                            x.record_stream(cur)
                got += 1
                yield ((dev["images"], dev["flip"], dev["verbs"],
                        dev["labels"], dev["valid"]), batch, n)
        finally:
            # the consumer may leave mid-epoch (preemption): let the
            # uploader see the stop and wind its loader down
            stop.set()
            while True:
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            t.join()
            if own_pool:
                self._pinned_lock.release()

    @staticmethod
    def batches_on_device() -> int:
        """The most batches ``_device_batches`` and the step loop hold on
        the device at once: those queued, the one staging, the one in the
        step and those in flight."""
        return _upload_depth() + 2 + pipeline_depth()

    @staticmethod
    def _fetch(topk, n):
        return tuple(x.cpu().numpy()[:n] for x in topk)

    @staticmethod
    def _score(top1, top5, host_topk, verbs, labels):
        pv5, pn5, gt1 = host_topk
        top1.add_point_indices(pv5[:, :1], verbs, pn5[:, :, :1], labels, gt1)
        top5.add_point_indices(pv5, verbs, pn5, labels)

    # ------------------------------------------------------------ epoch API

    def train_epoch(self, loader, epoch: int,
                    timer: Optional[StepTimer] = None,
                    mid_state: Optional[dict] = None,
                    save_every: Optional[int] = None,
                    save_callback=None, preempt=None):
        """One pass over ``loader`` (a train step per batch, or with
        ``grad_accum`` = N a microbatch per batch and an optimizer step
        per N of them) → (top1, top5 scorers, mean (verb, nouns, gt)
        losses).  An epoch that ends inside a group steps on the
        microbatches it has (JAX ``_apply_pending``).

        ``save_every``: ``save_callback(mid)`` every N batches with a
        resumable snapshot of the epoch's accumulators; passed back as
        ``mid_state`` it continues the epoch at the next batch.
        ``preempt`` (a ``threading.Event``): once set, the loop calls
        ``save_callback`` at the next step boundary and raises
        ``Preempted``.  Under accumulation both wait for a group's end:
        a snapshot inside a group would lose its summed gradients."""
        if hasattr(loader, "set_epoch"):
            loader.set_epoch(epoch)
        top1 = ImsituScorer(self.encoder, 1, 3)
        top5 = ImsituScorer(self.encoder, 5, 3)
        sums = np.zeros(3)
        num_batches = 0
        start_batch = 0
        if mid_state is not None:
            top1.load_state_dict(mid_state["top1"])
            top5.load_state_dict(mid_state["top5"])
            sums = np.asarray(history_list(mid_state["loss_sums"]),
                              np.float64)
            num_batches = int(mid_state["num_batches"])
            start_batch = int(mid_state["batch_in_epoch"])
            self.step_count = int(mid_state["step_count"])
        if start_batch:
            loader.start_batch = start_batch
        batch_idx = start_batch
        accum = max(1, int(self.config.grad_accum))
        micros = 0
        inflight: deque = deque()
        depth = pipeline_depth()
        # SRTPU_STEP_TRACE=1: the first consumed steps' spans, recorded
        # whatever the profiler does, make the [trace] lines
        tracing = contextlib.ExitStack()
        step_trace = (os.environ.get("SRTPU_STEP_TRACE") == "1"
                      and num_batches < STEP_TRACE_BATCHES)
        if step_trace:
            tracing.enter_context(trace.recording())

        def consume_one():
            nonlocal num_batches, sums
            losses, topk, verbs, labels, n, b = inflight.popleft()
            with trace.span("train.readback", b) as read:
                sums += losses.cpu().numpy()
            with trace.span("train.fetch", b) as fetch:
                host_topk = self._fetch(topk, n)
            lap = timer.lap(n) if timer is not None else 0.0
            if step_trace and num_batches < STEP_TRACE_BATCHES:
                print(f"[trace] b{num_batches}: loss_block="
                      f"{read.seconds * 1e3:.0f}ms topk_fetch="
                      f"{fetch.seconds * 1e3:.0f}ms "
                      f"lap={lap * 1e3:.0f}ms", file=sys.stderr)
                if num_batches + 1 == STEP_TRACE_BATCHES:
                    tracing.close()
            with trace.span("train.score", b):
                self._score(top1, top5, host_topk, verbs, labels)
            num_batches += 1

        def mid():
            return {"batch_in_epoch": batch_idx,
                    "step_count": self.step_count,
                    "top1": _plain(top1.state_dict()),
                    "top5": _plain(top5.state_dict()),
                    "loss_sums": [float(x) for x in sums],
                    "num_batches": num_batches}

        with tracing:
            for args, batch, n in self._device_batches(loader, start_batch):
                with trace.span("train.step", batch_idx):
                    losses, topk = self.accum_step(*args,
                                                   first=micros == 0)
                    micros += 1
                    if micros == accum:
                        self.apply_step(accum)
                        micros = 0
                    # the sidecars are taken now: the in-flight window
                    # keeps nothing else of the host batch
                    inflight.append((losses, topk, *_sidecars(batch, n), n,
                                     batch_idx))
                    self.step_count += 1
                    batch_idx += 1
                    while len(inflight) > depth:
                        consume_one()
                    dispatched = num_batches + len(inflight)
                    want_save = bool(save_every and save_callback
                                     and dispatched % save_every == 0
                                     and micros == 0)
                    # every rank asks at every group end (the ranks agree)
                    want_stop = micros == 0 and distributed.preempt_agreed(
                        preempt, self._data_group is not None)
                    if want_save or want_stop:
                        # a snapshot's scores cover exactly batch_in_epoch
                        # batches
                        while inflight:
                            consume_one()
                        if save_callback:
                            save_callback(mid())
                        if want_stop:
                            raise Preempted(epoch, batch_idx, saved=bool(
                                save_callback
                                and distributed.is_main_process()))
            while inflight:
                consume_one()
            if micros:
                self.apply_step(micros)
        return top1, top5, tuple(sums / max(num_batches, 1))

    def evaluate(self, loader, logging: bool = False, preempt=None):
        """An eval step per batch → (top1, top5, val_losses dict,
        avg_score); ``avg_score`` (the mean of the 8 metrics x100) and the
        reference's printout only with ``logging``.  ``preempt``: stop
        between batches with ``Preempted`` (nothing here changes the
        trainer's state, so the eval can simply run again)."""
        top1 = ImsituScorer(self.encoder, 1, 3)
        top5 = ImsituScorer(self.encoder, 5, 3)
        sums = np.zeros(3)
        num_batches = 0
        images = 0
        inflight: deque = deque()
        depth = pipeline_depth()

        def consume_one():
            nonlocal num_batches, sums, images
            losses, topk, verbs, labels, n = inflight.popleft()
            sums += losses.cpu().numpy()
            self._score(top1, top5, self._fetch(topk, n), verbs, labels)
            num_batches += 1
            images += n

        t0 = time.perf_counter()
        for (imgs, _, verbs, labels, valid), batch, n in \
                self._device_batches(loader):
            losses, topk = self.eval_step(imgs, verbs, labels, valid)
            inflight.append((losses, topk, *_sidecars(batch, n), n))
            while len(inflight) > depth:
                consume_one()
            if distributed.preempt_agreed(preempt,
                                          self._data_group is not None):
                raise Preempted(-1, num_batches + len(inflight))
        while inflight:
            consume_one()
        wall = time.perf_counter() - t0
        if images and wall > 0:
            print(f"[srtorch] eval: {images} img in {wall:.1f}s "
                  f"({images / wall:.0f} img/s)", file=sys.stderr)
        sums /= max(num_batches, 1)
        val_losses = {"verb_loss": sums[0], "nouns_loss": sums[1],
                      "gt_loss": sums[2]}
        avg_score = 0.0
        if logging:
            top1_a = top1.get_average_results_both()
            top5_a = top5.get_average_results_both()
            avg_score = mean_of_eight(top1_a, top5_a)
            print('val losses = [v: {:.2f}, n: {:.2f}, gt: {:.2f}]'
                  .format(val_losses['verb_loss'], val_losses['nouns_loss'],
                          val_losses['gt_loss']))
            gt = {k: top1_a[k] for k in ['gt-value', 'gt-value-all']}
            one_val = {k: top1_a[k] for k in ['verb', 'value', 'value-all']}
            print('{}\n{}\n{}, mean = {:.2f}\n'
                  .format(format_dict(one_val, '{:.2f}', '1-'),
                          format_dict(top5_a, '{:.2f}', '5-'),
                          format_dict(gt, '{:.2f}', ''), avg_score))
        return top1, top5, val_losses, avg_score

    # ------------------------------------------------------------- fit loop

    def fit(self, train_loader, dev_loader, model_saving_name: str,
            folder: str, checkpoint: Optional[dict] = None,
            plot: bool = True, save: bool = True,
            timer: Optional[StepTimer] = None,
            save_every_steps: Optional[int] = None,
            handle_sigterm: bool = False, keep_best: bool = False,
            metrics_jsonl: Optional[str] = None,
            async_save: bool = False):
        """The reference's ``train`` loop: per epoch the ``Epoch-<e>, lr``
        line, ``train_epoch``, the training printout, the dev
        ``evaluate``, the curve and a checkpoint that overwrites
        ``<folder>/<model_saving_name>``.

        ``checkpoint``: the bookkeeping of a resume (``epoch``, the
        histories, ``mid``; model state in it is loaded too).
        ``save_every_steps``: also a mid-epoch snapshot every N steps.
        ``handle_sigterm``: SIGTERM sets a flag; the loop writes a
        resumable snapshot at the next step boundary and returns (from the
        main thread only, which alone may own a handler; the previous
        handler is restored on exit).  ``keep_best``: the best val mean so
        far (resumed history included) is also copied to
        ``<name>_best``.  ``metrics_jsonl``: one JSON line per epoch.
        ``async_save``: checkpoints are written by a background thread,
        at most one in flight, joined before ``fit`` returns.  In a world
        only rank 0 writes (checkpoints, the curve, ``metrics_jsonl``);
        with split classifiers every rank takes part in the gather of each
        checkpoint's state."""
        histories = {k: [] for k in HISTORY_KEYS}
        epoch = 0
        mid_state = None
        if checkpoint is not None:
            epoch = int(checkpoint["epoch"])
            for k in histories:
                histories[k] = history_list(checkpoint.get(k, []))
            if checkpoint.get("model_state_dict") is not None:
                self.load_model_state(checkpoint)
            mid_state = checkpoint.get("mid")

        ckpt_path = os.path.join(folder, model_saving_name)
        saver = _RankSaver(self)
        if not saver.write:
            plot, metrics_jsonl = False, None

        def save_mid(mid):
            # the histories are copied: the writer never serialises lists
            # the loop appends to
            saver.save(ckpt_path, lambda: {
                "epoch": self._current_epoch,
                **{k: list(v) for k, v in histories.items()},
                **self.model_state_snapshot(), "mid": mid},
                background=async_save)

        if timer is None:
            timer = StepTimer()
        preempt = threading.Event()
        prev_handler = None
        if handle_sigterm \
                and threading.current_thread() is threading.main_thread():
            prev_handler = signal.signal(
                signal.SIGTERM, lambda signum, frame: preempt.set())
        try:
            self._fit_epochs(train_loader, dev_loader, model_saving_name,
                             folder, histories, epoch, mid_state, plot,
                             save, timer, save_every_steps, save_mid,
                             preempt, keep_best, metrics_jsonl, saver,
                             async_save)
        except Preempted as p:
            # stderr: stdout keeps the reference's format
            if p.saved:
                print(f'[srtorch] SIGTERM: saved resumable checkpoint at '
                      f'epoch {p.epoch} batch {p.batch_in_epoch}; exiting '
                      f'cleanly (relaunch with --resume_model to continue)',
                      file=sys.stderr)
            else:
                print(f'[srtorch] SIGTERM: exiting cleanly at epoch '
                      f'{p.epoch} (no new snapshot; resume from the last '
                      f'saved checkpoint, if any)', file=sys.stderr)
        finally:
            saver.join()
            if prev_handler is not None:
                signal.signal(signal.SIGTERM, prev_handler)

    def _fit_epochs(self, train_loader, dev_loader, model_saving_name,
                    folder, histories, epoch, mid_state, plot, save, timer,
                    save_every_steps, save_mid, preempt, keep_best,
                    metrics_jsonl, saver, async_save):
        path = os.path.join(folder, model_saving_name)
        best_path = path + "_best"

        def epoch_ckpt(next_epoch):
            return lambda: {"epoch": next_epoch,
                            **{k: list(v) for k, v in histories.items()},
                            **self.model_state_snapshot()}

        def is_best(val_avg):
            # >= so that the first epoch seeds the best file; [:-1] holds
            # the resumed history, so a restart never demotes a better
            # earlier epoch
            return keep_best and val_avg >= max(
                histories["val_avg_scores"][:-1], default=-1.0)

        def record_val(val_losses, val_avg):
            histories["val_avg_scores"].append(float(val_avg))
            histories["val_verb_losses"].append(
                float(val_losses["verb_loss"]))
            histories["val_nouns_losses"].append(
                float(val_losses["nouns_loss"]))

        if (dev_loader is not None and epoch > 0
                and len(histories["val_avg_scores"])
                < len(histories["avg_scores"])):
            # the last run stopped in its dev eval, after the epoch's
            # checkpoint: finish that eval first, so the histories align
            print(f'[srtorch] completing the interrupted dev eval of epoch '
                  f'{epoch - 1} (previous run stopped mid-eval)',
                  file=sys.stderr)
            try:
                _, _, val_losses, val_avg = self.evaluate(
                    dev_loader, logging=True, preempt=preempt)
            except Preempted:
                raise Preempted(epoch - 1, 0, saved=False)
            record_val(val_losses, val_avg)
            if metrics_jsonl:
                with open(metrics_jsonl, "a") as f:
                    f.write(json.dumps({
                        "epoch": epoch - 1, "catch_up_eval": True,
                        "val_losses": _plain(val_losses),
                        "val_mean": float(val_avg),
                        "time": time.time()}) + "\n")
            if save:
                saver.save(path, epoch_ckpt(epoch), background=async_save,
                           copy_to=best_path if is_best(val_avg) else None)

        for e in range(epoch, self.config.epochs):
            if preempt.is_set():
                # flagged between epochs: the last epoch's checkpoint is
                # the resume point, nothing new is written
                raise Preempted(e, 0)
            # the reference prints the configured lr; with a schedule the
            # rate of the epoch's first optimizer step
            epoch_lr = self.current_lr()
            print('Epoch-{}, lr: {:.4f}'.format(e, epoch_lr))
            timer.reset()
            self._current_epoch = e
            # SRTPU_PROFILE_DIR: the first epoch's training, as JAX traces
            with profile_trace(os.environ.get("SRTPU_PROFILE_DIR")
                               if e == epoch else None):
                top1, top5, (vloss, nloss, gloss) = self.train_epoch(
                    train_loader, e, timer=timer, mid_state=mid_state,
                    save_every=save_every_steps,
                    save_callback=save_mid if save else None,
                    preempt=preempt)
            mid_state = None
            if timer.images_per_sec > 0:
                print(f'[srtorch] epoch {e}: {timer.images_per_sec:.0f} '
                      f'img/s, {timer.mean_step_time * 1000:.0f} ms/step',
                      file=sys.stderr)
            top1_a = top1.get_average_results_both()
            top5_a = top5.get_average_results_both()
            avg_score = mean_of_eight(top1_a, top5_a)
            histories["avg_scores"].append(float(avg_score))
            histories["verb_losses"].append(float(vloss))
            histories["nouns_losses"].append(float(nloss))
            print('training losses = [v: {:.2f}, n: {:.2f}, gt: {:.2f}]'
                  .format(vloss, nloss, gloss))
            gt = {k: top1_a[k] for k in ['gt-value', 'gt-value-all']}
            one_val = {k: top1_a[k] for k in ['verb', 'value', 'value-all']}
            print('{}\n{}\n{}, mean = {:.2f}\n{}'
                  .format(format_dict(one_val, '{:.2f}', '1-'),
                          format_dict(top5_a, '{:.2f}', '5-'),
                          format_dict(gt, '{:.2f}', ''), avg_score,
                          '-' * 50))
            try:
                _, _, val_losses, val_avg = self.evaluate(
                    dev_loader, logging=True, preempt=preempt)
            except Preempted:
                # the epoch's training is done: write it with the val
                # histories one short (the resume finishes the eval)
                if save:
                    saver.save(path, epoch_ckpt(e + 1), background=False)
                raise Preempted(e, 0, saved=save and saver.write)
            record_val(val_losses, val_avg)
            if metrics_jsonl:
                with open(metrics_jsonl, "a") as f:
                    f.write(json.dumps({
                        "epoch": e, "lr": epoch_lr,
                        "train_losses": {"verb": float(vloss),
                                         "nouns": float(nloss),
                                         "gt": float(gloss)},
                        "train_top1": {k: v * 100 for k, v in top1_a.items()},
                        "train_top5": {k: v * 100 for k, v in top5_a.items()},
                        "train_mean": float(avg_score),
                        "val_losses": _plain(val_losses),
                        "val_mean": float(val_avg),
                        "img_per_sec": timer.images_per_sec,
                        "ms_per_step": timer.mean_step_time * 1000,
                        "time": time.time()}) + "\n")
            if plot:
                self._plot(histories, path + ".png")
            if save:
                saver.save(path, epoch_ckpt(e + 1), background=async_save,
                           copy_to=best_path if is_best(val_avg) else None)

    @staticmethod
    def _plot(histories, path):
        """The reference's curve of the six histories; without
        ``matplotlib`` one line on stderr and no figure."""
        global _plot_warned
        try:
            import matplotlib
        except ImportError:
            if not _plot_warned:
                print("[srtorch] matplotlib is not installed: no training "
                      "curve is drawn", file=sys.stderr)
                _plot_warned = True
            return
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        plt.plot(histories["verb_losses"], label='verb losses')
        plt.plot(histories["nouns_losses"], label='nouns losses')
        plt.plot(histories["avg_scores"], label='accuracy mean')
        plt.plot(histories["val_verb_losses"], '-.', label='val verb losses')
        plt.plot(histories["val_nouns_losses"], '-.',
                 label='val nouns losses')
        plt.plot(histories["val_avg_scores"], '-.',
                 label='val accuracy mean')
        plt.grid()
        plt.legend()
        plt.savefig(path)
        plt.clf()

    # ----------------------------------------------------------- state mgmt

    def _param_names(self) -> Tuple[list, list]:
        """The trainable parameters' reference names: (in the reference's
        registration order, which indexes its Adamax state: role_emb,
        verb_emb, the backbone only when fine-tuned as
        ``convnet_verbs.model.*``, ggsnn, the classifiers; in this
        optimizer's order: the head, then the backbone)."""
        head = [n for n, _ in self.head.named_parameters()]
        bb = [REF_BACKBONE + n for n, _ in self.backbone.named_parameters()
              ] if self._ft else []
        return head[:2] + bb + head[2:], head + bb

    def _backbone_source(self) -> "OrderedDict[str, torch.Tensor]":
        """The backbone's state in f32 as a checkpoint holds it: a frozen
        backbone's parameters from the host copy, the rest live."""
        out: OrderedDict = OrderedDict()
        for k, v in self.backbone.state_dict().items():
            if self._bb_host is not None and k in self._bb_host:
                out[k] = self._bb_host[k]
            else:
                out[k] = v
        return out

    def model_state_dict(self, snapshot: bool = False) -> dict:
        """The model part of a checkpoint: ``model_state_dict`` (the
        reference's keys and order, the backbone written to both twins,
        ``num_batches_tracked`` 0), ``optimizer_state_dict`` (Adamax,
        reference indices), ``step_count`` and ``opt_steps``.  Host
        copies; with ``snapshot`` the mutable tensors are private copies
        on their device instead (``model_state_snapshot``)."""
        def get(t: torch.Tensor) -> torch.Tensor:
            t = t.detach()
            if snapshot:
                return t.clone(memory_format=torch.contiguous_format)
            return t.to("cpu", copy=True,
                        memory_format=torch.contiguous_format)

        bb: OrderedDict = OrderedDict()
        for k, v in self._backbone_source().items():
            if k.endswith("num_batches_tracked"):
                bb[k] = torch.zeros((), dtype=torch.long)
            elif self._bb_host is not None and k in self._bb_host:
                bb[k] = v                    # immutable host copy
            else:
                bb[k] = get(v)
        head = OrderedDict((k, get(self._gathered(k, v)))
                           for k, v in self.head.state_dict().items())
        msd: OrderedDict = OrderedDict()
        names = list(head)
        for k in names[:2]:
            msd[k] = head[k]
        for prefix in (REF_BACKBONE, REF_TWIN):
            # one tensor under both names: torch.save writes it once
            for k, v in bb.items():
                msd[prefix + k] = v
        for k in names[2:]:
            msd[k] = head[k]

        osd = self.optimizer.state_dict()
        ref, port = self._param_names()
        where = {n: i for i, n in enumerate(ref)}
        state = {}
        for i, s in osd["state"].items():
            state[where[port[i]]] = {
                k: get(self._gathered(port[i], v)) if torch.is_tensor(v)
                else v for k, v in s.items()}
        group = {k: v for k, v in osd["param_groups"][0].items()
                 if k not in ("params", "lr_ratio")}
        group["params"] = list(range(len(where)))
        return {"model_state_dict": msd,
                "optimizer_state_dict": {
                    "state": dict(sorted(state.items())),
                    "param_groups": [group]},
                "step_count": self.step_count,
                "opt_steps": self.opt_steps}

    def _gathered(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """A split classifier kernel's (or its Adamax state's) column block
        → the whole kernel, by one all-reduce over the model group; any
        other tensor as it is."""
        cols = self._sharded.get(name)
        if cols is None or t.dim() != 2:
            return t
        full = t.new_zeros((t.shape[0], self.config.hidden))
        full[:, cols] = t
        return distributed.all_reduce(full, self.mesh.model_group, "tp")

    def _scattered(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """A whole split kernel → this rank's column block."""
        cols = self._sharded.get(name)
        if cols is None or t.dim() != 2 \
                or t.shape[1] != self.config.hidden:
            return t
        return t[:, cols]

    def model_state_snapshot(self) -> dict:
        """``model_state_dict`` with the mutable tensors as private copies
        on the device, for ``AsyncSaver`` to fetch and write while the
        loop trains on."""
        return self.model_state_dict(snapshot=True)

    def load_backbone_state(self, state, prefix: str = "backbone") -> None:
        """Name-matched, tolerant load of a backbone state dict in the
        port's (torchvision's) layout: keys it lacks print ``[Missed]``
        and keep their values, other shapes ``[Mismatch]``, extra keys
        (a torchvision ``fc``) are ignored."""
        src = self._backbone_source()
        merged = restore_tolerant(
            OrderedDict((k, v.float() if v.is_floating_point() else v)
                        for k, v in src.items()), state, prefix)
        with torch.no_grad():
            self.backbone.load_state_dict(merged, strict=True)
        if not self._ft:
            self._bb_host = {n: _host_f32(merged[n])
                             for n, _ in self.backbone.named_parameters()}

    def load_model_state(self, state: dict) -> None:
        """Restore from a checkpoint dict (``load_checkpoint``: this
        package's, the reference's or a JAX export): tolerant by name as
        ``load_backbone_state``, with the backbone from ``convnet_verbs``
        (the reference's twins' statistics can differ); Adamax through
        ``_load_optimizer``; ``step_count`` and ``opt_steps`` where the
        file has them."""
        msd = state.get("model_state_dict")
        keys = []
        if msd is not None:
            keys = list(msd)
            bb, head = from_reference(msd)
            self.load_backbone_state(bb, REF_BACKBONE.rstrip("."))
            head = {k: self._scattered(k, v) for k, v in head.items()}
            merged = restore_tolerant(self.head.state_dict(), head)
            with torch.no_grad():
                self.head.load_state_dict(merged, strict=True)
        if state.get("step_count") is not None:
            self.step_count = int(state["step_count"])
        osd = state.get("optimizer_state_dict")
        if osd and osd.get("param_groups"):
            self._load_optimizer(osd, keys, state.get("opt_steps"))
        else:
            self.optimizer.state.clear()
            self.opt_steps = int(state.get("opt_steps") or 0)
        self._set_lr()

    def _load_optimizer(self, osd: dict, keys: list, opt_steps) -> None:
        """Adamax state indexed as the reference indexes it (its trainable
        parameters in registration order: ``keys`` without the frozen
        twins, or with ``convnet_verbs`` when the file's optimizer holds
        the backbone) → this optimizer's indices.  A file whose trainable
        set is not this trainer's (``train_backbone`` changed) prints
        ``[Mismatch]`` and restarts Adamax."""
        saved = [i for g in osd["param_groups"] for i in g["params"]]
        bb_params = {n for n, _ in self.backbone.named_parameters()}
        if keys:
            head_only = [k for k in keys
                         if not k.startswith((REF_BACKBONE, REF_TWIN))]
            with_bb = [k for k in keys if not k.startswith(REF_TWIN) and (
                not k.startswith(REF_BACKBONE)
                or k[len(REF_BACKBONE):] in bb_params)]
            names = next((c for c in (head_only, with_bb)
                          if len(c) == len(saved)), None)
        else:
            names = self._param_names()[0]
        port = {n: i for i, n in enumerate(self._param_names()[1])}
        params = [p for g in self.optimizer.param_groups
                  for p in g["params"]]
        state, problem = {}, None
        if names is None or len(names) != len(saved) \
                or set(names) != set(port):
            problem = "its parameters are not this trainer's"
        else:
            pstate = osd.get("state", {})
            for idx, name in zip(saved, names):
                s = pstate.get(idx, pstate.get(str(idx)))
                if s is None:
                    continue
                p = params[port[name]]
                s = {k: self._scattered(name, v) if torch.is_tensor(v)
                     else v for k, v in s.items()}
                if tuple(s["exp_avg"].shape) != tuple(p.shape):
                    problem = f"{name} has shape {tuple(s['exp_avg'].shape)}"
                    break
                state[port[name]] = dict(s)
        if problem is not None:
            # the reference's tolerant-load stance: keep the parameters,
            # restart the optimizer
            print(f"[Mismatch]: optimizer state does not fit this "
                  f"trainer's optimizer (train_backbone changed?) — "
                  f"reinitializing it ({problem})")
            self.optimizer.state.clear()
            self.opt_steps = 0
            return
        groups = self.optimizer.state_dict()["param_groups"]
        self.optimizer.load_state_dict({"state": state,
                                        "param_groups": groups})
        if opt_steps is None:
            opt_steps = max((int(float(s["step"])) for s in state.values()),
                            default=0)
        self.opt_steps = int(opt_steps)


def _sidecars(batch: Dict, n: int):
    """The verbs and labels of the global batch's ``n`` real rows, which
    the gathered top-k rows are scored against."""
    return (np.asarray(batch.get("verbs_global", batch["verbs"]))[:n],
            np.asarray(batch.get("labels_global", batch["labels"]))[:n])


def _plain(x):
    """Numpy scalars in nested dicts → Python numbers (a checkpoint loads
    with ``weights_only=True``)."""
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, np.generic):
        return x.item()
    return x

