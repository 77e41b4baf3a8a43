"""Training and evaluation of ResNet + FCGGNN on one device.

Port of ``situation_recognition_tpu/train.py``: ``TrainerConfig`` (the
fields this package uses), ``make_lr_fn``, and ``Trainer`` with its train
and eval steps (``train.py:697-738``), ``train_epoch`` and ``evaluate``,
run synchronously: one step per batch, scored on the host.

A train step does what the JAX step does:

1. features from the frozen backbone outside autograd, with train-mode
   BatchNorm (flax's, ``models/resnet.BatchNorm``) updating the running
   statistics once per step;
2. under autograd: the verb branch, its argmax, the predicted-verb noun
   branch, and the masked verb CE plus the masked nouns CE;
3. backward;
4. the gt-verb noun branch, forward-only on the parameters before the
   update (its loss is logged, never backpropagated) — on the card its
   GGNN propagate is the folded kernel K1;
5. a global-norm-1 clip and Adamax(lr), the rate from ``make_lr_fn`` at
   the optimizer-step count;
6. top-5 indices by iterative argmax (ties to the lower index).

Differentiated GGNN propagates take autograd over the masked-sum math, or
with ``SRTPU_GGNN_BWD=pallas`` the K2/K3 autograd Function
(``models/fcggnn.GGNN``).  Dropout draws from ``torch.Generator``s seeded
from ``config.seed`` and the step count, one stream for the
differentiated branches and another for the gt branch.  The eval step runs
all three branches forward-only (K1 on the card) with eval-mode BN.

The trainer takes any iterable of batch dicts ``{"images": uint8 (B, 256,
256, 3), "flip": bool (B,), "verbs": (B,), "labels": (B, 3, R)}`` of at
most ``batch_size`` rows; shorter batches are wrapped to ``batch_size``
(``_pad_batch``), so their pad rows enter the BN statistics, as in JAX,
and are masked out of the losses and scores.
"""

from __future__ import annotations

import dataclasses
import math
import sys
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from situation_recognition_tpu_torch.data.encoder import ImsituEncoder
from situation_recognition_tpu_torch.data.transforms import device_transform
from situation_recognition_tpu_torch.device import resolve_device
from situation_recognition_tpu_torch.metrics.scorer import (
    ImsituScorer, mean_of_eight)
from situation_recognition_tpu_torch.models.fcggnn import (
    FCGGNNHead, nouns_loss_masked, resolve_ggnn_impl, verb_loss_masked)
from situation_recognition_tpu_torch.models.resnet import build_resnet


@dataclasses.dataclass
class TrainerConfig:
    hidden: int = 2048
    lr: float = 0.002
    batch_size: int = 6144
    num_ggnn_steps: int = 4
    dropout_rate: float = 0.5
    backbone: str = "resnet152"          # resnet152 | mini
    compute_dtype: torch.dtype = torch.bfloat16
    seed: int = 0
    ggnn_impl: str = "auto"              # auto | kernel | masked
    # schedule over optimizer steps: constant (the reference's) | cosine
    # | linear, with an optional linear warmup
    lr_schedule: str = "constant"
    warmup_steps: int = 0
    total_steps: Optional[int] = None
    min_lr: float = 0.0


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


def format_dict(d: Dict[str, float], s: str, p: str) -> str:
    """'<p><key>: <s.format(v*100)>' joined by ', ' (reference format)."""
    return ", ".join(p + str(k) + ": " + s.format(v * 100)
                     for k, v in d.items())


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


class Trainer:
    """Owns the backbone, the head, the optimizer and the steps.

    ``device``: default cuda (raises without a card), ``"cpu"`` by name.
    ``backbone_state`` / ``head_state``: state dicts in the reference
    layout (``convert.py``); without them the weights are random from
    ``config.seed``."""

    def __init__(self, encoder: ImsituEncoder, config: TrainerConfig,
                 device=None, backbone_state: Optional[dict] = None,
                 head_state: Optional[dict] = None):
        self.encoder = encoder
        self.config = config
        self.device = resolve_device(device)
        dt = config.compute_dtype
        gen = torch.Generator().manual_seed(config.seed)
        self.backbone = build_resnet(config.backbone, config.hidden)
        if backbone_state is None:
            self.backbone.reset_parameters(gen)
        else:
            self.backbone.load_state_dict(backbone_state, strict=True)
        self.head = FCGGNNHead(
            encoder.get_num_verbs(), encoder.get_num_roles(),
            encoder.get_num_labels(), encoder.max_role_count,
            hidden=config.hidden, num_steps=config.num_ggnn_steps,
            dropout_rate=config.dropout_rate, dtype=dt,
            ggnn_impl=resolve_ggnn_impl(config.ggnn_impl, dt, self.device))
        if head_state is None:
            self.head.reset_parameters(gen)
        else:
            self.head.load_state_dict(head_state, strict=True)
        # the frozen backbone: convolutions in the compute type (flax casts
        # its f32 kernels at each use; frozen, that is the same thing),
        # BatchNorm parameters and statistics in f32, channels-last
        self.backbone.to(self.device)
        for m in self.backbone.modules():
            if isinstance(m, nn.Conv2d):
                m.to(dtype=dt)
        self.backbone.to(memory_format=torch.channels_last)
        self.backbone.requires_grad_(False)
        self.head.to(self.device)
        self.role_ids = torch.as_tensor(encoder.role_ids, dtype=torch.long,
                                        device=self.device)
        self.role_mask = torch.as_tensor(encoder.role_mask,
                                         device=self.device)
        # the reference's optimizer: clip_grad_norm_(1.0), then Adamax
        self._lr_fn = make_lr_fn(config)
        self.optimizer = torch.optim.Adamax(self.head.parameters(),
                                            lr=config.lr)
        self.opt_steps = 0
        self.step_count = 0

    # ------------------------------------------------------------- stepping

    def _generator(self, stream: int) -> torch.Generator:
        """Dropout stream ``stream`` of the current step."""
        g = torch.Generator(device=self.device)
        g.manual_seed((self.config.seed * 1_000_003 + self.step_count) * 2
                      + stream)
        return g

    def _features(self, images: torch.Tensor, flip, train: bool):
        """Device transform + frozen backbone → features (B, D) f32, with
        no gradient; in train mode BN uses batch statistics and updates
        its running ones."""
        x = device_transform(images, flip if train else None,
                             dtype=self.config.compute_dtype)
        self.backbone.train(train)
        with torch.no_grad():
            return self.backbone(x).float()

    def _losses(self, outs, verbs, labels, valid):
        pred_verb, pred_nouns, gt_pred_nouns = outs
        n_labels = self.encoder.get_num_labels()
        return torch.stack([
            verb_loss_masked(pred_verb, verbs, valid),
            nouns_loss_masked(pred_nouns, labels, n_labels, valid),
            nouns_loss_masked(gt_pred_nouns, labels, n_labels, valid)])

    @staticmethod
    def _topk(outs):
        pred_verb, pred_nouns, gt_pred_nouns = outs
        gt1 = torch.argmax(gt_pred_nouns, dim=-1)[..., None]
        return _topk5(pred_verb), _topk5(pred_nouns), gt1

    def train_step(self, images, flip, verbs, labels, valid):
        """One optimizer step on a device batch → (losses (3,) f32:
        verb, nouns, gt nouns; top-k (pred_verb top-5, pred_nouns top-5,
        gt_nouns top-1))."""
        feats = self._features(images, flip, True)
        head = self.head
        n_labels = self.encoder.get_num_labels()
        self.optimizer.zero_grad(set_to_none=True)
        pred_verb, pred_nouns = head.predict_train(
            feats, self.role_ids, self.role_mask, train=True,
            generator=self._generator(0))
        vloss = verb_loss_masked(pred_verb, verbs, valid)
        nloss = nouns_loss_masked(pred_nouns, labels, n_labels, valid)
        (vloss + nloss).backward()
        with torch.no_grad():
            gt_pred_nouns = head.predict_nouns(
                feats, verbs, self.role_ids, self.role_mask, train=True,
                generator=self._generator(1))
            gloss = nouns_loss_masked(gt_pred_nouns, labels, n_labels, valid)
        torch.nn.utils.clip_grad_norm_(head.parameters(), 1.0)
        if self._lr_fn is not None:
            for group in self.optimizer.param_groups:
                group["lr"] = self._lr_fn(self.opt_steps)
        self.optimizer.step()
        self.opt_steps += 1
        losses = torch.stack([vloss.detach(), nloss.detach(), gloss])
        return losses, self._topk((pred_verb.detach(), pred_nouns.detach(),
                                   gt_pred_nouns))

    def eval_step(self, images, verbs, labels, valid):
        """All three branches forward-only with eval-mode BN → (losses,
        top-k) as ``train_step``."""
        feats = self._features(images, None, False)
        with torch.no_grad():
            outs = self.head(feats, verbs, self.role_ids, self.role_mask)
            return self._losses(outs, verbs, labels, valid), self._topk(outs)

    # ------------------------------------------------------------- batching

    def _pad_batch(self, batch: Dict) -> Tuple[Dict, np.ndarray, int]:
        """Pad to config.batch_size by wrapping; returns (arrays, valid,
        n)."""
        big = self.config.batch_size
        n = len(batch["verbs"])
        if n > big:
            raise ValueError(
                f"loader batch of {n} exceeds config.batch_size {big}")
        keys = ("images", "flip", "verbs", "labels")
        if n == big:
            # a full batch passes through: the wrap-gather would copy the
            # whole uint8 image batch on the host for an identity index
            out = {k: np.asarray(batch[k]) for k in keys}
        else:
            idx = np.arange(big) % n
            out = {k: np.asarray(batch[k])[idx] for k in keys}
        return out, (np.arange(big) < n).astype(np.float32), n

    def _upload(self, batch: Dict):
        """Host batch → (images, flip, verbs, labels, valid) on the device,
        and the count of real rows."""
        arrays, valid, n = self._pad_batch(batch)

        def put(x, dtype):
            return torch.from_numpy(np.ascontiguousarray(x)).to(
                device=self.device, dtype=dtype)

        return (put(arrays["images"], torch.uint8),
                put(arrays["flip"], torch.bool),
                put(arrays["verbs"], torch.long),
                put(arrays["labels"], torch.long),
                put(valid, torch.float32)), n

    @staticmethod
    def _score(top1, top5, topk, batch, n):
        pv5, pn5, gt1 = (x.cpu().numpy()[:n] for x in topk)
        verbs = np.asarray(batch["verbs"])[:n]
        labels = np.asarray(batch["labels"])[:n]
        top1.add_point_indices(pv5[:, :1], verbs, pn5[:, :, :1], labels, gt1)
        top5.add_point_indices(pv5, verbs, pn5, labels)

    # ------------------------------------------------------------ epoch API

    def train_epoch(self, loader, epoch: int):
        """One pass over ``loader`` (a train step per batch) → (top1,
        top5 scorers, mean (verb, nouns, gt) losses)."""
        if hasattr(loader, "set_epoch"):
            loader.set_epoch(epoch)
        top1 = ImsituScorer(self.encoder, 1, 3)
        top5 = ImsituScorer(self.encoder, 5, 3)
        sums = np.zeros(3)
        num_batches = 0
        for batch in loader:
            args, n = self._upload(batch)
            losses, topk = self.train_step(*args)
            self._score(top1, top5, topk, batch, n)
            sums += losses.cpu().numpy()
            num_batches += 1
            self.step_count += 1
        return top1, top5, tuple(sums / max(num_batches, 1))

    def evaluate(self, loader, logging: bool = False):
        """An eval step per batch → (top1, top5, val_losses dict,
        avg_score); ``avg_score`` (the mean of the 8 metrics x100) and the
        reference's printout only with ``logging``."""
        top1 = ImsituScorer(self.encoder, 1, 3)
        top5 = ImsituScorer(self.encoder, 5, 3)
        sums = np.zeros(3)
        num_batches = 0
        images = 0
        t0 = time.perf_counter()
        for batch in loader:
            (imgs, _, verbs, labels, valid), n = self._upload(batch)
            losses, topk = self.eval_step(imgs, verbs, labels, valid)
            self._score(top1, top5, topk, batch, n)
            sums += losses.cpu().numpy()
            num_batches += 1
            images += n
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
