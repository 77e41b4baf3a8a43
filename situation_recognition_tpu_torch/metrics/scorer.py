"""Bit-compatible, vectorized imSitu scorer (numpy only).

A copy of ``situation_recognition_tpu/metrics/scorer.py``, kept in the port
so that it imports nothing of the JAX package.  The reference scorer (the
reference repository's ``utils/imsitu_scorer.py``) loops per example x role
x annotation in Python; this one accumulates the same score cards
vectorized in NumPy over whole batches, from top-k indices the train and
eval steps extract on the device (``Trainer._topk``) or from logits
(``topk_indices``).

Bit-compatibility notes (quirks deliberately reproduced, not "fixed"):

* ``found`` counts a prediction's matches against **all three** annotations
  (imsitu_scorer.py:44-48), so a single role agreeing with two annotators
  counts twice and ``value-all`` (``found >= gt_roles_count``,
  imsitu_scorer.py:50-51) can fire without every role being correct.
* Card values accumulate per-k and are then clamped to 1
  (imsitu_scorer.py:70-72) — equivalent to an "any k" reduction.
* Noun metrics do NOT require the verb to be correct (unlike the official
  imSitu evaluation).
* ``gt-value`` / ``gt-value-all`` exist only on the top-1 scorer and always
  use the top-1 of the gt-verb-conditioned predictions
  (imsitu_scorer.py:56-68).
* Ties in top-k: the reference's torch.topk tie order is unspecified and
  device-dependent.  This scorer is deterministic: ties break toward the
  lower class index via a stable descending argsort, as the trainer's
  iterative argmax does.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def topk_indices(logits: np.ndarray, k: int) -> np.ndarray:
    """Top-k indices along the last axis, ties toward the lower index
    (matches torch.topk ordering used by the reference)."""
    logits = np.asarray(logits)
    if k == 1:
        return np.argmax(logits, axis=-1)[..., None]
    # stable argsort of -x: equal values keep ascending index order
    order = np.argsort(-logits, axis=-1, kind="stable")
    return order[..., :k]


class ImsituScorer:
    """Accumulating scorer with the reference's card semantics.

    Parameters mirror the reference: ``topk`` in {1, 5}, ``nref`` = 3
    annotations.  ``add_point_both`` accepts either raw logits or
    already-extracted top-k index arrays (``*_idx`` keyword form) so the
    expensive top-k can run on device.
    """

    KEYS_TOP1 = ("verb", "value", "value-all", "gt-value", "gt-value-all")
    KEYS_TOPK = ("verb", "value", "value-all")

    def __init__(self, encoder, topk: int, nref: int = 3,
                 keep_cards: bool = False):
        """``keep_cards=True`` additionally retains per-example card dicts in
        ``score_cards`` (the reference's representation,
        imsitu_scorer.py:16-20) for introspection; the vectorized sums are
        always the source of truth for the averages."""
        self.encoder = encoder
        self.topk = topk
        self.nref = nref
        self.keep_cards = keep_cards
        self.score_cards: list = []
        keys = self.KEYS_TOP1 if topk == 1 else self.KEYS_TOPK
        self._sums: Dict[str, float] = {k: 0.0 for k in keys}
        self._count = 0

    # ------------------------------------------------------------------ add

    def add_point_both(
        self,
        pred_verbs,
        verbs,
        pred_roles_nouns,
        roles_nouns,
        gt_pred_roles_nouns=None,
    ) -> None:
        """Score one batch.

        pred_verbs          (B, V) logits  — or (B, topk) indices via
                                              ``add_point_indices``
        verbs               (B,)   gt verb ids
        pred_roles_nouns    (B, R, L) logits for the predicted-verb branch
        roles_nouns         (B, 3, R) gt label ids
        gt_pred_roles_nouns (B, R, L) logits for the gt-verb branch
                            (required when topk == 1)
        """
        pv_idx = topk_indices(np.asarray(pred_verbs), self.topk)
        pn_idx = topk_indices(np.asarray(pred_roles_nouns), self.topk)
        gt_idx = None
        if self.topk == 1:
            if gt_pred_roles_nouns is None:
                raise ValueError("top-1 scorer requires gt_pred_roles_nouns")
            gt_idx = topk_indices(np.asarray(gt_pred_roles_nouns), 1)
        self.add_point_indices(pv_idx, verbs, pn_idx, roles_nouns, gt_idx)

    def add_point_indices(
        self,
        pred_verb_idx: np.ndarray,   # (B, topk)
        verbs,                       # (B,)
        pred_noun_idx: np.ndarray,   # (B, R, topk)
        roles_nouns,                 # (B, 3, R)
        gt_noun_idx: Optional[np.ndarray] = None,  # (B, R, 1)
    ) -> None:
        verbs = np.asarray(verbs)
        labels = np.asarray(roles_nouns)
        pred_verb_idx = np.asarray(pred_verb_idx)
        if pred_verb_idx.ndim != 2 or pred_verb_idx.shape[0] != len(verbs):
            # a (B,) slice (e.g. pv5[:, 0] instead of pv5[:, :1]) would
            # broadcast (B,) == (B, 1) to (B, B) below and silently inflate
            # the verb metric ~B-fold
            raise ValueError(
                f"pred_verb_idx must be (B, topk), got "
                f"{pred_verb_idx.shape} for B={len(verbs)}")
        B, R = pred_noun_idx.shape[0], pred_noun_idx.shape[1]

        role_counts = self.encoder.role_counts[verbs]           # (B,)
        role_mask = np.arange(R)[None, :] < role_counts[:, None]  # (B, R)

        # verb: any of the top-k equals gt (clamp-to-1 == any)
        verb_hit = (pred_verb_idx == verbs[:, None]).any(axis=1)

        # found[b, k] = sum over real roles r and annotations n of
        #   pred_noun_idx[b, r, k] == labels[b, n, r]
        matches = (
            pred_noun_idx[:, :, :, None] == labels.transpose(0, 2, 1)[:, :, None, :]
        )  # (B, R, topk, 3)
        matches = matches & role_mask[:, :, None, None]
        found = matches.sum(axis=(1, 3))                        # (B, topk)

        value_hit = (found > 0).any(axis=1)
        value_all_hit = (found >= role_counts[:, None]).any(axis=1)

        self._sums["verb"] += float(verb_hit.sum())
        self._sums["value"] += float(value_hit.sum())
        self._sums["value-all"] += float(value_all_hit.sum())

        gt_value = gt_value_all = None
        if self.topk == 1:
            gt_matches = (
                gt_noun_idx[:, :, 0, None] == labels.transpose(0, 2, 1)
            )  # (B, R, 3)
            gt_matches = gt_matches & role_mask[:, :, None]
            gt_found = gt_matches.sum(axis=(1, 2))              # (B,)
            gt_value = gt_found > 0
            gt_value_all = gt_found >= role_counts
            self._sums["gt-value"] += float(gt_value.sum())
            self._sums["gt-value-all"] += float(gt_value_all.sum())

        self._count += B
        if self.keep_cards:
            for i in range(B):
                card = {"verb": float(verb_hit[i]),
                        "value": float(value_hit[i]),
                        "value-all": float(value_all_hit[i])}
                if self.topk == 1:
                    card["gt-value"] = float(gt_value[i])
                    card["gt-value-all"] = float(gt_value_all[i])
                self.score_cards.append(card)

    # ---------------------------------------------------------------- means

    def state_dict(self) -> Dict:
        """Serializable accumulator state (mid-epoch checkpointing)."""
        return {"sums": dict(self._sums), "count": self._count}

    def load_state_dict(self, state: Dict) -> None:
        self._sums = {k: float(v) for k, v in state["sums"].items()}
        self._count = int(state["count"])
        # per-example cards are NOT serialized (state_dict keeps only the
        # accumulators); clear any live ones so a keep_cards scorer never
        # reports len(self) != len(self.score_cards) after a restore
        if self.keep_cards:
            self.score_cards = []

    def get_average_results_both(self) -> Dict[str, float]:
        if self._count == 0:
            raise ZeroDivisionError("no score cards accumulated")
        return {k: v / self._count for k, v in self._sums.items()}

    def __len__(self) -> int:
        return self._count


def mean_of_eight(top1: Dict[str, float], top5: Dict[str, float]) -> float:
    """The reference's 8-metric epoch mean x100 (sr.py:96-100)."""
    s = (top1["verb"] + top1["value"] + top1["value-all"]
         + top5["verb"] + top5["value"] + top5["value-all"]
         + top1["gt-value"] + top1["gt-value-all"])
    return s / 8 * 100
