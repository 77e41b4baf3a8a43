"""imSitu vocabulary encoder and its per-verb lookup tables.

Port of ``situation_recognition_tpu/data/encoder.py`` (``ImsituEncoder``),
kept as a copy so that this package never imports the JAX one.  The
vocabulary scan keeps the reference's insertion order, so verb / role /
label ids equal the JAX encoder's, and every per-verb structure is a dense
numpy table built once:

* ``role_ids``    (V, R)    int32   — role ids per verb, padded with ``num_roles``
* ``role_counts`` (V,)      int32   — number of real roles per verb
* ``role_mask``   (V, R)    float32 — 1 for real roles, 0 for padding
* ``adjacency``   (V, R, R) float32 — ``get_adj_matrix_noself`` per verb

A batch's structures are one gather (``role_ids[verbs]``); the GGNN only
needs ``role_mask`` (ops/ggnn.py turns the adjacency into a masked sum).
"""

from __future__ import annotations

from typing import Dict, List, Mapping

import numpy as np


class ImsituEncoder:
    """Vocabulary + static graph tables for the imSitu dataset.

    ``train_set`` maps ``img_name -> {"verb": str, "frames": [{role:
    label, ...} x 3]}`` and is scanned in insertion order.  ``verbose``
    prints the reference's "train set stats" block.
    """

    def __init__(self, train_set: Mapping[str, dict] | None = None,
                 verbose: bool = True):
        self.verb_list: List[str] = []
        self.role_list: List[str] = []
        self.label_list: List[str] = []
        self.roles_per_verb: Dict[str, List[str]] = {}
        self.max_role_count: int = 0

        if train_set is not None:
            self._scan(train_set, verbose=verbose)
            self._build_tables()

    @classmethod
    def synthetic_full(cls, seed: int = 0) -> "ImsituEncoder":
        """The real imSitu model shape (504 verbs / 190 roles / 2001 labels
        incl. '' and 'UNK' / max 6 roles) without the dataset; each verb
        draws 1-6 distinct roles from ``seed`` exactly as the JAX encoder
        does, so both give the same tables for the same seed."""
        enc = cls(None)
        enc.verb_list = [f"v{i}" for i in range(504)]
        enc.role_list = [f"r{i}" for i in range(190)]
        enc.label_list = [""] + [f"n{i}" for i in range(1999)] + ["UNK"]
        rng = np.random.default_rng(seed)
        enc.roles_per_verb = {
            v: [f"r{j}" for j in rng.choice(190, size=rng.integers(1, 7),
                                            replace=False)]
            for v in enc.verb_list}
        enc.max_role_count = 6
        enc._build_tables()
        return enc

    # ------------------------------------------------------------------ scan

    def _scan(self, train_set: Mapping[str, dict], verbose: bool) -> None:
        verb_seen, role_seen, label_seen = set(), set(), set()
        for img in train_set:
            annotations = train_set[img]
            current_verb = annotations["verb"]
            if current_verb not in verb_seen:
                verb_seen.add(current_verb)
                self.verb_list.append(current_verb)
                self.roles_per_verb[current_verb] = []
            verb_roles = self.roles_per_verb[current_verb]
            for annotation in annotations["frames"]:
                for role, label in annotation.items():
                    if role not in role_seen:
                        role_seen.add(role)
                        self.role_list.append(role)
                    if role not in verb_roles:
                        verb_roles.append(role)
                        if len(verb_roles) > self.max_role_count:
                            self.max_role_count = len(verb_roles)
                    if label not in label_seen:
                        label_seen.add(label)
                        self.label_list.append(label)

        if verbose:
            print('train set stats: \n\t verb count:', len(self.verb_list),
                  '\n\t role count:', len(self.role_list),
                  '\n\t label count:', len(self.label_list),
                  '\n\t max role count:', self.max_role_count)

    # ---------------------------------------------------------------- tables

    def _build_tables(self) -> None:
        V, R = len(self.verb_list), self.max_role_count
        num_roles = len(self.role_list)

        role_index = {r: i for i, r in enumerate(self.role_list)}

        self.role_ids = np.full((V, R), num_roles, dtype=np.int32)
        self.role_counts = np.zeros((V,), dtype=np.int32)
        for v, verb in enumerate(self.verb_list):
            roles = self.roles_per_verb[verb]
            self.role_counts[v] = len(roles)
            for j, role in enumerate(roles):
                self.role_ids[v, j] = role_index[role]

        self.role_mask = (
            np.arange(R)[None, :] < self.role_counts[:, None]
        ).astype(np.float32)

        # outer product of the role mask; diagonal 0 on real roles and 1 on
        # pad roles (the reference's get_adj_matrix_noself)
        m = self.role_mask
        adj = m[:, :, None] * m[:, None, :]
        diag = np.arange(R)
        adj[:, diag, diag] = 1.0 - m
        self.adjacency = adj.astype(np.float32)

    # ----------------------------------------------------------- vocab sizes

    def get_num_verbs(self) -> int:
        return len(self.verb_list)

    def get_num_roles(self) -> int:
        return len(self.role_list)

    def get_num_labels(self) -> int:
        return len(self.label_list)

    def get_max_role_count(self) -> int:
        return self.max_role_count

    def get_adj_matrix_noself(self, verb_ids) -> np.ndarray:
        """(B, R, R) adjacency of the given verbs."""
        return self.adjacency[np.asarray(verb_ids)]

    # --------------------------------------------------------- serialization

    def to_dict(self) -> dict:
        return {
            "verb_list": self.verb_list,
            "role_list": self.role_list,
            "label_list": self.label_list,
            "roles_per_verb": self.roles_per_verb,
            "max_role_count": self.max_role_count,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "ImsituEncoder":
        enc = cls(None)
        enc.verb_list = list(d["verb_list"])
        enc.role_list = list(d["role_list"])
        enc.label_list = list(d["label_list"])
        enc.roles_per_verb = {k: list(v)
                              for k, v in d["roles_per_verb"].items()}
        enc.max_role_count = int(d["max_role_count"])
        enc._build_tables()
        return enc
