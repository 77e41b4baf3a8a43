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
``save``/``load`` write and read the JAX encoder's JSON file, so either
package reads the other's ``<saving_folder>/encoder``.
"""

from __future__ import annotations

import json
from typing import Dict, List, Mapping, Sequence, Tuple

import numpy as np


class ImsituEncoder:
    """Vocabulary + static graph tables for the imSitu dataset.

    ``train_set`` maps ``img_name -> {"verb": str, "frames": [{role:
    label, ...} x 3]}`` and is scanned in insertion order.  ``verbose``
    prints the reference's "train set stats" block.
    """

    #: annotator frames per image in imSitu
    NUM_FRAMES = 3

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
        self._label_index = {l: i for i, l in enumerate(self.label_list)}
        self._verb_index = {v: i for i, v in enumerate(self.verb_list)}

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

    def get_role_count(self, verb_id: int) -> int:
        return int(self.role_counts[verb_id])

    # ------------------------------------------------------------- encoding

    def encode(self, item: dict) -> Tuple[int, np.ndarray]:
        """One annotation record → (verb id, labels (frames, R) int32)."""
        verb = self._verb_index[item["verb"]]
        return verb, self.get_label_ids(item["verb"], item["frames"])

    def get_label_ids(self, verb: str,
                      frames: Sequence[Mapping[str, str]]) -> np.ndarray:
        """Label ids of each frame's roles in the verb's role order: an
        unseen label maps to ``UNK`` (``ValueError`` without one, as the
        reference's ``list.index``), the pad slots to ``num_labels``."""
        roles = self.roles_per_verb[verb]
        num_labels = len(self.label_list)
        unk = self._label_index.get("UNK")
        out = np.full((len(frames), self.max_role_count), num_labels,
                      dtype=np.int32)
        for f, frame in enumerate(frames):
            for j, role in enumerate(roles):
                label = frame[role]
                idx = self._label_index.get(label)
                if idx is None:
                    if unk is None:
                        raise ValueError(
                            f"unseen label {label!r} and no UNK in vocab")
                    idx = unk
                out[f, j] = idx
        return out

    # ---------------------------------------------------------- table lookups

    def get_role_ids(self, verb_id: int) -> np.ndarray:
        """(R,) role ids of one verb (pad = num_roles)."""
        return self.role_ids[verb_id]

    def get_role_ids_batch(self, verbs) -> np.ndarray:
        """(B, R) role ids of the given verbs."""
        return self.role_ids[np.asarray(verbs)]

    def get_adj_matrix_noself(self, verb_ids) -> np.ndarray:
        """(B, R, R) adjacency of the given verbs."""
        return self.adjacency[np.asarray(verb_ids)]

    def get_verb2role_encoding_batch(self, verb_ids) -> np.ndarray:
        """(B, R) role mask of the given verbs."""
        return self.role_mask[np.asarray(verb_ids)]

    # ------------------------------------------------------------ transforms

    def dev_transform(self, img) -> np.ndarray:
        """Eval preprocessing of one HWC uint8 image (or PIL image) →
        normalised (224, 224, 3) float32: the center 256 window and the
        device transform, on the CPU."""
        import torch

        from situation_recognition_tpu_torch.data import transforms as T

        window = T.host_window(np.asarray(img), train=False)
        return T.eval_transform(torch.from_numpy(
            np.ascontiguousarray(window[None]))).numpy()[0]

    def train_transform(self, img, rng: np.random.Generator) -> np.ndarray:
        """Train preprocessing of one image: the random window from
        ``rng``, then a flip drawn from it (``rng`` is required: an
        unseeded crop would break determinism)."""
        import torch

        from situation_recognition_tpu_torch.data import transforms as T

        window = T.host_window(np.asarray(img), train=True, rng=rng)
        flip = torch.tensor([rng.random() < 0.5])
        return T.device_transform(torch.from_numpy(
            np.ascontiguousarray(window[None])), flip).numpy()[0]

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

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f)

    @classmethod
    def load(cls, path: str) -> "ImsituEncoder":
        with open(path) as f:
            return cls.from_dict(json.load(f))
