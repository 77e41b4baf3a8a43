"""Everything a run makes from its seed: the vocabulary (an imSitu-format
train set), the weights, the window store and the batches.

The same seed gives the same inputs on every run, and the program and the
reference are handed the same ones.  Weights are drawn on the run's
device in two large calls (one normal, one uniform draw for every tensor
at once) and scaled per tensor; the store is one draw of uint8 windows.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from reference import backbones

#: a seed of up to 64 bits folded into a generator seed
_MASK = (1 << 63) - 1


def _gen(seed: int, stream: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 7919 + stream * 104_729) & _MASK)
    return g


def _rng(seed: int, *stream) -> np.random.Generator:
    return np.random.default_rng([int(seed) & _MASK, *stream])


# ------------------------------------------------------------ vocabulary


def train_set(seed: int, head: dict) -> dict:
    """An imSitu-format train set (image → verb and three frames of role
    → noun) of ``num_verbs`` verbs, each with 1 to ``max_roles`` distinct
    roles of ``num_roles`` (one verb at least with ``max_roles``), every
    role and every one of ``num_labels`` nouns used.  Scanned in order,
    it gives verb, role and noun ids 0, 1, 2, ..."""
    v, nr, nl, r = (head["num_verbs"], head["num_roles"],
                    head["num_labels"], head["max_roles"])
    rng = _rng(seed, 1)
    counts = rng.integers(1, r + 1, v)
    counts[rng.integers(0, v)] = r
    roles = [list(rng.choice(nr, size=c, replace=False)) for c in counts]
    while True:
        used = {x for rs in roles for x in rs}
        missing = [x for x in range(nr) if x not in used]
        if not missing:
            break
        # a missing role takes a random slot (the role it replaces may go
        # missing in turn, which the next pass mends)
        for x in missing:
            verb = int(rng.integers(0, v))
            roles[verb][int(rng.integers(0, len(roles[verb])))] = x
    frames_per = [3 * len(rs) for rs in roles]
    if sum(frames_per) < nl:
        raise ValueError(f"{sum(frames_per)} role slots cannot use all "
                         f"{nl} nouns")
    labels = np.concatenate([rng.permutation(nl) for _ in range(
        -(-sum(frames_per) // nl))])
    out, k = {}, 0
    # ids follow first appearance: role i and noun i first appear in that
    # order
    role_name = {x: f"r{i}" for i, x in enumerate(dict.fromkeys(
        x for rs in roles for x in rs))}
    noun_name = {x: f"n{i}" for i, x in enumerate(dict.fromkeys(
        labels[:sum(frames_per)]))}
    for i, rs in enumerate(roles):
        frames = []
        for _ in range(3):
            frames.append({role_name[x]: noun_name[labels[k + j]]
                           for j, x in enumerate(rs)})
            k += len(rs)
        out[f"img{i}.jpg"] = {"verb": f"v{i}", "frames": frames}
    return out


def role_counts(ts: dict) -> np.ndarray:
    """(V,) roles per verb of a train set made by ``train_set``."""
    return np.array([len(a["frames"][0]) for a in ts.values()])


# ---------------------------------------------------------------- weights


def head_leaves(head: dict):
    """(name, shape, init) of the FCGGNN head in the reference's names:
    normal(0, 1) role and verb embeddings (the role table's padding row,
    ``role_emb`` row ``num_roles``, zero), uniform ±1/sqrt(hidden) gates
    and classifiers."""
    d = head["hidden"]
    b = d ** -0.5
    out = [("role_emb.weight", (head["num_roles"] + 1, d), ("normal", 1.0)),
           ("verb_emb.weight", (head["num_verbs"], d), ("normal", 1.0))]
    for g in ("W_p", "W_z", "U_z", "W_r", "U_r", "W_h", "U_h"):
        out += [(f"ggsnn.{g}.weight", (d, d), ("uniform", b)),
                (f"ggsnn.{g}.bias", (d,), ("uniform", b))]
    for name, n in (("verb_classifier", head["num_verbs"]),
                    ("nouns_classifier", head["num_labels"])):
        out += [(f"{name}.1.weight", (n, d), ("uniform", b)),
                (f"{name}.1.bias", (n,), ("uniform", b))]
    return out


def make_state(leaves, seed: int, stream: int, device) -> dict:
    """A float32 state dict of ``leaves`` on ``device``: one normal and one
    uniform draw for all of them, scaled per tensor by one product each."""
    g = _gen(seed, stream, device)
    kinds = {"normal": [], "uniform": []}
    for name, shape, (kind, arg) in leaves:
        if kind in kinds:
            kinds[kind].append((name, shape, arg))
    out = {}
    for kind, items in kinds.items():
        sizes = [math.prod(s) for _, s, _ in items]
        total = sum(sizes)
        if not total:
            continue
        if kind == "normal":
            flat = torch.randn(total, generator=g, device=device)
        else:
            flat = torch.rand(total, generator=g, device=device).mul_(2) \
                .sub_(1)
        scale = torch.repeat_interleave(
            torch.tensor([a for _, _, a in items], device=device),
            torch.tensor(sizes, device=device), output_size=total)
        flat.mul_(scale)
        for (name, shape, _), part in zip(items, flat.split(sizes)):
            out[name] = part.view(shape)
    for name, shape, (kind, arg) in leaves:
        if kind == "const":
            out[name] = torch.full(shape, float(arg), device=device)
        elif kind == "count":
            out[name] = torch.zeros(shape, dtype=torch.long, device=device)
    return {name: out[name] for name, _, _ in leaves}


def backbone_leaves(cfg: dict):
    """(name, shape, init) of ``cfg``'s backbone, from the reference's
    file of its kind (``reference/backbones/<kind>.py``)."""
    return backbones.of(cfg).leaves(cfg)


def weights(cfg: dict, seed: int, device):
    """(backbone state, head state) of ``cfg`` from ``seed``, float32 on
    ``device``; the role table's padding row is zero."""
    bb = make_state(backbone_leaves(cfg), seed, 1, device)
    head = make_state(head_leaves(cfg["head"]), seed, 2, device)
    head["role_emb.weight"][-1].zero_()
    return bb, head


# ------------------------------------------------------------------ data


def store(seed: int, rows: int, window: int, device) -> torch.Tensor:
    """(rows, window, window, 3) uint8 windows of the run, one draw on
    ``device``."""
    return torch.randint(0, 256, (rows, window, window, 3),
                         generator=_gen(seed, 3, device), device=device,
                         dtype=torch.uint8)


def batch(seed: int, index: int, size: int, rows: int, counts: np.ndarray,
          num_labels: int, max_roles: int, distinct=None) -> dict:
    """Host batch ``index`` of a run: ``size`` rows of the store (all
    different; ``distinct``, if given, is the rows to take), a flip each,
    a verb each (uniform), and three annotations of a noun (uniform) for
    each of the verb's roles, ``num_labels`` on the pad slots."""
    rng = _rng(seed, 4, index)
    idx = (np.asarray(distinct) if distinct is not None
           else rng.choice(rows, size, replace=False))
    verbs = rng.integers(0, len(counts), size)
    labels = rng.integers(0, num_labels, (size, 3, max_roles))
    pad = np.arange(max_roles)[None, None, :] >= counts[verbs][:, None, None]
    labels[np.broadcast_to(pad, labels.shape)] = num_labels
    return {"indices": idx.astype(np.int64),
            "flip": rng.random(size) < 0.5,
            "verbs": verbs.astype(np.int64),
            "labels": labels.astype(np.int64)}


def first_rows(seed: int, steps: int, size: int, rows: int) -> np.ndarray:
    """(steps, size) store rows of the checked first steps, all different."""
    if steps * size > rows:
        raise ValueError(f"{steps} x {size} distinct rows need a store of "
                         f"at least that many, not {rows}")
    return _rng(seed, 5).permutation(rows)[:steps * size].reshape(steps,
                                                                  size)
