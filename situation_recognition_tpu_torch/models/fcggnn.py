"""FCGGNN situation-recognition head: embeddings + GGNN + classifiers.

Port of ``situation_recognition_tpu/models/fcggnn.py``.  Module names are
the reference FCGGNN's (``role_emb``, ``verb_emb``, ``ggsnn.W_p`` ...,
``verb_classifier.1``, ``nouns_classifier.1``), so the head's state dict
is the reference ``model_state_dict`` without its two backbone copies.

Semantics kept from the JAX head: node init ``relu(f * role_emb *
verb_emb)``, relu on the features only in the verb branch, 4 GGNN steps,
Dropout(0.5) before each classifier, and the ``role_emb`` padding row
fixed at zero.  ``dtype`` is the compute type: parameters stay f32 and are
cast at each use, as flax does.  Dropout acts only when a branch is called
with ``train=True``, like flax's ``deterministic=not train``, and draws
its masks from the ``generator`` given with it (an explicit
``torch.Generator``, never the global one); ``forward`` draws in the JAX
head's order: verb, predicted-verb nouns, gt-verb nouns.

GGNN implementations (``resolve_ggnn_impl``): ``kernel`` runs forward-only
propagates through the folded multi-step kernel K1 (``ops/ggnn_kernel.py``,
bf16 inside; from a serving program's ``operands`` instead of folding
the weights) and differentiated ones as the JAX package does
(``ops/ggnn_train.py``): autograd over the masked-sum math by default, or,
with ``SRTPU_GGNN_BWD=pallas``, the K2/K3 autograd Function.  ``masked``
runs the masked-sum math of ``ops/ggnn.py`` in ``dtype`` everywhere.
``auto`` picks the kernel on a CUDA device at bf16, as the JAX trainer
picks its Pallas kernel on a TPU at bf16.

In a world of processes (``parallel/``) the trainer sets two attributes:
``dropout_rows`` = (start, global batch) makes each dropout draw the global
batch's mask from the generator and keep this rank's rows, so that a world
equals one process at the global batch, dropout included; ``tp`` = (model
group, column block) splits the classifiers over the model axis: this rank
holds its block of their input columns, and a classifier is the partial
product, one all-reduce over the model group, then the bias
(``_ClassifierShard``, whose backward gathers dx the same way).

The losses are the JAX package's (``models/fcggnn.py:218-298``), in f32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from situation_recognition_tpu_torch.ops.ggnn import (
    GGNNParams, ggnn_propagate, ggnn_propagate_verb)
from situation_recognition_tpu_torch.ops.ggnn_kernel import (
    fold_gate_weights, ggnn_propagate_folded, ggnn_propagate_prepared)
from situation_recognition_tpu_torch.ops.ggnn_train import (
    ggnn_propagate_train, resolve_ggnn_bwd)
from situation_recognition_tpu_torch.parallel import distributed

GGSNN_NAMES = ("W_p", "W_z", "U_z", "W_r", "U_r", "W_h", "U_h")


def resolve_ggnn_impl(impl: str, dtype: torch.dtype,
                      device: torch.device) -> str:
    """'auto' → 'kernel' on cuda at bf16, 'masked' otherwise; 'kernel'
    and 'masked' pass through (on the CPU, 'kernel' runs the kernel's
    plain twin)."""
    if impl == "auto":
        return ("kernel" if torch.device(device).type == "cuda"
                and dtype == torch.bfloat16 else "masked")
    if impl not in ("kernel", "masked"):
        raise ValueError(f"ggnn_impl must be auto|kernel|masked, got "
                         f"{impl!r}")
    return impl


def dropout(x: torch.Tensor, rate: float,
            generator: torch.Generator | None,
            rows: tuple | None = None) -> torch.Tensor:
    """flax ``nn.Dropout`` in train mode: keep each element with
    probability 1 - rate and scale the kept ones by 1 / (1 - rate); the
    masks come from ``generator`` (on x's device).  ``rows`` = (start,
    total): x is rows start... of a batch of ``total``, whose whole mask
    is drawn."""
    if rate == 0.0:
        return x
    keep_prob = 1.0 - rate
    shape = x.shape if rows is None else (rows[1],) + tuple(x.shape[1:])
    keep = torch.rand(shape, generator=generator, device=x.device) \
        < keep_prob
    if rows is not None:
        keep = keep[rows[0]:rows[0] + x.shape[0]]
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype,
                                                        device=x.device))


class _ClassifierShard(torch.autograd.Function):
    """x (N, d) @ w[:, cols]ᵀ summed over the model group → (N, out) f32,
    from this rank's column block ``w`` (out, d/M) of the kernel.  The
    backward: dw from this rank's block of x, and dx's blocks of every
    rank gathered by one all-reduce."""

    @staticmethod
    def forward(ctx, x, w, cols, group):
        out = F.linear(x[:, cols], w).float()
        distributed.all_reduce(out, group, "tp")
        ctx.save_for_backward(x, w)
        ctx.cols, ctx.group = cols, group
        return out

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(w.dtype)
        dx = torch.zeros_like(x)
        dx[:, ctx.cols] = g @ w
        distributed.all_reduce(dx, ctx.group, "tp")
        return dx, g.t() @ x[:, ctx.cols], None, None


def _uniform_(t: torch.Tensor, bound: float, g: torch.Generator) -> None:
    with torch.no_grad():
        t.copy_((torch.rand(t.shape, generator=g) * 2 - 1) * bound)


class GGNN(nn.Module):
    """The 7 dense layers of the reference GGSNN and the propagate calls."""

    def __init__(self, hidden: int, num_steps: int = 4,
                 dtype: torch.dtype = torch.float32, impl: str = "masked"):
        super().__init__()
        for name in GGSNN_NAMES:
            setattr(self, name, nn.Linear(hidden, hidden))
        self.num_steps = num_steps
        self.dtype = dtype
        self.impl = impl
        self._folded = {}
        # a serving program's K1 operands (``serving.kernel_operands``): a
        # module of buffers while it is traced, else None
        self.register_module("operands", None)

    def params(self) -> GGNNParams:
        """(D_in, D_out) views in the compute type (JAX layout)."""
        out = []
        for name in GGSNN_NAMES:
            lin = getattr(self, name)
            out += [lin.weight.t().to(self.dtype), lin.bias.to(self.dtype)]
        return GGNNParams(*out)

    def folded(self, bias_mult: float):
        """``fold_gate_weights`` of the compute-type weights, kept until a
        weight is replaced or written in place."""
        key = (bias_mult, self.dtype, tuple(
            (p.data_ptr(), p._version) for p in self.parameters()))
        hit = self._folded.get(bias_mult)
        if hit is None or hit[0] != key:
            with torch.no_grad():
                hit = (key, fold_gate_weights(self.params(), bias_mult))
            self._folded[bias_mult] = hit
        return hit[1]

    def _differentiated(self, hidden: torch.Tensor) -> bool:
        return torch.is_grad_enabled() and (hidden.requires_grad or any(
            p.requires_grad for p in self.parameters()))

    def _kernel(self, hidden, mask):
        if self._differentiated(hidden):
            raise RuntimeError("the folded GGNN kernel is forward-only; run "
                               "it under torch.no_grad() or "
                               "torch.inference_mode()")
        r = hidden.shape[1]
        ops = self.operands
        if ops is not None:
            # a serving program: K1's operands are its arguments, prepared
            # once at load (``serving.kernel_operands``)
            return ggnn_propagate_prepared(
                hidden, mask, self.num_steps,
                (ops.w_zr, ops.u_zr, ops.w_h, ops.u_h),
                getattr(ops, f"ba_{r}"))
        return ggnn_propagate_folded(None, hidden, mask, self.num_steps,
                                     weights=self.folded(float(r)))

    def _route(self, hidden: torch.Tensor) -> str:
        """'kernel' (K1), 'train_kernel' (K2/K3) or 'masked'."""
        if self.impl != "kernel":
            return "masked"
        if not self._differentiated(hidden):
            return "kernel"
        return "train_kernel" if resolve_ggnn_bwd() == "pallas" else "masked"

    def _propagate(self, hidden, mask):
        route = self._route(hidden)
        if route == "kernel":
            return self._kernel(hidden, mask)
        if route == "train_kernel":
            r = float(hidden.shape[1])
            return ggnn_propagate_train(self.params(), hidden, mask,
                                        self.num_steps,
                                        weights=self.folded(r))
        return ggnn_propagate(self.params(), hidden, mask, self.num_steps)

    def propagate(self, hidden: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
        """hidden (B, R, D), mask (B, R) → (B, R, D)."""
        return self._propagate(hidden.to(self.dtype), mask)

    def propagate_verb(self, hidden: torch.Tensor) -> torch.Tensor:
        """hidden (B, D) single-node graphs → (B, D).  Through the kernels
        as r=1 with mask 0: every node self-messages (E = I)."""
        hidden = hidden.to(self.dtype)
        if self._route(hidden) == "masked":
            return ggnn_propagate_verb(self.params(), hidden,
                                       self.num_steps)
        zeros = torch.zeros(hidden.shape[0], 1, dtype=torch.float32,
                            device=hidden.device)
        return self._propagate(hidden[:, None, :], zeros)[:, 0, :]

    def reset_parameters(self, generator: torch.Generator) -> None:
        bound = 1.0 / math.sqrt(self.W_p.in_features)
        for name in GGSNN_NAMES:
            lin = getattr(self, name)
            _uniform_(lin.weight, bound, generator)
            _uniform_(lin.bias, bound, generator)


class FCGGNNHead(nn.Module):
    """Everything after the backbone.  Call the branches with pooled
    features (B, D) and the encoder tables (``role_ids`` (V, R) long,
    ``role_mask`` (V, R) float)."""

    def __init__(self, num_verbs: int, num_roles: int, num_labels: int,
                 max_role_count: int, hidden: int = 2048,
                 num_steps: int = 4, dropout_rate: float = 0.5,
                 dtype: torch.dtype = torch.float32,
                 ggnn_impl: str = "masked"):
        super().__init__()
        self.max_role_count = max_role_count
        self.num_labels = num_labels
        self.dtype = dtype
        self.role_emb = nn.Embedding(num_roles + 1, hidden,
                                     padding_idx=num_roles)
        self.verb_emb = nn.Embedding(num_verbs, hidden)
        self.ggsnn = GGNN(hidden, num_steps, dtype, ggnn_impl)
        self.verb_classifier = nn.Sequential(
            nn.Dropout(dropout_rate), nn.Linear(hidden, num_verbs))
        self.nouns_classifier = nn.Sequential(
            nn.Dropout(dropout_rate), nn.Linear(hidden, num_labels))
        #: (start, global batch) of this rank's rows (see the docstring)
        self.dropout_rows = None
        #: (model group, column slice) of the split classifiers
        self.tp = None

    def _classify(self, seq: nn.Sequential, x: torch.Tensor, train: bool,
                  generator) -> torch.Tensor:
        lin = seq[1]
        if train:
            x = dropout(x, seq[0].p, generator, self.dropout_rows)
        if self.tp is None:
            return F.linear(x, lin.weight.to(self.dtype),
                            lin.bias.to(self.dtype)).float()
        group, cols = self.tp
        out = _ClassifierShard.apply(x.reshape(-1, x.shape[-1]),
                                     lin.weight.to(self.dtype), cols, group)
        out = out + lin.bias.to(self.dtype).float()
        return out.reshape(x.shape[:-1] + (out.shape[-1],))

    def predict_verb(self, features: torch.Tensor, train: bool = False,
                     generator: torch.Generator | None = None
                     ) -> torch.Tensor:
        """features (B, D) → verb logits (B, num_verbs) f32."""
        x = torch.relu(features.to(self.dtype))
        x = self.ggsnn.propagate_verb(x)
        return self._classify(self.verb_classifier, x, train, generator)

    def predict_nouns(self, features: torch.Tensor, verb_ids: torch.Tensor,
                      role_ids: torch.Tensor, role_mask: torch.Tensor,
                      train: bool = False,
                      generator: torch.Generator | None = None
                      ) -> torch.Tensor:
        """features (B, D), verb_ids (B,) → noun logits (B, R, L) f32."""
        b = features.shape[0]
        verb_ids = verb_ids.long()
        f = features.to(self.dtype)[:, None, :]
        role_e = self.role_emb.weight[role_ids[verb_ids].long()].to(self.dtype)
        verb_e = self.verb_emb.weight[verb_ids].to(self.dtype)
        node = torch.relu(f * role_e * verb_e[:, None, :])
        out = self.ggsnn.propagate(node, role_mask[verb_ids])
        logits = self._classify(self.nouns_classifier, out, train, generator)
        return logits.reshape(b, self.max_role_count, self.num_labels)

    def predict_train(self, features: torch.Tensor, role_ids: torch.Tensor,
                      role_mask: torch.Tensor, train: bool = False,
                      generator: torch.Generator | None = None):
        """The differentiated branches of a train step: the verb branch,
        then the noun branch of its argmax verb → (pred_verb,
        pred_nouns).  The gt-verb branch is left to the caller, which runs
        it forward-only (it is logged, never backpropagated)."""
        pred_verb = self.predict_verb(features, train, generator)
        pred_verb_ids = torch.argmax(pred_verb, dim=1)
        pred_nouns = self.predict_nouns(features, pred_verb_ids, role_ids,
                                        role_mask, train, generator)
        return pred_verb, pred_nouns

    def forward(self, features: torch.Tensor, gt_verb: torch.Tensor,
                role_ids: torch.Tensor, role_mask: torch.Tensor,
                train: bool = False,
                generator: torch.Generator | None = None):
        """All three branches → (pred_verb, pred_nouns, gt_pred_nouns),
        dropout drawn in the order verb, nouns, nouns."""
        pred_verb, pred_nouns = self.predict_train(
            features, role_ids, role_mask, train, generator)
        gt_pred_nouns = self.predict_nouns(features, gt_verb, role_ids,
                                           role_mask, train, generator)
        return pred_verb, pred_nouns, gt_pred_nouns

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Random weights from ``generator``: N(0, 1) embeddings with the
        padding row zero, U(±1/sqrt(D)) dense layers (torch's defaults)."""
        with torch.no_grad():
            for emb in (self.role_emb, self.verb_emb):
                emb.weight.copy_(torch.randn(emb.weight.shape,
                                             generator=generator))
            self.role_emb.weight[-1].zero_()
        self.ggsnn.reset_parameters(generator)
        bound = 1.0 / math.sqrt(self.verb_emb.embedding_dim)
        for seq in (self.verb_classifier, self.nouns_classifier):
            _uniform_(seq[1].weight, bound, generator)
            _uniform_(seq[1].bias, bound, generator)


# -------------------------------------------------------------------- losses


def _verb_nll(pred_verb: torch.Tensor, gt_verb: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(pred_verb.float(), dim=-1)
    return -torch.gather(logp, -1, gt_verb.long()[:, None])[:, 0]


def verb_loss(pred_verb: torch.Tensor, gt_verb: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy over the batch."""
    return torch.mean(_verb_nll(pred_verb, gt_verb))


def verb_ce_term(pred_verb: torch.Tensor, gt_verb: torch.Tensor,
                 valid: torch.Tensor):
    """Masked verb CE as (numerator, denominator)."""
    nll = _verb_nll(pred_verb, gt_verb)
    return torch.sum(nll * valid), torch.sum(valid)


def verb_loss_masked(pred_verb: torch.Tensor, gt_verb: torch.Tensor,
                     valid: torch.Tensor) -> torch.Tensor:
    """``verb_loss`` over the ``valid`` rows only (pad rows of a wrapped
    batch do not count)."""
    num, den = verb_ce_term(pred_verb, gt_verb, valid)
    return num / den


def nouns_ce_terms(pred_nouns: torch.Tensor, gt_nouns: torch.Tensor,
                   ignore_index: int, row_mask: torch.Tensor | None = None):
    """Per-annotation masked CE as (numerator, denominator) pairs.
    pred_nouns (B, R, L), gt_nouns (B, 3, R)."""
    logp = torch.log_softmax(pred_nouns.float(), dim=-1)
    terms = []
    for n in range(3):
        labels = gt_nouns[:, n, :].long()
        ok = labels != ignore_index
        if row_mask is not None:
            ok = ok & row_mask
        safe = torch.where(ok, labels, torch.zeros_like(labels))
        nll = -torch.gather(logp, -1, safe[:, :, None])[:, :, 0]
        terms.append((torch.sum(torch.where(ok, nll, torch.zeros_like(nll))),
                      torch.sum(ok).float()))
    return terms


def _nouns_ce(pred_nouns, gt_nouns, ignore_index, row_mask, guard_empty):
    total = torch.zeros((), dtype=torch.float32, device=pred_nouns.device)
    for num, den in nouns_ce_terms(pred_nouns, gt_nouns, ignore_index,
                                   row_mask):
        if guard_empty:
            den = torch.clamp_min(den, 1.0)
        total = total + num / den
    return total


def nouns_loss(pred_nouns: torch.Tensor, gt_nouns: torch.Tensor,
               ignore_index: int) -> torch.Tensor:
    """Sum over the 3 annotations of the CE mean over non-ignored (batch,
    role) positions — with torch's NaN for an annotation that has no
    non-ignored position, as the reference."""
    return _nouns_ce(pred_nouns, gt_nouns, ignore_index, None, False)


def nouns_loss_masked(pred_nouns: torch.Tensor, gt_nouns: torch.Tensor,
                      ignore_index: int, valid: torch.Tensor) -> torch.Tensor:
    """``nouns_loss`` over the ``valid`` rows, with an all-ignored
    annotation's denominator guarded to 1 (0, not NaN)."""
    return _nouns_ce(pred_nouns, gt_nouns, ignore_index,
                     valid[:, None].bool(), True)
