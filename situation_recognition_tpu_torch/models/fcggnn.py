"""FCGGNN situation-recognition head: embeddings + GGNN + classifiers.

Port of ``situation_recognition_tpu/models/fcggnn.py``.  Module names are
the reference FCGGNN's (``role_emb``, ``verb_emb``, ``ggsnn.W_p`` ...,
``verb_classifier.1``, ``nouns_classifier.1``), so the head's state dict
is the reference ``model_state_dict`` without its two backbone copies.

Semantics kept from the JAX head: node init ``relu(f * role_emb *
verb_emb)``, relu on the features only in the verb branch, 4 GGNN steps,
Dropout(0.5) before each classifier (inert in eval mode), and the
``role_emb`` padding row fixed at zero.  ``dtype`` is the compute type:
parameters stay f32 and are cast at each use, as flax does.

GGNN implementations (``resolve_ggnn_impl``): ``kernel`` runs every
propagate through the folded multi-step kernel (``ops/ggnn_kernel.py``,
bf16 inside), ``masked`` runs the masked-sum math of ``ops/ggnn.py`` in
``dtype``.  ``auto`` picks the kernel on a CUDA device at bf16, as the JAX
trainer picks its Pallas kernel on a TPU at bf16.  The kernel path is
forward-only; losses and gradients come with the training slice.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from situation_recognition_tpu_torch.ops.ggnn import (
    GGNNParams, ggnn_propagate, ggnn_propagate_verb)
from situation_recognition_tpu_torch.ops.ggnn_kernel import (
    fold_gate_weights, ggnn_propagate_folded)

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

    def _kernel(self, hidden, mask):
        if torch.is_grad_enabled() and any(
                p.requires_grad for p in self.parameters()):
            raise RuntimeError("the folded GGNN kernel is forward-only; run "
                               "it under torch.no_grad() or "
                               "torch.inference_mode()")
        r = hidden.shape[1]
        return ggnn_propagate_folded(None, hidden, mask, self.num_steps,
                                     weights=self.folded(float(r)))

    def propagate(self, hidden: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
        """hidden (B, R, D), mask (B, R) → (B, R, D)."""
        hidden = hidden.to(self.dtype)
        if self.impl == "kernel":
            return self._kernel(hidden, mask)
        return ggnn_propagate(self.params(), hidden, mask, self.num_steps)

    def propagate_verb(self, hidden: torch.Tensor) -> torch.Tensor:
        """hidden (B, D) single-node graphs → (B, D).  Through the kernel
        as r=1 with mask 0: every node self-messages (E = I)."""
        hidden = hidden.to(self.dtype)
        if self.impl == "kernel":
            zeros = torch.zeros(hidden.shape[0], 1, dtype=torch.float32,
                                device=hidden.device)
            return self._kernel(hidden[:, None, :], zeros)[:, 0, :]
        return ggnn_propagate_verb(self.params(), hidden, self.num_steps)

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

    def _classify(self, seq: nn.Sequential, x: torch.Tensor) -> torch.Tensor:
        lin = seq[1]
        x = seq[0](x)
        return F.linear(x, lin.weight.to(self.dtype),
                        lin.bias.to(self.dtype)).float()

    def predict_verb(self, features: torch.Tensor) -> torch.Tensor:
        """features (B, D) → verb logits (B, num_verbs) f32."""
        x = torch.relu(features.to(self.dtype))
        x = self.ggsnn.propagate_verb(x)
        return self._classify(self.verb_classifier, x)

    def predict_nouns(self, features: torch.Tensor, verb_ids: torch.Tensor,
                      role_ids: torch.Tensor,
                      role_mask: torch.Tensor) -> torch.Tensor:
        """features (B, D), verb_ids (B,) → noun logits (B, R, L) f32."""
        b = features.shape[0]
        verb_ids = verb_ids.long()
        f = features.to(self.dtype)[:, None, :]
        role_e = self.role_emb.weight[role_ids[verb_ids].long()].to(self.dtype)
        verb_e = self.verb_emb.weight[verb_ids].to(self.dtype)
        node = torch.relu(f * role_e * verb_e[:, None, :])
        out = self.ggsnn.propagate(node, role_mask[verb_ids])
        logits = self._classify(self.nouns_classifier, out)
        return logits.reshape(b, self.max_role_count, self.num_labels)

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
