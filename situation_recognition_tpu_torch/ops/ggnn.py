"""Gated Graph Neural Network propagation over the imSitu role graph.

Port of ``situation_recognition_tpu/ops/ggnn.py``.  The imSitu adjacency is
``A = m mᵀ - diag(m) + diag(1 - m)`` for the binary role mask ``m``, so the
reference's per-slot message passing collapses to a masked sum:

    s     = sum_j m_j h_j
    agg_i = m_i ? (s - h_i) : h_i
    n_i   = agg_i @ W_p + N * b_p        (N = max_role_count)

The constant ``N * b_p`` term (not ``degree_i * b_p``) matches the
reference, whose per-slot Linear adds its bias for masked-out slots too.
The GRU-style update:

    z  = sigmoid(n W_z + b_wz + h U_z + b_uz)
    r  = sigmoid(n W_r + b_wr + h U_r + b_ur)
    c  = tanh   (n W_h + b_wh + (r*h) U_h + b_uh)
    h' = (1-z) h + z c

Weights are (D_in, D_out) for ``x @ W``, the JAX package's layout, so that
the same arrays feed both packages; ``models.fcggnn.GGNN`` hands its
``nn.Linear`` weights over as transposed views.  ``remat=True``
recomputes each step in the backward (``torch.utils.checkpoint`` of the
step, the JAX package's ``jax.checkpoint``): the step's gate activations
are not kept across the propagate.  The folded multi-step kernel that
serves forward-only calls lives in ``ops/ggnn_kernel.py``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint


class GGNNParams(NamedTuple):
    """The 7 dense layers of the reference GGSNN, (D_in, D_out) weights."""

    w_p: torch.Tensor
    b_p: torch.Tensor
    w_z: torch.Tensor
    b_wz: torch.Tensor
    u_z: torch.Tensor
    b_uz: torch.Tensor
    w_r: torch.Tensor
    b_wr: torch.Tensor
    u_r: torch.Tensor
    b_ur: torch.Tensor
    w_h: torch.Tensor
    b_wh: torch.Tensor
    u_h: torch.Tensor
    b_uh: torch.Tensor


def _gru_update(p: GGNNParams, n: torch.Tensor,
                h: torch.Tensor) -> torch.Tensor:
    """The gated update shared by all formulations.  n, h: (..., D)."""
    z = torch.sigmoid(n @ p.w_z + p.b_wz + h @ p.u_z + p.b_uz)
    r = torch.sigmoid(n @ p.w_r + p.b_wr + h @ p.u_r + p.b_ur)
    c = torch.tanh(n @ p.w_h + p.b_wh + (r * h) @ p.u_h + p.b_uh)
    return (1.0 - z) * h + z * c


def _steps(step, h: torch.Tensor, num_steps: int,
           remat: bool) -> torch.Tensor:
    """``num_steps`` applications of ``step``, each checkpointed under
    ``remat`` when a backward can follow.  A step draws no random numbers,
    so the checkpoint keeps no RNG state: saving and restoring the card's
    reads it back to the host, a sync per step."""
    remat = remat and torch.is_grad_enabled()
    for _ in range(num_steps):
        h = (checkpoint(step, h, use_reentrant=False,
                        preserve_rng_state=False) if remat else step(h))
    return h


def ggnn_propagate(params: GGNNParams, hidden: torch.Tensor,
                   mask: torch.Tensor, num_steps: int = 4,
                   remat: bool = False) -> torch.Tensor:
    """Masked-sum propagation.  hidden (B, N, D), mask (B, N) binary."""
    mask = mask.to(hidden.dtype)[..., None]              # (B, N, 1)
    n_slots = hidden.shape[1]

    def step(h):
        s = torch.sum(mask * h, dim=1, keepdim=True)     # (B, 1, D)
        agg = torch.where(mask > 0, s - h, h)
        n = agg @ params.w_p + n_slots * params.b_p
        return _gru_update(params, n, h)

    return _steps(step, hidden, num_steps, remat)


def ggnn_propagate_dense(params: GGNNParams, hidden: torch.Tensor,
                         adjacency: torch.Tensor,
                         num_steps: int = 4) -> torch.Tensor:
    """The reference formulation with an explicit (B, N, N) adjacency
    contraction — the oracle the masked form is held against."""
    h = hidden
    n_slots = hidden.shape[1]
    adjacency = adjacency.to(hidden.dtype)
    for _ in range(num_steps):
        n = torch.einsum("bij,bjd->bid", adjacency, h) @ params.w_p \
            + n_slots * params.b_p
        h = _gru_update(params, n, h)
    return h


def ggnn_propagate_verb(params: GGNNParams, hidden: torch.Tensor,
                        num_steps: int = 4,
                        remat: bool = False) -> torch.Tensor:
    """Verb branch: single-node graphs (B, D), self-message only."""

    def step(h):
        n = h @ params.w_p + params.b_p
        return _gru_update(params, n, h)

    return _steps(step, hidden, num_steps, remat)
