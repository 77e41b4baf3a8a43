"""The benchmark's counts of the Swin window-attention pair's work: the
operations and bytes of one launch of ``swin_wattn_fwd_kernel`` or of
``swin_wattn_bwd_kernel`` with ``swin_wattn_dbias_kernel``, and of a
train step's launches, for the ``wattn_*_roofline`` readers.

As in ``work.py``, a launch's least time is the larger of its operations
over the card's bf16 peak and its bytes over the HBM bandwidth, each
input byte read once and each output byte written once.  Over B·nW windows
of N tokens in h heads of width dh (C = h·dh):

* forward: q·kᵀ and p·v, 4·B·nW·h·N²·dh operations; qkv (B·nW·N, 3C)
  bf16 read and the context (B·nW·N, C) bf16 written;
* backward: q·kᵀ again, dO·vᵀ, pᵀ·dO, dS·k and dSᵀ·q, 10·B·nW·h·N²·dh
  operations; qkv and the context's cotangent dO read, dqkv (B·nW·N, 3C)
  written.  The pair takes no context and saves no row statistics: it
  recomputes each row's softmax whole (a window is one tile) and takes
  Σ P∘dP for Σ dO∘O;
* both: the bias (h, N, N) f32 read once, and the mask (nW, N, N) f32
  read once where the block is shifted; the backward writes dbias (h, N,
  N) f32 once.
"""

from __future__ import annotations

import work


def window_work(batch: int, windows: int, heads: int, n: int, dh: int,
                masked: bool, backward: bool) -> tuple:
    """(operations, bytes) of one launch over ``batch`` images of
    ``windows`` windows of ``n`` tokens, ``heads`` heads of width
    ``dh``."""
    bw = batch * windows
    per = bw * heads * n * n * dh
    row = bw * n * heads * dh * 2           # one bf16 (B·nW·N, C) matrix
    consts = heads * n * n * 4 + (windows * n * n * 4 if masked else 0)
    if backward:
        return 10 * per, 3 * row + row + 3 * row + consts + heads * n * n * 4
    return 4 * per, 3 * row + row + consts


def blocks(cfg: dict) -> list:
    """(windows an image, heads, tokens a window, head width, shifted) of
    each block of a ``swin`` configuration, in order: a stage whose map is
    no larger than the window takes the whole map and never shifts."""
    b = cfg["backbone"]
    res, dim = cfg["image"]["crop"] // b["patch"], b["embed"]
    out = []
    for depth, heads in zip(b["depths"], b["heads"]):
        window, shift = b["window"], True
        if res <= window:
            window, shift = res, False
        for j in range(depth):
            out.append(((res // window) ** 2, heads, window * window,
                        dim // heads, shift and j % 2 == 1))
        res, dim = res // 2, dim * 2
    return out


def launches_a_step(cfg: dict, backward: bool) -> int:
    """Launches of one kernel of the pair a train step: one a block, the
    forward twice under remat."""
    twice = cfg["backbone"].get("remat", False) and not backward
    return len(blocks(cfg)) * (2 if twice else 1)


def step_least_ms(cfg: dict, batch: int, peak_flops: float,
                  peak_bytes: float, backward: bool) -> float:
    """The least time of a train step's launches of the forward (every
    block, twice under remat) or of the backward (every block once), in
    ms."""
    per_block = sum(work.least_ms(*window_work(batch, *blk, backward),
                                  peak_flops, peak_bytes)[0]
                    for blk in blocks(cfg))
    return per_block * launches_a_step(cfg, backward) / len(blocks(cfg))
