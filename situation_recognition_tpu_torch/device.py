"""Device resolution for the port's entry points.

The port targets the card: ``None`` means ``cuda``.  The CPU is used only
when a caller asks for it by name (the tests do), and a ``cuda`` request on
a machine without a card raises instead of carrying on quietly on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None``/``"cuda"``/``"cuda:N"``/``"cpu"``/``torch.device`` → a
    ``torch.device`` that exists on this machine, or ``RuntimeError``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU explicitly")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
