"""The backbones of the plain reference, one file a kind: the
configuration's ``backbone.kind`` names ``reference/backbones/<kind>.py``.

Each file is plain PyTorch (float32, TF32 off) and imports nothing of the
measured program or of JAX.  It exposes

* ``leaves(cfg) -> [(name, shape, (init, arg))]``: the backbone's
  parameters and buffers in draw order, under the port module's
  state-dict names (``init``: ``normal`` or ``uniform`` with a scale,
  ``const`` with a value, ``count`` for an integer buffer);
* ``features(cfg, sd, x_nhwc, p) -> (B, D)``: the pooled features of a
  transformed batch, from a state dict of those names, every activation
  through the ``nets.Precision`` ``p``; its shape keys and ``remat`` read
  from ``cfg["backbone"]``.  It runs on meta tensors too, as
  ``work.step_flops`` counts it.
"""

from __future__ import annotations

import importlib


def of(cfg: dict):
    """The backbone file of ``cfg``'s ``backbone.kind``."""
    return importlib.import_module(__name__ + "." + cfg["backbone"]["kind"])
