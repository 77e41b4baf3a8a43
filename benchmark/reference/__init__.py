"""The benchmark's plain reference: the backbones, FCGGNN, the masked
losses, the clip and Adamax in plain PyTorch, float32 with TF32 off.

``nets.py`` holds what the networks share (the rounding, the linear layer,
the device transform, the head and its losses); each backbone kind is a
file of its own, ``backbones/<kind>.py``, found by the configuration's
``backbone.kind``; ``train.py`` runs the training steps.

It imports nothing of the measured program and nothing of JAX: every
table it needs (the role tables, the resize weights) it derives again from
the inputs the benchmark hands it.
"""
