"""situation_recognition_tpu_torch — the PyTorch + CUDA port of
``situation_recognition_tpu`` for NVIDIA Hopper (H100).

The layout mirrors the JAX package module for module, so each file has a
counterpart to be held against:

* ``data``     — vocabulary encoder tables and image transforms.
* ``ops``      — GGNN propagation: the masked-sum math and the folded
                 multi-step kernel (CUDA, ``csrc/ggnn_folded.cu``) with its
                 plain PyTorch twin.
* ``models``   — the ResNet v1.5 backbone and the FCGGNN head.
* ``convert``  — JAX parameter trees and reference checkpoints → this
                 package's state dicts.
* ``serving``  — export → load → ``fn(images_u8)`` artifacts.
* ``server``   — dynamic micro-batching and the HTTP face.

The package imports ``torch`` and never ``jax``.  Entry points run on
``cuda`` unless the caller passes ``device="cpu"``; without a card and
without that request they raise (``device.resolve_device``).
"""

__version__ = "0.1.0"
