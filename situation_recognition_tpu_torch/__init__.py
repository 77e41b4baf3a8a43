"""situation_recognition_tpu_torch — the PyTorch + CUDA port of
``situation_recognition_tpu`` for NVIDIA Hopper (H100).

The layout mirrors the JAX package module for module, so each file has a
counterpart to be held against:

* ``data``     — vocabulary encoder tables and image transforms.
* ``ops``      — GGNN propagation: the masked-sum math, the folded
                 multi-step kernels in CUDA (``csrc/ggnn_folded.cu``: K1
                 forward and K2 forward with residuals;
                 ``csrc/ggnn_folded_bwd.cu``: K3 backward) with their plain
                 PyTorch twins, and the K2/K3 autograd Function; the ViT
                 encoder block's kernels (``csrc/vit_block.cu``: K4 and
                 K6; ``csrc/vit_attention.cu``: K5/K7) with their twins
                 (``ops/vit.py``) and encoder paths (``ops/vit_kernel.py``).
* ``models``   — the ResNet v1.5 backbone (eval- and train-mode BN), the
                 ViT backbones (``vit_l14``, ``vit_l14_clip``, ``vit_b16``,
                 ``vit_tiny``), ``build_backbone``, and the FCGGNN head
                 with its losses.
* ``metrics``  — the imSitu scorer.
* ``train``    — ``Trainer``: train and eval steps, ``train_epoch``,
                 ``evaluate``.
* ``convert``  — JAX parameter trees and reference checkpoints → this
                 package's state dicts, and back for comparisons.
* ``serving``  — export → load → ``fn(images_u8)`` artifacts.
* ``server``   — dynamic micro-batching and the HTTP face.

The package imports ``torch`` and never ``jax``.  Entry points run on
``cuda`` unless the caller passes ``device="cpu"``; without a card and
without that request they raise (``device.resolve_device``).
"""

__version__ = "0.1.0"
