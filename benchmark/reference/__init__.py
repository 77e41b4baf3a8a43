"""The benchmark's plain reference: ResNet, ViT, FCGGNN, the masked losses,
the clip and Adamax in plain PyTorch, float32 with TF32 off.

It imports nothing of the measured program and nothing of JAX: every
table it needs (the role tables, the resize weights) it derives again from
the inputs the benchmark hands it.
"""
