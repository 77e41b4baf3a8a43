"""``python -m situation_recognition_tpu_torch``: the CLI (``cli.py``)."""

from situation_recognition_tpu_torch.cli import main

main()
