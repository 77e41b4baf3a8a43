"""The port's command-line tools, each run as
``python -m situation_recognition_tpu_torch.tools.<name>``."""
