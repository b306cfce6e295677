"""Measurement and driving scripts for the card, run as ``python -m snappy_tpu_torch.tools.<name>``."""
