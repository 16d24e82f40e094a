"""Runnable examples of the port (``python -m
distkeras_tpu_torch.examples.<name>``)."""
