"""Measurement tools of the port (run as ``python -m
velocycle_tpu_torch.tools.<name>``)."""
