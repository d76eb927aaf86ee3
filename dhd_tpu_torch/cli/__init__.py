"""Command-line entry points of the port (``python -m
dhd_tpu_torch.cli.<name>``)."""
