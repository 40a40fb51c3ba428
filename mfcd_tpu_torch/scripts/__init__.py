"""Command-line tools of the port, run as ``python3 -m
mfcd_tpu_torch.scripts.<name>``."""
