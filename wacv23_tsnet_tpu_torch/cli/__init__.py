"""Command-line entry points of the port (`python -m
wacv23_tsnet_tpu_torch.cli.serve`)."""
