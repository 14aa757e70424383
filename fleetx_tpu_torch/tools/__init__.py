"""Command-line entry points of the port (``python -m
fleetx_tpu_torch.tools.serve``)."""
