"""Command-line entry points of the port (``python -m
fleetx_tpu_torch.tools.serve`` and ``python -m
fleetx_tpu_torch.tools.train``)."""
