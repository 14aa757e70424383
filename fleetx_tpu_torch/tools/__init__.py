"""Command-line entry points of the port (``python -m
fleetx_tpu_torch.tools.serve``, ``python -m fleetx_tpu_torch.tools.train``
and ``python -m fleetx_tpu_torch.tools.verify_ckpt``)."""
