"""Task entry points of the port (``python -m
fleetx_tpu_torch.tasks.gpt.generation`` and ``.inference``)."""
