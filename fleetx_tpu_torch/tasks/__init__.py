"""Task entry points of the port (``python -m
fleetx_tpu_torch.tasks.gpt.generation``, ``.gpt.inference`` and
``.imagen.generate``)."""
