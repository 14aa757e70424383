"""Command-line entry points of the port (``python -m
fleetx_tpu_torch.tools.<name>``): ``serve``, ``train``, ``verify_ckpt``,
``eval``, ``export``, ``inference`` and ``preprocess_data``."""
