"""The training engine of the port."""

from fleetx_tpu_torch.core.engine.eager_engine import EagerEngine  # noqa: F401
