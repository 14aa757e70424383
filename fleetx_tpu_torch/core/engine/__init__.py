"""The training engines of the port."""

from fleetx_tpu_torch.core.engine.auto_engine import AutoEngine  # noqa: F401
from fleetx_tpu_torch.core.engine.basic_engine import BasicEngine  # noqa: F401
from fleetx_tpu_torch.core.engine.eager_engine import EagerEngine  # noqa: F401
