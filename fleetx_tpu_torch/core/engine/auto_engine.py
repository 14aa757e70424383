"""``AutoEngine``: the name of the reference's auto-parallel engine (port
of ``fleetx_tpu/core/engine/auto_engine.py``).

The JAX ``AutoEngine`` subclasses ``EagerEngine`` unchanged, and so does
this one. As in the JAX package, ``tools/auto.py`` builds the
``EagerEngine``: what the auto entry point adds is the layout planner
(``parallel/auto_layout.py``), which runs in the config loader.
"""

from __future__ import annotations

from fleetx_tpu_torch.core.engine.eager_engine import EagerEngine


class AutoEngine(EagerEngine):
    """``EagerEngine`` under the reference's auto-parallel name."""
