"""The ``Serving.router`` block's schema (copy of
``fleetx_tpu/serving/router.py:84-128``).

The router process itself is not ported yet (ROADMAP.md, port queue
item 5); the serving slice only validates the block, because the shipped
recipe carries one.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class RouterConfig:
    """The ``Serving.router`` YAML block, eagerly validated."""

    penalty_s: float = 1.0
    dispatch_deadline_s: float = 120.0
    verb_timeout_s: float = 10.0
    request_timeout_s: float = 120.0
    hedge_ms: float = 250.0
    retry_budget: int = 8
    probe_interval_s: float = 0.25
    breaker_threshold: int = 1

    def __post_init__(self):
        for key in ("penalty_s", "dispatch_deadline_s", "verb_timeout_s",
                    "request_timeout_s", "probe_interval_s"):
            if not float(getattr(self, key)) > 0:
                raise ValueError(f"Serving.router.{key} must be > 0")
        if not float(self.hedge_ms) >= 0:
            raise ValueError(
                "Serving.router.hedge_ms must be >= 0 (0 disables hedging)")
        for key in ("retry_budget", "breaker_threshold"):
            if not int(getattr(self, key)) >= 1:
                raise ValueError(f"Serving.router.{key} must be >= 1")

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "RouterConfig":
        """Build from the YAML block (unknown keys rejected eagerly)."""
        d = dict(d or {})
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(
                f"unknown Serving.router keys: {sorted(unknown)}")
        return cls(**{k: v for k, v in d.items() if v is not None})
