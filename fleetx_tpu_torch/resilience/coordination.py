"""Agreement primitives of the resilience runtime, for one process (port of
``fleetx_tpu/resilience/coordination.py``: ``configure`` :58,
``CoordinationTimeout`` :67, ``most_severe`` :87, ``LocalCoordinator``
:102-129 and ``get_coordinator`` :343).

The JAX engine routes every recovery decision (the resume step, the
guard's verdict, the rollback step, the stream-dry flag) through a
coordinator, so a gang of processes takes each decision together. The
port trains in one process: its coordinator is the world-1 one, whose
``barrier`` / ``broadcast`` / ``all_gather`` / ``any_flag`` are local
and return this process's own value. The fit loop
still calls them where the JAX loop does, so a coordinator over
``torch.distributed.TCPStore`` can take its place with the multi-process
trainer (ROADMAP.md, port queue item 12). ``configure`` keeps the
``Resilience.coordination`` deadlines that such a coordinator will read.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Optional

__all__ = ["CoordinationTimeout", "LocalCoordinator", "get_coordinator",
           "configure", "most_severe", "DEFAULT_TIMEOUT_S"]

#: default agreement deadline — generous enough to ride out a checkpoint
#: restore on the slowest rank
DEFAULT_TIMEOUT_S = 600.0
_DEFAULT_POLL_S = 0.05

_timeout_s = DEFAULT_TIMEOUT_S
_poll_s = _DEFAULT_POLL_S


def configure(timeout_s: Optional[float] = None,
              poll_s: Optional[float] = None) -> None:
    """Set module-wide agreement defaults from ``Resilience.coordination``
    (None resets a knob to its built-in default)."""
    global _timeout_s, _poll_s
    _timeout_s = DEFAULT_TIMEOUT_S if timeout_s is None else float(timeout_s)
    _poll_s = _DEFAULT_POLL_S if poll_s is None else float(poll_s)


class CoordinationTimeout(RuntimeError):
    """An agreement deadline expired — carries the arrival census
    (``arrived`` / ``missing`` rank sets)."""

    def __init__(self, name: str, arrived: Iterable[int],
                 missing: Iterable[int], timeout_s: float):
        self.name = name
        self.arrived = sorted(arrived)
        self.missing = sorted(missing)
        self.timeout_s = timeout_s
        super().__init__(
            f"coordination '{name}' timed out after {timeout_s:.1f}s: "
            f"arrived ranks {self.arrived}, missing ranks {self.missing}")


def most_severe(decisions: Iterable[Optional[str]]) -> Optional[str]:
    """Combine per-rank guard decisions into the gang's decision.

    Severity: ``None`` (healthy/tolerated) < ``"rollback"`` < ``"abort"``
    — any rank's rollback rolls everyone back, any abort aborts everyone.
    """
    rank = {None: 0, "rollback": 1, "abort": 2}
    worst = None
    for d in decisions:
        if rank.get(d, 0) > rank.get(worst, 0):
            worst = d
    return worst


class LocalCoordinator:
    """The world-1 coordinator: every agreement is this process's own
    value."""

    rank = 0
    world = 1

    def barrier(self, name: str, timeout_s: Optional[float] = None) -> None:
        """Trivially satisfied with one process."""

    def broadcast(self, name: str, value: Any = None,
                  timeout_s: Optional[float] = None) -> Any:
        """Rank 0 is the only rank: its value is the agreement."""
        return value

    def any_flag(self, name: str, flag: bool,
                 timeout_s: Optional[float] = None) -> bool:
        """OR over one rank."""
        return bool(flag)

    def all_gather(self, name: str, value: Any = None,
                   timeout_s: Optional[float] = None) -> Dict[int, Any]:
        """One-entry census."""
        return {0: value}


_coordinator: Optional[LocalCoordinator] = None


def get_coordinator() -> LocalCoordinator:
    """The process-wide coordinator (built on first use): the world-1 one
    until the multi-process trainer brings a store-backed coordinator."""
    global _coordinator
    if _coordinator is None:
        _coordinator = LocalCoordinator()
    return _coordinator
