"""Runtime lock sanitizer (copy of ``fleetx_tpu/observability/tsan.py``).

The dynamic half of the FX014-FX016 contract.

The static thread rules (``fleetx_tpu/lint/rules/threads.py``) prove
lock-discipline properties over the call graph; this module checks the
same properties on the *running* fleet, because a may-analysis cannot see
callables handed through queues or sockets.  Three checks, all off unless
``FLEETX_TSAN=1`` (the 2-replica kill-one drill in ``tests/test_zz_fleet.
py`` runs with it on, so CI exercises the real serving locks):

- **lock-order consistency** — every :class:`SanLock` acquisition records
  a directed edge ``outer -> inner`` in a process-global order graph; an
  acquisition that would create the reverse edge of one already observed
  raises :class:`LockOrderError` with both acquisition stacks (the dynamic
  FX015).  Edges are keyed by lock *name*, so two Router instances share
  one ordering discipline.
- **acquisition stacks** — per-thread, per-lock capture of where each held
  lock was taken, so a deadlock post-mortem names both sites.
- **cross-thread access flagging** — objects registered with
  :func:`register_object` remember their owning thread; a
  :func:`note_access` checkpoint from any other thread while no sanitized
  lock is held records a violation (the dynamic FX014).  Violations are
  collected, not raised: benign handoffs exist and the drill asserts on
  the list.

Zero overhead when disabled: :func:`lock` returns a plain
``threading.Lock`` and the checkpoints are early-return no-ops.  The
module is stdlib-only — the serving fleet imports it, and the serving
fleet must stay importable without jax.
"""

from __future__ import annotations

import os
import threading
import traceback
from typing import Dict, List, Optional, Tuple

__all__ = ["enabled", "lock", "SanLock", "LockOrderError",
           "register_object", "note_access", "violations", "reset"]


def enabled() -> bool:
    """Whether the sanitizer is armed (``FLEETX_TSAN=1``)."""
    return os.environ.get("FLEETX_TSAN", "") == "1"


class LockOrderError(AssertionError):
    """Two SanLocks were acquired in opposite orders (ABBA deadlock)."""


# -- process-global sanitizer state (guarded by a plain lock: the
# sanitizer must not sanitize itself) -----------------------------------
_state_lock = threading.Lock()
_order: Dict[Tuple[str, str], str] = {}      # (outer, inner) -> stack
_violations: List[str] = []
_objects: Dict[int, Tuple[str, int]] = {}    # id(obj) -> (label, owner tid)
_tls = threading.local()                     # .held: list[(name, stack)]


def _held() -> list:
    held = getattr(_tls, "held", None)
    if held is None:
        held = _tls.held = []
    return held


def _stack(skip: int = 2) -> str:
    return "".join(traceback.format_stack()[:-skip][-4:])


class SanLock:
    """Instrumented ``threading.Lock``: records per-thread acquisition
    stacks and asserts one globally consistent acquisition order."""

    def __init__(self, name: str):
        self.name = name
        self._inner = threading.Lock()

    def acquire(self, blocking: bool = True,
                timeout: float = -1) -> bool:
        """``threading.Lock.acquire`` plus order/stack bookkeeping."""
        got = self._inner.acquire(blocking, timeout)
        if got:
            try:
                self._note_acquired()
            except LockOrderError:
                self._inner.release()  # don't leak the lock on the assert
                raise
        return got

    def release(self) -> None:
        """Release and pop this lock from the caller's held stack."""
        held = _held()
        for i in range(len(held) - 1, -1, -1):
            if held[i][0] == self.name:
                del held[i]
                break
        self._inner.release()

    def __enter__(self) -> "SanLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def _note_acquired(self) -> None:
        stack = _stack(skip=3)
        held = _held()
        with _state_lock:
            for outer, outer_stack in held:
                if outer == self.name:
                    continue  # re-acquisition through an RLock-ish path
                rev = _order.get((self.name, outer))
                if rev is not None:
                    msg = (f"lock-order inversion: '{self.name}' acquired "
                           f"while '{outer}' is held at\n{stack}\nbut the "
                           f"opposite order was taken at\n{rev}")
                    _violations.append(msg)
                    raise LockOrderError(msg)
                _order.setdefault((outer, self.name), stack)
        held.append((self.name, stack))


def lock(name: str):
    """Lock factory the serving fleet uses: a :class:`SanLock` when the
    sanitizer is armed, a plain ``threading.Lock`` otherwise."""
    return SanLock(name) if enabled() else threading.Lock()


def register_object(obj: object, label: str,
                    owner: Optional[int] = None) -> None:
    """Declare ``obj`` as owned by one thread (default: the caller's).
    Later :func:`note_access` checkpoints from other threads, taken while
    no sanitized lock is held, record a cross-thread-access violation."""
    if not enabled():
        return
    with _state_lock:
        _objects[id(obj)] = (label, owner if owner is not None
                             else threading.get_ident())


def note_access(obj: object, what: str = "") -> None:
    """Checkpoint: the caller is touching ``obj``'s mutable state."""
    if not enabled():
        return
    if _held():
        return  # under a sanitized lock: the discipline is being followed
    tid = threading.get_ident()
    with _state_lock:
        entry = _objects.get(id(obj))
        if entry is None or entry[1] == tid:
            return
        label, owner = entry
        _violations.append(
            f"cross-thread access on '{label}'"
            f"{f' ({what})' if what else ''}: owned by thread {owner}, "
            f"touched by {threading.current_thread().name} ({tid}) with "
            f"no sanitized lock held at\n{_stack()}")


def violations() -> List[str]:
    """Snapshot of every violation recorded so far in this process."""
    with _state_lock:
        return list(_violations)


def reset() -> None:
    """Clear all sanitizer state (tests)."""
    with _state_lock:
        _order.clear()
        _violations.clear()
        _objects.clear()
    _tls.held = []
