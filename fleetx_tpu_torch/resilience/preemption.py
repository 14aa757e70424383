"""Graceful preemption (copy of ``fleetx_tpu/resilience/preemption.py``,
``latch`` :98-117 included).

SIGTERM/SIGINT → drain at the next step boundary.

Schedulers reclaim preemptible machines with a SIGTERM and a short grace
window; an unhandled signal kills the process mid-step. ``PreemptionHandler``
converts the signal into a flag the serving loop polls at step
boundaries: the replica stops admitting, finishes in-flight requests, and
exits with its preemption code so a supervisor treats the reclaim as a
clean stop rather than a crash loop.

Installation is main-thread-only (CPython restriction); from any other
thread the handler degrades to a warning and the run keeps the default
signal behaviour.
"""

from __future__ import annotations

import contextlib
import os
import signal
import threading
from typing import Iterable, Optional

from fleetx_tpu_torch.utils.log import logger

__all__ = ["PreemptionHandler"]

_DEFAULT_SIGNALS = ("SIGTERM", "SIGINT")


class PreemptionHandler:
    """Latching signal-to-flag bridge for graceful shutdown requests.

    ``installed()`` is a context manager scoped to one ``fit()``: previous
    handlers are restored on exit so nested engines (eval inside train,
    tests running many engines) never leak handler state.
    """

    def __init__(self, signals: Optional[Iterable[str]] = None):
        names = list(signals) if signals else list(_DEFAULT_SIGNALS)
        self._signums = [getattr(signal, n) for n in names
                         if hasattr(signal, n)]
        self._flag = threading.Event()
        self._previous: dict = {}

    # ------------------------------------------------------------- lifecycle
    def install(self) -> bool:
        """Register the handlers; False when not on the main thread."""
        try:
            for signum in self._signums:
                self._previous[signum] = signal.signal(signum, self._on_signal)
        except ValueError:  # signal only works in main thread
            self._previous.clear()
            logger.warning("preemption handler not installed (fit running "
                           "off the main thread); signals keep default "
                           "behaviour")
            return False
        return True

    def uninstall(self) -> None:
        """Restore whatever handlers were active before ``install()``."""
        for signum, prev in self._previous.items():
            try:
                signal.signal(signum, prev)
            except (ValueError, OSError):  # interpreter shutdown / odd thread
                pass
        self._previous.clear()

    @contextlib.contextmanager
    def installed(self):
        """``with handler.installed():`` — install now, restore on exit."""
        self.install()
        try:
            yield self
        finally:
            self.uninstall()

    # -------------------------------------------------------------- signal
    def _on_signal(self, signum, frame) -> None:
        # latch only: everything heavy (checkpoint I/O, device syncs) is
        # forbidden in a signal handler; the train loop does the real work
        if self._flag.is_set():
            # second signal: the step boundary never came (hung step) or
            # the operator is insisting — restore the default handlers and
            # re-deliver so Ctrl-C/SIGTERM regain their normal teeth
            logger.error("second signal %d before the graceful exit "
                         "completed — restoring default handlers", signum)
            self.uninstall()
            os.kill(os.getpid(), signum)
            return
        self._flag.set()
        logger.warning("received signal %d — requesting graceful "
                       "checkpoint-and-exit at the next step boundary "
                       "(signal again to force the default behaviour)",
                       signum)

    def latch(self, reason: str = "gang agreement") -> None:
        """Latch without a local signal — the gang propagation path.

        When the preemption vote (``loop_flags`` in the engine's fit)
        reports that ANOTHER rank received SIGTERM, every rank latches
        locally so the whole gang takes the same checkpoint-and-exit at
        the same step boundary; the local latch also keeps the
        second-signal escalation if this rank later receives its own
        signal.
        """
        if not self._flag.is_set():
            self._flag.set()
            # flight evidence from the vote path only — never from the
            # signal handler itself (the ring's lock is not signal-safe)
            from fleetx_tpu_torch.observability import flight

            flight.note("preemption", "latched", via=str(reason))
            logger.warning("preemption latched via %s — checkpoint-and-exit "
                           "at the next step boundary", reason)

    @property
    def triggered(self) -> bool:
        """True once any registered signal has been received."""
        return self._flag.is_set()
