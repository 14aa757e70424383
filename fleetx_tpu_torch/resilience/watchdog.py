"""Step watchdog: detect a hung step, dump stacks, flush telemetry (port
of ``fleetx_tpu/resilience/watchdog.py``: ``StepWatchdog`` :63-226,
``GangWatchdog`` :207-277).

A deadlocked collective, a wedged host-to-device transfer or a stuck data
producer leaves the train loop silent forever — the run *looks* alive to
the scheduler while burning its reservation. ``StepWatchdog`` runs a
daemon heartbeat thread: the train loop calls ``beat()`` once per step,
and once armed by the FIRST beat (so the first step's XLA compile, however
long, can never false-positive), a silence of ``stall_factor ×`` the
median step time — floored at ``min_timeout_s`` to ride out restores and
mid-run re-compiles — makes the watchdog

1. logs every Python thread's stack (the post-mortem a hung run normally
   never produces),
2. flushes the observability sinks so the last telemetry window is
   durable,
3. bumps ``watchdog_stalls``, and
4. optionally aborts the process (``action: abort``, exit code 43) so a
   supervisor restarts from the last checkpoint.

The median step time comes from the telemetry registry's ``step_time``
histogram when populated (the engine records it every logging window) and
falls back to the watchdog's own observed beat intervals before the first
window closes. "The first step's XLA compile" below is, in the port, the
first step's kernel builds and CUDA warm-up.

The gang mode (``GangWatchdog``): a timed barrier every
``gang_sync_steps`` steps over the gang's store (never over a gloo or
NCCL collective, so a wedged collective cannot hide the census), whose
timeout names the straggler ranks in the log and the flight ring;
``action: abort`` then exits with 43 so the supervisor restarts the gang.
"""

from __future__ import annotations

import contextlib
import os
import sys
import threading
import time
import traceback
from collections import deque
from typing import Callable, Optional

from fleetx_tpu_torch.observability.metrics import get_registry
from fleetx_tpu_torch.utils.log import logger

__all__ = ["StepWatchdog", "GangWatchdog", "ABORT_EXIT_CODE"]

#: distinct from fault-injection's 17 so supervisors can tell them apart
ABORT_EXIT_CODE = 43


def _format_all_stacks() -> str:
    """Every thread's current Python stack, hung-run post-mortem style."""
    names = {t.ident: t.name for t in threading.enumerate()}
    chunks = []
    for ident, frame in sys._current_frames().items():
        name = names.get(ident, "?")
        stack = "".join(traceback.format_stack(frame))
        chunks.append(f"--- thread {name} ({ident}) ---\n{stack}")
    return "\n".join(chunks)


class StepWatchdog:
    """Heartbeat monitor for the train loop (daemon thread).

    One instance per ``fit()``: ``start()`` arms it, ``beat(step)`` feeds
    it, ``stop()`` joins it. Re-arming after a fired stall requires a new
    beat, so a genuinely hung run logs once instead of every poll.
    """

    def __init__(self, stall_factor: float = 10.0,
                 min_timeout_s: float = 60.0,
                 poll_s: float = 1.0,
                 action: str = "log",
                 on_stall: Optional[Callable[[], None]] = None,
                 registry=None):
        assert action in ("log", "abort"), action
        self.stall_factor = float(stall_factor)
        self.min_timeout_s = float(min_timeout_s)
        self.poll_s = float(poll_s)
        self.action = action
        self.on_stall = on_stall
        self.registry = registry or get_registry()
        self._beats: deque = deque(maxlen=64)  # own fallback intervals
        self._last_beat: Optional[float] = None
        self._last_step = -1
        self._fired_for: Optional[float] = None
        self._suspended = 0  # depth-counted: nested suspended() blocks
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @classmethod
    def from_cfg(cls, cfg: Optional[dict],
                 on_stall: Optional[Callable[[], None]] = None,
                 registry=None) -> "StepWatchdog":
        """Build from a ``Resilience.watchdog`` config block."""
        cfg = dict(cfg or {})
        return cls(
            stall_factor=float(cfg.get("stall_factor") or 10.0),
            min_timeout_s=float(60.0 if cfg.get("min_timeout_s") is None
                                else cfg.get("min_timeout_s")),
            poll_s=float(cfg.get("poll_s") or 1.0),
            action=str(cfg.get("action") or "log"),
            on_stall=on_stall, registry=registry)

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "StepWatchdog":
        """Start the heartbeat thread (idempotent).

        The detector stays UNARMED until the first ``beat()``: the first
        train step includes XLA compilation (often minutes for a large
        model), and a clock running from ``start()`` would fire a false
        stall — and under ``action: abort`` kill a healthy run — before
        the loop ever had a chance to beat.
        """
        if self._thread is not None:
            return self
        self._stop.clear()
        self._last_beat = None  # armed by the first beat
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="fleetx-watchdog")
        self._thread.start()
        return self

    def stop(self) -> None:
        """Disarm and join the heartbeat thread (idempotent)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def beat(self, step: int) -> None:
        """Train loop progress signal — call once per completed step."""
        now = time.monotonic()
        if self._last_beat is not None:
            self._beats.append(now - self._last_beat)
        self._last_beat = now  # fleetx: noqa[FX014] -- deliberate lock-free protocol: monitor-thread reads tolerate one stale beat (next poll sees it); a beat()-side lock would put lock traffic on every train step
        self._last_step = step  # fleetx: noqa[FX014] -- same lock-free beat protocol: _run only formats _last_step into the stall report, staleness is cosmetic
        self._fired_for = None  # re-arm after any progress  # fleetx: noqa[FX014] -- same lock-free beat protocol: worst case is one duplicate or suppressed stall report, never a missed wedge (the beat gap keeps growing)

    @contextlib.contextmanager
    def suspended(self):
        """Disarm around a known-long host phase (eval, checkpoint write,
        rollback restore): the phase is legitimate progress-free time a
        post-phase beat can't retroactively excuse — the detector would
        already have fired (and under ``action: abort``, killed the run)
        mid-phase. The clock restarts when the phase ends."""
        self._suspended += 1  # fleetx: noqa[FX014] -- suspended() only runs on the train-loop thread (re-entrant phases nest, hence a counter not a flag); the monitor thread only reads, and a stale read just delays the disarm by one poll
        try:
            yield self
        finally:
            # restart the silence clock BEFORE re-arming: the poll thread
            # must never observe an unsuspended watchdog that still
            # carries the stale pre-phase beat (that ordering race is a
            # false stall). The phase is deliberately NOT recorded as a
            # step interval — it would inflate the median.
            self._last_beat = time.monotonic()
            self._fired_for = None
            self._suspended -= 1

    # ------------------------------------------------------------ internals
    def _median_step_s(self) -> Optional[float]:
        hist = self.registry.histogram("step_time")
        p50 = hist.quantile(0.5)
        if p50:
            return p50
        if self._beats:
            xs = sorted(self._beats)
            return xs[len(xs) // 2]
        return None

    def timeout_s(self) -> float:
        """Current stall threshold in seconds."""
        median = self._median_step_s()
        if median is None:
            return self.min_timeout_s
        return max(self.stall_factor * median, self.min_timeout_s)

    def _run(self) -> None:
        while not self._stop.wait(self.poll_s):
            # order matters: check suspension BEFORE sampling the beat.
            # suspended() refreshes the beat and only then decrements, so
            # a poll that observes _suspended == 0 is guaranteed to read
            # the post-phase beat — the reverse order could pair a stale
            # pre-phase beat with an already-lifted suspension and fire a
            # false stall
            if self._suspended:
                continue
            last = self._last_beat
            if last is None or self._fired_for == last:
                continue
            silent = time.monotonic() - last
            limit = self.timeout_s()
            if silent <= limit:
                continue
            self._fired_for = last  # once per stall episode
            self.registry.counter("watchdog_stalls").inc()
            logger.error(
                "watchdog: no step progress for %.1fs (limit %.1fs, last "
                "step %d) — dumping stacks\n%s", silent, limit,
                self._last_step, _format_all_stacks())
            if self.on_stall is not None:
                try:
                    self.on_stall()
                except Exception as e:  # noqa: BLE001 — flush must not kill us
                    logger.warning("watchdog on_stall callback failed: %s", e)
            if self.action == "abort":
                logger.error("watchdog: aborting process (exit %d)",
                             ABORT_EXIT_CODE)
                os._exit(ABORT_EXIT_CODE)


class GangWatchdog:
    """Distributed hang detector: a timed gang barrier every K steps.

    The per-process :class:`StepWatchdog` sees a silent train loop but
    cannot say WHO wedged the collective — on a gang, every healthy rank's
    watchdog fires identically while the one hung rank says nothing. This
    runs ``coordination.barrier`` on the train-loop thread every
    ``sync_steps`` steps: when it times out, the raised
    ``CoordinationTimeout`` carries the arrival census, so the log names
    the exact straggler set (the missing ranks) next to this rank's own
    stack dump. ``action: abort`` then exits with the watchdog code (43)
    so a gang supervisor tears the survivors down and restarts from the
    last checkpoint.

    ``check()`` is a collective: every rank must call it once per step
    (the internal call counter, not the step, selects barrier rounds so
    all ranks agree on which calls rendezvous).
    """

    def __init__(self, coord, sync_steps: int, timeout_s: float = 300.0,
                 action: str = "log", registry=None):
        assert action in ("log", "abort"), action
        self.coord = coord
        self.sync_steps = max(int(sync_steps), 1)
        self.timeout_s = float(timeout_s)
        self.action = action
        self.registry = registry or get_registry()
        self._calls = 0

    @classmethod
    def from_cfg(cls, cfg: Optional[dict], coord, registry=None
                 ) -> Optional["GangWatchdog"]:
        """Build from a ``Resilience.watchdog`` block, or None when the
        gang mode is off (``gang_sync_steps`` unset/0) or the gang has a
        single member (nothing to rendezvous with)."""
        cfg = dict(cfg or {})
        sync_steps = int(cfg.get("gang_sync_steps") or 0)
        if sync_steps < 1 or getattr(coord, "world", 1) < 2:
            return None
        return cls(coord, sync_steps,
                   timeout_s=float(cfg.get("gang_timeout_s") or 300.0),
                   action=str(cfg.get("action") or "log"),
                   registry=registry)

    def check(self, step: int) -> None:
        """Rendezvous round (every ``sync_steps``-th call); on timeout log
        the straggler set + this rank's stacks, then log or abort."""
        from fleetx_tpu_torch.observability import flight
        from fleetx_tpu_torch.resilience.coordination import \
            CoordinationTimeout

        self._calls += 1
        if self._calls % self.sync_steps:
            return
        try:
            self.coord.barrier("gang_watchdog", timeout_s=self.timeout_s)
        except CoordinationTimeout as e:
            self.registry.counter("watchdog_gang_stalls").inc()
            logger.error(
                "gang watchdog: barrier at step %d timed out after %.1fs — "
                "straggler ranks %s (arrived: %s); dumping local stacks\n%s",
                step, self.timeout_s, e.missing, e.arrived,
                _format_all_stacks())
            # the flight ring is this rank's half of the post-mortem the
            # straggler census starts: dump it BEFORE a possible abort
            flight.note("watchdog", "gang_stall", step=int(step),
                        missing=e.missing, arrived=e.arrived)
            flight.dump("gang_watchdog_stall")
            if self.action == "abort":
                logger.error("gang watchdog: aborting process (exit %d)",
                             ABORT_EXIT_CODE)
                os._exit(ABORT_EXIT_CODE)
