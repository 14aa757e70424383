"""Crash flight recorder: a bounded ring of the run's last moments (copy
of ``fleetx_tpu/observability/flight.py``).

``FlightRecorder`` keeps a bounded in-memory ring of recent events and
dumps it atomically as ``flight_rank<i>.json`` on a crash or a graceful
drain. The module-level ``install``/``note``/``dump`` helpers let deep
layers contribute events without config plumbing. Stdlib-only.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
import time
from collections import deque
from typing import Any, Optional

from fleetx_tpu_torch.utils.log import logger

__all__ = ["EventRing", "FlightRecorder", "install", "get_recorder",
           "note", "dump", "ENV_DIR", "DEFAULT_CAPACITY"]

#: per-rank dump directory override (a supervisor sets it per generation)
ENV_DIR = "FLEETX_FLIGHT_DIR"

DEFAULT_CAPACITY = 512


class EventRing:
    """Bounded, lock-guarded event ring: the newest ``capacity`` events win.

    Shared by the crash recorder and the serving engine's per-request
    timelines; appends and snapshots are safe across threads.
    """

    __slots__ = ("capacity", "_ring", "_lock", "_total")

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self.capacity = max(int(capacity), 1)
        self._ring: deque = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._total = 0

    def append(self, evt: dict) -> None:
        """Append one event; the oldest falls off (``dropped`` counts it)."""
        with self._lock:
            self._ring.append(evt)
            self._total += 1

    def snapshot(self) -> list:
        """Copy of the current ring, oldest first."""
        with self._lock:
            return list(self._ring)

    @property
    def total(self) -> int:
        """All-time appended count."""
        with self._lock:
            return self._total

    @property
    def dropped(self) -> int:
        """How many events have been evicted off the ring."""
        with self._lock:
            return self._total - len(self._ring)


def _atomic_write_json(path: str, payload: dict) -> None:
    """tmp + fsync + ``os.replace``: a crash mid-dump never leaves a torn
    file behind."""
    d = os.path.dirname(path) or "."
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".tmp_flight_")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(payload, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


class FlightRecorder:
    """Bounded event ring with an atomic JSON dump."""

    def __init__(self, out_dir: str, rank: int = 0, world: int = 1,
                 capacity: int = DEFAULT_CAPACITY):
        self.out_dir = str(out_dir)
        self.rank = int(rank)
        self.world = int(world)
        self.capacity = max(int(capacity), 1)
        self._ring = EventRing(self.capacity)

    @property
    def path(self) -> str:
        """The dump target: ``<out_dir>/flight_rank<rank>.json``."""
        return os.path.join(self.out_dir, f"flight_rank{self.rank}.json")

    def record(self, kind: str, name: str, **data: Any) -> None:
        """Append one wall-clock-stamped event; the reserved fields win
        over ``data``."""
        self._ring.append({**data, "t": time.time(), "kind": kind,
                           "name": name})

    def dump(self, reason: str) -> str:
        """Atomically write the ring as ``flight_rank<i>.json``."""
        payload = {
            "rank": self.rank, "world": self.world,
            "reason": str(reason), "dumped_at": time.time(),
            "recorded_total": self._ring.total,
            "capacity": self.capacity,
            "events": self._ring.snapshot(),
        }
        os.makedirs(self.out_dir, exist_ok=True)
        _atomic_write_json(self.path, payload)
        logger.warning("flight recorder dumped (%s): %s (%d events)",
                       reason, self.path, len(payload["events"]))
        return self.path


_recorder: Optional[FlightRecorder] = None


def install(recorder: Optional[FlightRecorder]) -> Optional[FlightRecorder]:
    """Install (or clear, with None) the process-wide recorder; returns
    the previous one."""
    global _recorder
    prev = _recorder
    _recorder = recorder
    return prev


def get_recorder() -> Optional[FlightRecorder]:
    """The active recorder, if any."""
    return _recorder


def note(kind: str, name: str, **data: Any) -> None:
    """Record one event on the active recorder (no-op when none)."""
    if _recorder is not None:
        _recorder.record(kind, name, **data)


def dump(reason: str) -> Optional[str]:
    """Dump the active recorder (no-op when none); returns the path.
    Never raises: a failing dump must not mask the exception it is for."""
    if _recorder is None:
        return None
    try:
        return _recorder.dump(reason)
    except Exception as e:  # noqa: BLE001 — the dump is best-effort
        logger.error("flight recorder dump failed: %s", e)
        return None
