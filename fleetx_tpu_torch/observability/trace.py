"""Host-side span tracer emitting Chrome-trace-event JSON, and the
profiler window (port of ``fleetx_tpu/observability/trace.py``).

- ``span("name")`` — a context manager / decorator that records a Chrome
  "complete" event (``ph: "X"``) into the active ``Tracer`` and enters
  ``torch.profiler.record_function(name)``, so while a profiler window is
  open the host spans show in the Kineto trace beside the card's kernels.
- ``ProfilerWindow`` — the config-gated ``torch.profiler`` window (CPU and
  CUDA activities), re-armed by every ``fit``: set up, unrecording, over
  the step before ``start_step``, recording from ``start_step`` to
  ``stop_step``, the card drained (``torch.cuda.synchronize``) as it
  opens and as it closes so the trace holds its steps' kernels whole and
  no other's, exported as
  ``<output_dir>/<host>_<pid>.<ms>.pt.trace.json`` and handed to the
  ``on_stop`` hook. Inside the window ``step_span(step)`` marks each step
  ``ProfilerStep#<step>``, the name ``observability/perf.py`` reads steps
  by.

The Chrome JSON (``{"traceEvents": [...]}``) loads in
https://ui.perfetto.dev or ``chrome://tracing``; timestamps and durations
are microseconds, ``pid`` the process's rank. torch is imported inside
the functions that need it, so importing this module stays cheap.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import socket
import threading
import time
from typing import Any, Optional

from fleetx_tpu_torch.observability import flight
from fleetx_tpu_torch.observability.sinks import _process_index
from fleetx_tpu_torch.utils.log import logger

#: the step marker's name prefix (``torch.profiler``'s own)
STEP_PREFIX = "ProfilerStep#"


class Tracer:
    """Collects span events; ``save()`` writes one Chrome-trace JSON file."""

    def __init__(self, max_events: int = 200_000):
        self._events: list[dict] = []
        self._lock = threading.Lock()
        self._max_events = int(max_events)
        self._dropped = 0

    def add_event(self, name: str, ts_us: float, dur_us: float,
                  args: Optional[dict] = None) -> None:
        """Record one complete ('X') event; drops past the event cap."""
        evt = {
            "name": name, "ph": "X", "ts": ts_us, "dur": dur_us,
            "pid": _process_index(), "tid": threading.get_ident() & 0xFFFF,
        }
        if args:
            evt["args"] = args
        with self._lock:
            if len(self._events) >= self._max_events:
                self._dropped += 1
                return
            self._events.append(evt)

    @property
    def events(self) -> list[dict]:
        with self._lock:
            return list(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._dropped = 0

    def to_chrome_trace(self) -> dict:
        """The Perfetto/chrome://tracing JSON object for all events."""
        meta = {"dropped_events": self._dropped} if self._dropped else {}
        return {"traceEvents": self.events, "displayTimeUnit": "ms",
                **({"otherData": meta} if meta else {})}

    def save(self, path: str) -> str:
        """Write the trace (each process writes its own events)."""
        if self._dropped:
            logger.warning("tracer dropped %d events past the %d-event cap",
                           self._dropped, self._max_events)
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f)
        logger.info("chrome trace written: %s (%d events — open in "
                    "https://ui.perfetto.dev)", path, len(self._events))
        return path


# Active tracer: span() records into it when set
_active_tracer: Optional[Tracer] = None


def set_tracer(tracer: Optional[Tracer]) -> Optional[Tracer]:
    """Install the active tracer; returns the previous one (restorable)."""
    global _active_tracer
    prev = _active_tracer
    _active_tracer = tracer
    return prev


def get_tracer() -> Optional[Tracer]:
    return _active_tracer


class span:
    """``with span("train_step", step=3): ...`` or ``@span("load")``.

    Records a complete event into the active tracer (if any) and nests the
    region under ``torch.profiler.record_function``. An inner span's
    ``[ts, ts+dur]`` lies within its parent's on the same tid, which
    Perfetto renders as a nested slice.
    """

    __slots__ = ("name", "args", "_t0", "_ts", "_annotation")

    def __init__(self, name: str, **args: Any):
        self.name = name
        self.args = args or None

    def __enter__(self):
        from torch.profiler import record_function

        self._annotation = record_function(self.name)
        self._annotation.__enter__()
        # wall-clock anchor at entry (an outer span's ts precedes its
        # children's); the duration from perf_counter
        self._ts = time.time()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        dur = time.perf_counter() - self._t0
        self._annotation.__exit__(exc_type, exc, tb)
        tracer = _active_tracer
        if tracer is not None:
            tracer.add_event(self.name, self._ts * 1e6, dur * 1e6, self.args)
        # the flight recorder's timeline backbone; span args ride nested so
        # a user arg named "kind" or "t" cannot clobber the event's fields
        if flight.get_recorder() is not None:
            extra = {"args": self.args} if self.args else {}
            flight.note("span", self.name,
                        dur_ms=round(dur * 1000.0, 3), **extra)
        return False

    def __call__(self, fn):
        @functools.wraps(fn)
        def wrapper(*a, **kw):
            with span(self.name, **(self.args or {})):
                return fn(*a, **kw)
        return wrapper


def span_if_traced(name: str, **args: Any):
    """``span(name)`` while something reads it: the active tracer, the
    flight recorder or an open ``torch.profiler`` window. Else a
    ``contextlib.nullcontext``, so a call site outside the facade (the
    inference engine's) costs three checks with telemetry off."""
    import torch

    if _active_tracer is None and flight.get_recorder() is None and \
            not torch.autograd.profiler._is_profiler_enabled:
        return contextlib.nullcontext()
    return span(name, **args)


class ProfilerWindow:
    """Config-gated ``torch.profiler`` window, re-armable per fit.

    States: ``armed`` → (step >= start) → ``active`` → (step >= stop) →
    ``done``; ``arm()`` at the top of every ``fit()`` resets ``done`` back
    to ``armed`` so each fit gets its own window. A profiler that cannot
    open raises: there is no fallback.
    """

    def __init__(self, cfg: Optional[dict] = None):
        prof = dict(cfg or {})
        self.enabled = bool(prof.get("enable"))
        sched = list(prof.get("scheduler") or [])

        def _int(key, default):
            v = prof.get(key, default)
            return default if v is None else int(v)

        self.start_step = _int("start_step", int(sched[0]) if sched else 3)
        self.stop_step = _int("stop_step", int(sched[1]) if len(sched) > 1
                              else self.start_step + 5)
        self.output_dir = (prof.get("output_dir")
                           or prof.get("profiler_log") or "./profiler_log")
        # the reference Profiler's "detailed": record op shapes and stacks
        self.detailed = bool(prof.get("detailed"))
        # post-window hook: the engine's trace decomposition, called with
        # the output directory
        self.on_stop = None
        self.profile = None  # the last window's torch.profiler.profile
        self.trace_path: Optional[str] = None
        self._active = False
        self._warming = False  # the profiler runs its warm-up step
        self._done = False

    @property
    def active(self) -> bool:
        return self._active

    def arm(self) -> None:
        """Reset for a new fit: a completed window may run again."""
        self._done = False

    def _prepare(self) -> None:
        """Set ``torch.profiler`` up (CPU and, with a card, CUDA) without
        recording: its warm-up."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        self.profile = profile(activities=activities,
                               record_shapes=self.detailed,
                               with_stack=self.detailed)
        self.profile.prepare_trace()

    def maybe_start(self, step: int) -> bool:
        """Open the window when armed and ``step`` has reached start_step.

        The profiler warms up over the step before (set up, recording
        nothing), as ``torch.profiler.schedule``'s warm-up does, so the
        window's first step meets no start-of-trace edge; the trace holds
        the window's steps alone. The window's states are JAX's."""
        if not self.enabled or self._active or self._done:
            return False
        if step < self.start_step:
            if step == self.start_step - 1 and not self._warming:
                self._prepare()
                self._warming = True
            return False
        if not self._warming:
            self._prepare()
        import torch

        # the card drained first: no kernel of an earlier step runs inside
        # the window (its host launched them before the window opened)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.profile.start_trace()
        self._warming = False
        self._active = True
        logger.info("profiler trace started → %s", self.output_dir)
        return True

    def annotate(self, name: str):
        """``record_function(name)`` while the window is open, else a null
        context: the engine's region marks (``fwd_scan``, ``bwd_scan``)
        cost nothing outside the window."""
        if not self._active:
            return contextlib.nullcontext()
        from torch.profiler import record_function

        return record_function(name)

    def step_span(self, step: int):
        """``ProfilerStep#<step>`` around one step while the window is
        open, else a null context."""
        return self.annotate(f"{STEP_PREFIX}{int(step)}")

    def maybe_stop(self, step: int) -> bool:
        """Close the window once ``step`` passes stop_step (drains first)."""
        if not self._active or step < self.stop_step:
            return False
        self.stop()
        return True

    def cancel(self) -> None:
        """Stop an open or warming window without exporting it (a fit that
        raised), so the process can open another."""
        if self._warming:
            # a profiler set up must start before it can stop
            self.profile.start_trace()
        if self._active or self._warming:
            self._active = self._warming = False
            self.profile.stop_trace()

    def stop(self) -> None:
        """Close an open window: drain the card so the trace tail is not
        truncated, stop the profiler, export the trace, run ``on_stop``. A
        fit that ends in the warm-up step drops it."""
        if not self._active:
            self.cancel()
            return
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.profile.stop_trace()
        self._active = False
        self._done = True
        os.makedirs(self.output_dir, exist_ok=True)
        self.trace_path = os.path.join(
            self.output_dir, f"{socket.gethostname()}_{os.getpid()}."
            f"{int(time.time() * 1000)}.pt.trace.json")
        self.profile.export_chrome_trace(self.trace_path)
        logger.info("profiler trace written to %s", self.trace_path)
        if self.on_stop is not None:
            try:
                self.on_stop(self.output_dir)
            except Exception as e:  # noqa: BLE001 — analysis is best-effort
                logger.warning("profiler on_stop hook failed: %s: %s",
                               type(e).__name__, e)
