"""Unified telemetry: metrics registry, span tracer, sinks, the profiler
window and its trace decomposition (port of
``fleetx_tpu/observability/__init__.py``).

- ``metrics`` — counters / gauges / windowed histograms and the derived
  tokens/s, step-time EWMA, data-stall and MFU arithmetic;
- ``trace``   — ``span()`` host spans emitting Chrome-trace JSON, nested
  under ``torch.profiler.record_function``, and the re-armable
  ``ProfilerWindow``;
- ``perf``    — Kineto trace decomposition into the MFU-gap report;
- ``memory``  — device-memory samples and the planner's model error;
- ``sinks``   — rank-0 JSONL / CSV / Prometheus-textfile emitters;
- ``schema``  — the record validators; ``gang`` — the cross-rank merges;
- ``flight``, ``tsan``, ``slo`` — the crash recorder, the lock sanitizer
  and the serving SLO registry.

``Observability`` ties them together for the engines: built from the
``Observability:`` YAML block, it owns the tracer, the sink fan-out, the
flight ring, the perf stream and the derived-metric state, and is a no-op
(``contextlib.nullcontext`` spans) when the block is absent or disabled.
Importing the package does not import torch.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
from typing import Any, Optional

from fleetx_tpu_torch.observability import flight as flight_mod
from fleetx_tpu_torch.observability.flight import FlightRecorder  # noqa: F401
from fleetx_tpu_torch.observability.memory import (  # noqa: F401
    MemoryMonitor, sample_memory_stats)
from fleetx_tpu_torch.observability.metrics import (  # noqa: F401
    Counter, DerivedMetrics, Gauge, Histogram, MetricsRegistry, get_registry,
    mfu)
from fleetx_tpu_torch.observability.sinks import (  # noqa: F401
    CsvSink, JsonlSink, PrometheusTextfileSink, Sink, _process_index,
    build_sinks)
from fleetx_tpu_torch.observability.trace import (  # noqa: F401
    ProfilerWindow, Tracer, get_tracer, set_tracer, span)
from fleetx_tpu_torch.utils.log import logger

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "DerivedMetrics",
    "get_registry", "mfu", "Sink", "JsonlSink", "CsvSink",
    "PrometheusTextfileSink", "build_sinks", "Tracer", "ProfilerWindow",
    "span", "get_tracer", "set_tracer", "Observability", "FlightRecorder",
    "MemoryMonitor", "sample_memory_stats",
]


def _world_size() -> int:
    """The process group's size (1 without one)."""
    dist = getattr(sys.modules.get("torch"), "distributed", None)
    if dist is not None and dist.is_available() and dist.is_initialized():
        return int(dist.get_world_size())
    return 1


class Observability:
    """Engine-facing facade over registry + tracer + sinks.

    ``Observability(cfg_block)`` with a falsy/disabled block yields an
    object whose every method is a no-op, so the engines call it
    unconditionally and pay nothing when telemetry is off.
    ``Observability.gang`` (per-rank files merged across a gang) needs
    several ranks and raises ``NotImplementedError``.
    """

    def __init__(self, cfg: Optional[dict] = None,
                 default_output_dir: str = "./output"):
        cfg = dict(cfg or {})
        if cfg.get("gang"):
            raise NotImplementedError(
                "Observability.gang needs a multi-rank gang, not ported yet "
                "(ROADMAP.md, port queue item 12)")
        self.enabled = bool(cfg.get("enable"))
        self.output_dir = str(cfg.get("output_dir")
                              or os.path.join(default_output_dir, "telemetry"))
        # explicit None check: ewma_alpha 0 (no smoothing) is a valid value
        alpha = cfg.get("ewma_alpha")
        self.ewma_alpha = 0.1 if alpha is None else float(alpha)
        # the process-wide registry: checkpoint.py and the inference path
        # record into the same one, so engine records see their timings
        self.registry = get_registry()
        self.sinks: list[Sink] = []
        self.tracer: Optional[Tracer] = None
        self._trace_path: Optional[str] = None
        self.derived: Optional[DerivedMetrics] = None
        self.rank = _process_index()
        # trace decomposition of closed profiler windows: on whenever
        # telemetry is; it costs nothing until a window closes
        perf_cfg = dict(cfg.get("perf") or {})
        self.perf_enabled = self.enabled and bool(perf_cfg.get("enable",
                                                               True))
        self.perf_top_k = int(perf_cfg.get("top_k") or 5)
        self._perf_sink: Optional[Sink] = None
        # crash flight recorder: on whenever telemetry is; a disabled
        # facade clears any previously installed recorder
        flight_cfg = dict(cfg.get("flight") or {})
        flight_on = flight_cfg.get("enable")
        self.flight: Optional[FlightRecorder] = None
        if self.enabled and (True if flight_on is None else bool(flight_on)):
            flight_dir = (os.environ.get(flight_mod.ENV_DIR)
                          or os.path.join(self.output_dir, "flight"))
            self.flight = FlightRecorder(
                flight_dir, rank=self.rank, world=_world_size(),
                capacity=int(flight_cfg.get("capacity")
                             or flight_mod.DEFAULT_CAPACITY))
        flight_mod.install(self.flight)
        if not self.enabled:
            return
        window = cfg.get("histogram_window")
        self.registry.set_default_window(1024 if window is None
                                         else int(window))
        self.sinks = build_sinks(cfg.get("sinks") or ["jsonl"],
                                 self.output_dir)
        trace_cfg = dict(cfg.get("trace") or {})
        if trace_cfg.get("enable", True):
            self.tracer = Tracer(
                max_events=int(trace_cfg.get("max_events") or 200_000))
            fname = str(trace_cfg.get("path") or "trace.json")
            path = (fname if os.path.isabs(fname)
                    else os.path.join(self.output_dir, fname))
            if self.rank:
                root, ext = os.path.splitext(path)
                path = f"{root}.rank{self.rank}{ext or '.json'}"
            self._trace_path = path
            set_tracer(self.tracer)
        logger.info("observability enabled → %s (sinks: %s%s)",
                    self.output_dir,
                    [type(s).__name__ for s in self.sinks],
                    ", tracing" if self.tracer else "")

    # -- spans ---------------------------------------------------------------
    def span(self, name: str, **args: Any):
        """A recorded span when enabled, else a zero-cost null context."""
        if not self.enabled:
            return contextlib.nullcontext()
        return span(name, **args)

    def timed_span(self, name: str, **args: Any):
        """Span composed with ``registry.timer``: one region feeds the trace,
        the ``name`` histogram and the ``<name>_seconds_total`` counter."""
        if not self.enabled:
            return contextlib.nullcontext()
        stack = contextlib.ExitStack()
        stack.enter_context(span(name, **args))
        stack.enter_context(self.registry.timer(name))
        return stack

    # -- derived metrics -----------------------------------------------------
    def init_derived(self, flops_per_token: Optional[float],
                     n_devices: int, device=None) -> None:
        """Create the DerivedMetrics layer once the module and the device
        are known; the peak is the card's (``utils/hardware.py``), None on
        the CPU (MFU then reads null)."""
        import torch

        from fleetx_tpu_torch.utils.hardware import peak_flops

        peak = None
        if device is not None and torch.device(device).type == "cuda":
            peak = peak_flops(torch.cuda.get_device_name(device))
        self.derived = DerivedMetrics(
            flops_per_token=flops_per_token, peak_flops_per_chip=peak,
            n_devices=n_devices, ewma_alpha=self.ewma_alpha)
        # the registry is process-wide: baseline the stall integral so a
        # fresh engine's first window doesn't inherit prior engines' stalls
        self.derived._last_stall_total = self.stall_seconds_total()

    def stall_seconds_total(self) -> float:
        """Monotone host-blocked time: data fetch + host-to-device copy."""
        return (self.registry.counter("data_fetch_seconds_total").value
                + self.registry.counter("shard_batch_seconds_total").value)

    # -- record fan-out ------------------------------------------------------
    def emit(self, record: dict) -> None:
        """Fan one step record out to every sink (never raises); a slim
        form goes to the flight ring."""
        if not self.enabled:
            return
        if self.flight is not None:
            self.flight.record(
                "metrics", "window", step=record.get("step"),
                loss=record.get("loss"),
                step_time=record.get("step_time"))
        for sink in self.sinks:
            try:
                sink.emit(record)
            except OSError as e:  # a full disk must not kill training
                logger.warning("sink %s emit failed: %s",
                               type(sink).__name__, e)

    # -- perf introspection --------------------------------------------------
    def emit_perf(self, report: dict) -> None:
        """Land one trace-decomposition report in ``perf.jsonl`` beside
        ``metrics.jsonl`` (its own file: decomposition records would fail
        the step-record schema), a slim summary in the gauges
        (``perf_bwd_scan_ms_per_layer`` & co.) and the flight ring. Never
        raises."""
        if not self.perf_enabled:
            return
        from fleetx_tpu_torch.observability import perf as perf_mod

        slim = perf_mod.summary(report)
        for key in ("fwd_scan_ms_per_layer", "bwd_scan_ms_per_layer",
                    "gap_ms", "step_ms"):
            if slim.get(key) is not None:
                self.registry.gauge(f"perf_{key}").set(slim[key])
        if self.flight is not None:
            self.flight.record("perf", "decomposition", **slim)
        if self._perf_sink is None:
            fname = (f"perf.rank{self.rank}.jsonl" if self.rank
                     else "perf.jsonl")
            self._perf_sink = JsonlSink(
                os.path.join(self.output_dir, fname))
        try:
            self._perf_sink.emit({"ts": time.time(), **report})
        except OSError as e:  # a full disk must not kill training
            logger.warning("perf sink emit failed: %s", e)

    def flight_dump(self, reason: str) -> None:
        """Dump the flight ring (no-op without a recorder; never raises)."""
        if self.flight is not None:
            flight_mod.dump(reason)

    def flush(self) -> None:
        """Durable-ize sinks and write the Chrome trace snapshot."""
        if not self.enabled:
            return
        for sink in self.sinks:
            sink.flush()
        if self._perf_sink is not None:
            self._perf_sink.flush()
        if self.tracer is not None and self._trace_path and \
                self.tracer.events:
            self.tracer.save(self._trace_path)

    def close(self) -> None:
        """Flush + close sinks, release the tracer and the recorder."""
        if not self.enabled:
            return
        self.flush()
        for sink in self.sinks:
            sink.close()
        self.sinks = []
        if self._perf_sink is not None:
            self._perf_sink.close()
            self._perf_sink = None
        if get_tracer() is self.tracer:
            set_tracer(None)
        if flight_mod.get_recorder() is self.flight:
            flight_mod.install(None)
