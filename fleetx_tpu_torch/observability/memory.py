"""Device-memory attribution: measured HBM against the planner's
prediction (port of ``fleetx_tpu/observability/memory.py``).

The engine samples the card's memory at phase boundaries (after the first
step, each logging window, the profiler window's close, eval, save),
emits peak / live gauges and computes

    ``hbm_model_error`` = (measured peak − predicted) / predicted

against ``parallel/auto_layout.predicted_step_bytes``, so every run scores
the model that plans its layout. On a card the numbers come from the
caching allocator (``torch.cuda.memory_stats``: ``allocated_bytes.all``
current and peak, the figures ``torch.cuda.max_memory_allocated``
reports) and the limit from ``torch.cuda.mem_get_info``. Without a card
sampling returns ``None`` and records carry ``hbm_stats: "unavailable"``
instead of a fake zero, as in JAX.
"""

from __future__ import annotations

from typing import Callable, Optional

__all__ = ["sample_memory_stats", "MemoryMonitor"]


def sample_memory_stats(device=None) -> Optional[dict]:
    """``{"bytes_in_use", "peak_bytes_in_use", "bytes_limit"}`` of a CUDA
    device (the current one by default), or None without one (the CPU)."""
    import torch

    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return None
    try:
        stats = torch.cuda.memory_stats(device)
        _free, total = torch.cuda.mem_get_info(device)
    except Exception:  # noqa: BLE001 — sampling never kills a run
        return None
    out = {"bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
           "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak",
                                              0)),
           "bytes_limit": int(total)}
    return out


class MemoryMonitor:
    """Phase-boundary HBM sampler + model-error scorer for one engine.

    ``sample(phase)`` is cheap (one host call, no device work) and never
    raises; gauges land in the shared registry (``hbm_bytes_in_use``,
    ``hbm_peak_bytes``, ``hbm_model_error``) and per-phase peaks are kept
    for the report/record surface (``snapshot()``). ``predicted_bytes``
    is the ``auto_layout.predicted_step_bytes`` figure for the active
    config; without it (non-GPT modules) the error stays None.
    """

    def __init__(self, registry=None, predicted_bytes: Optional[float] = None,
                 stats_fn: Optional[Callable[[], Optional[dict]]] = None):
        self.registry = registry
        self.predicted_bytes = (float(predicted_bytes)
                                if predicted_bytes else None)
        # injectable for tests and for an engine whose device is not the
        # current one
        self._stats_fn = stats_fn or sample_memory_stats
        self.available: Optional[bool] = None  # unknown until first sample
        self.phases: dict[str, dict] = {}
        self.peak_bytes: Optional[int] = None

    def sample(self, phase: str) -> Optional[dict]:
        """Record one phase-boundary sample; returns it (or None)."""
        try:
            stats = self._stats_fn()
        except Exception:  # noqa: BLE001 — sampling must never kill a run
            stats = None
        if stats is None:
            # remember unavailability only if nothing ever succeeded: one
            # flaky read must not demote a backend that does report
            if self.available is None:
                self.available = False
            return None
        self.available = True
        self.phases[phase] = dict(stats)
        peak = stats.get("peak_bytes_in_use", stats.get("bytes_in_use"))
        if peak is not None:
            self.peak_bytes = max(self.peak_bytes or 0, int(peak))
        if self.registry is not None:
            if stats.get("bytes_in_use") is not None:
                self.registry.gauge("hbm_bytes_in_use").set(
                    stats["bytes_in_use"])
            if self.peak_bytes is not None:
                self.registry.gauge("hbm_peak_bytes").set(self.peak_bytes)
                self.registry.gauge(f"hbm_peak_bytes.{phase}").set(
                    int(peak) if peak is not None else self.peak_bytes)
            err = self.model_error()
            if err is not None:
                self.registry.gauge("hbm_model_error").set(err)
        return stats

    def model_error(self) -> Optional[float]:
        """(measured peak − predicted) / predicted, or None.

        Positive = the planner UNDER-estimated (the dangerous direction:
        a layout it approved can OOM); negative = headroom it left on the
        table. None whenever either side is unknown.
        """
        if not self.predicted_bytes or self.peak_bytes is None:
            return None
        return (self.peak_bytes - self.predicted_bytes) / \
            self.predicted_bytes

    def record_keys(self) -> dict:
        """The HBM keys one step record carries (schema-typed).

        ``hbm_stats`` is the explicit availability marker: ``"ok"`` when
        the backend reports, ``"unavailable"`` when it never has —
        downstream tooling can distinguish "no regression" from "nothing
        measured" without guessing from nulls.
        """
        if not self.available:
            return {"hbm_stats": "unavailable", "hbm_peak_bytes": None,
                    "hbm_model_error": None}
        err = self.model_error()
        return {"hbm_stats": "ok", "hbm_peak_bytes": self.peak_bytes,
                "hbm_model_error": None if err is None else round(err, 4)}

    def snapshot(self) -> dict:
        """Full JSON-ready view: availability, per-phase samples, peak,
        prediction and error — the perf stream / bench JSON surface."""
        return {
            "available": bool(self.available),
            "peak_bytes": self.peak_bytes,
            "predicted_bytes": (None if self.predicted_bytes is None
                                else int(self.predicted_bytes)),
            "model_error": self.model_error(),
            "phases": {k: dict(v) for k, v in self.phases.items()},
        }
