"""Process-local metrics registry and derived training metrics (copy of
``fleetx_tpu/observability/metrics.py``).

``Counter`` / ``Gauge`` / ``Histogram`` primitives collected in a
``MetricsRegistry``; ``Histogram`` keeps a bounded sample window and
reports p50/p95/p99. ``DerivedMetrics`` turns one logging window's raw
measurements into tokens/s, the step-time EWMA, the data-stall fraction,
MFU (``utils/hardware.py``'s peak) and the per-rank arrival skew.
Host-side Python only: recording a metric costs nanoseconds against a
step.
"""

from __future__ import annotations

import math
import threading
import time
from collections import deque
from typing import Any, Optional


class Counter:
    """Monotonically increasing count (events, tokens, bytes)."""

    __slots__ = ("name", "_value")

    def __init__(self, name: str):
        self.name = name
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        # lock-free by design: a float += under the GIL may at worst lose
        # a tick, which metrics tolerate
        self._value += amount

    @property
    def value(self) -> float:
        return self._value

    def reset(self) -> None:
        self._value = 0.0


class Gauge:
    """Last-written value (queue depth, occupancy)."""

    __slots__ = ("name", "_value")

    def __init__(self, name: str):
        self.name = name
        self._value: Optional[float] = None

    def set(self, value: float) -> None:
        self._value = float(value)

    @property
    def value(self) -> Optional[float]:
        return self._value

    def reset(self) -> None:
        self._value = None


class Histogram:
    """Windowed sample buffer reporting count/mean/min/max and quantiles.

    Totals (``total_count`` / ``total_sum``) survive window eviction and
    ``reset()`` only clears the window.
    """

    __slots__ = ("name", "_window", "total_count", "total_sum")

    def __init__(self, name: str, window: int = 1024):
        self.name = name
        self._window: deque = deque(maxlen=max(int(window), 1))
        self.total_count = 0
        self.total_sum = 0.0

    def record(self, value: float) -> None:
        """Append one sample to the window and the all-time totals."""
        v = float(value)
        self._window.append(v)
        self.total_count += 1
        self.total_sum += v

    def quantile(self, q: float) -> Optional[float]:
        """Linear-interpolated quantile over the current window."""
        if not self._window:
            return None
        xs = sorted(self._window)
        if len(xs) == 1:
            return xs[0]
        pos = q * (len(xs) - 1)
        lo = int(math.floor(pos))
        hi = min(lo + 1, len(xs) - 1)
        frac = pos - lo
        return xs[lo] * (1.0 - frac) + xs[hi] * frac

    def summary(self) -> dict:
        """count/mean/min/max/p50/p95/p99 of the current window."""
        xs = list(self._window)
        if not xs:
            return {"count": 0}
        return {
            "count": len(xs),
            "mean": sum(xs) / len(xs),
            "min": min(xs),
            "max": max(xs),
            "p50": self.quantile(0.50),
            "p95": self.quantile(0.95),
            "p99": self.quantile(0.99),
        }

    def reset(self) -> None:
        self._window.clear()


class MetricsRegistry:
    """Get-or-create home for every metric in a process (thread-safe on
    creation; individual updates are plain float ops)."""

    def __init__(self, histogram_window: int = 1024):
        self._lock = threading.Lock()
        self._histogram_window = int(histogram_window)
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        with self._lock:
            if name not in self._counters:
                self._counters[name] = Counter(name)
            return self._counters[name]

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            if name not in self._gauges:
                self._gauges[name] = Gauge(name)
            return self._gauges[name]

    def histogram(self, name: str, window: Optional[int] = None) -> Histogram:
        with self._lock:
            if name not in self._histograms:
                self._histograms[name] = Histogram(
                    name, window or self._histogram_window)
            return self._histograms[name]

    def set_default_window(self, window: int) -> None:
        """Default window for histograms created from now on (the shared
        registry outlives any one Observability config)."""
        with self._lock:
            self._histogram_window = max(int(window), 1)

    def timer(self, name: str):
        """``with registry.timer("phase"): ...`` records seconds into the
        ``phase`` histogram and bumps ``phase_seconds_total`` (the counter
        the data-stall fraction integrates)."""
        return _Timer(self, name)

    def snapshot(self) -> dict:
        """Flat, JSON-ready view: counters and gauges as scalars,
        histograms as their summary dicts."""
        out: dict[str, Any] = {}
        with self._lock:
            for c in self._counters.values():
                out[c.name] = c.value
            for g in self._gauges.values():
                out[g.name] = g.value
            for h in self._histograms.values():
                out[h.name] = h.summary()
        return out


class _Timer:
    __slots__ = ("_registry", "_name", "_t0")

    def __init__(self, registry: MetricsRegistry, name: str):
        self._registry = registry
        self._name = name

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self._registry.histogram(self._name).record(dt)
        self._registry.counter(self._name + "_seconds_total").inc(dt)
        return False


_default_registry: Optional[MetricsRegistry] = None
_default_lock = threading.Lock()


def get_registry() -> MetricsRegistry:
    """The shared per-process registry (lazily created)."""
    global _default_registry
    with _default_lock:
        if _default_registry is None:
            _default_registry = MetricsRegistry()
        return _default_registry


def mfu(tokens_per_sec: Optional[float], flops_per_token: Optional[float],
        peak_flops_per_chip: Optional[float], n_devices: int) -> Optional[float]:
    """Model FLOPs utilisation: achieved model FLOP/s over the devices'
    peak; None when any input is unknown (the CPU has no peak), never 0."""
    if not tokens_per_sec or not flops_per_token or not peak_flops_per_chip:
        return None
    return (tokens_per_sec * flops_per_token
            / (peak_flops_per_chip * max(n_devices, 1)))


class DerivedMetrics:
    """Per-logging-window derivation of throughput / MFU / stall signals;
    owns the EWMA state and the stall-time bookkeeping."""

    def __init__(self, flops_per_token: Optional[float] = None,
                 peak_flops_per_chip: Optional[float] = None,
                 n_devices: int = 1, ewma_alpha: float = 0.1):
        self.flops_per_token = flops_per_token
        self.peak_flops_per_chip = peak_flops_per_chip
        self.n_devices = max(int(n_devices), 1)
        self.ewma_alpha = float(ewma_alpha)
        self._ewma: Optional[float] = None
        self._last_stall_total = 0.0
        # rank -> seconds behind the median arrival (gang mode)
        self._skew: dict[int, float] = {}

    def update(self, step_time: float, global_batch_size: int,
               tokens_per_sample: Optional[int] = None,
               steps_in_window: int = 1,
               stall_seconds_total: float = 0.0) -> dict:
        """One record's worth of metrics. ``step_time`` is the window's
        mean seconds per step; ``stall_seconds_total`` a monotone counter
        of host-blocked seconds, whose delta since the last window over
        the window's wall is the stall fraction."""
        step_time = max(float(step_time), 1e-12)
        a = self.ewma_alpha
        self._ewma = (step_time if self._ewma is None
                      else a * step_time + (1.0 - a) * self._ewma)
        samples_per_sec = global_batch_size / step_time
        tokens_per_sec = (samples_per_sec * tokens_per_sample
                          if tokens_per_sample else None)
        window_wall = step_time * max(int(steps_in_window), 1)
        stall_delta = max(stall_seconds_total - self._last_stall_total, 0.0)
        self._last_stall_total = stall_seconds_total
        data_stall_frac = min(stall_delta / max(window_wall, 1e-12), 1.0)
        return {
            "step_time": step_time,
            "step_time_ewma": self._ewma,
            "samples_per_sec": samples_per_sec,
            "tokens_per_sec": tokens_per_sec,
            "data_stall_frac": data_stall_frac,
            "mfu": mfu(tokens_per_sec, self.flops_per_token,
                       self.peak_flops_per_chip, self.n_devices),
        }

    def update_arrivals(self, arrivals: dict) -> None:
        """Fold one rendezvous' arrival census (rank -> wall-clock
        timestamp) into the rolling per-rank skew: the EWMA of each rank's
        offset from the median arrival."""
        if not arrivals or len(arrivals) < 2:
            return
        ts = sorted(float(t) for t in arrivals.values())
        mid = len(ts) // 2
        median = ts[mid] if len(ts) % 2 else (ts[mid - 1] + ts[mid]) / 2.0
        a = self.ewma_alpha if self.ewma_alpha > 0 else 1.0
        for rank, t in arrivals.items():
            skew = float(t) - median
            prev = self._skew.get(int(rank))
            self._skew[int(rank)] = (skew if prev is None
                                     else a * skew + (1.0 - a) * prev)

    def rank_skew(self) -> dict:
        """rank -> rolling seconds behind (+) / ahead (-) of the median."""
        return dict(self._skew)

    def slowest_rank(self) -> Optional[int]:
        """The rank with the largest positive skew, None before any
        census."""
        if not self._skew:
            return None
        return max(self._skew, key=lambda r: self._skew[r])
