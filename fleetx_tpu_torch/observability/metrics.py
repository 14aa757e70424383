"""Process-local metrics registry (copy of
``fleetx_tpu/observability/metrics.py:32-248``).

``Counter`` / ``Gauge`` / ``Histogram`` primitives collected in a
``MetricsRegistry``; ``Histogram`` keeps a bounded sample window and
reports p50/p95/p99. Host-side Python only: recording a metric costs
nanoseconds against a decode step.
"""

from __future__ import annotations

import math
import threading
import time
from collections import deque
from typing import Optional


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

    def timer(self, name: str):
        """``with registry.timer("phase"): ...`` records seconds into the
        ``phase`` histogram and bumps ``phase_seconds_total``."""
        return _Timer(self, name)


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
