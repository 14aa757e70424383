"""Serving SLO registry (copy of ``fleetx_tpu/observability/slo.py``).

Declarative targets → attainment + burn rate.

The control signal ROADMAP item 3's SLO-aware scaling loop consumes, and
the contract ``tools/slo_report.py`` renders for CI. A ``Serving.slo``
YAML block declares per-class targets::

    Serving:
      slo:
        default:
          ttft_p99_s: 0.5       # p99 time-to-first-token budget (seconds)
          itl_p99_s: 0.05       # p99 inter-token latency budget (seconds)
          refusal_rate: 0.01    # refused / (admitted + refused)
          objective: 0.99       # attainment objective (error budget 1%)
          windows: [12, 60]     # snapshot counts per attainment window

(A flat block — target keys directly under ``slo:`` — is shorthand for a
single ``default`` class.) ``SLORegistry.observe(snapshot)`` evaluates
every target against one ``serving_snapshot()`` record: each window keeps
a rolling met/breach history, **attainment** is the met fraction over the
window and the **burn rate** is the classic multi-window SRE ratio
``(1 - attainment) / (1 - objective)`` — burn 1.0 means the error budget
is being spent exactly as fast as it accrues, >1 means an alert.

Results land in the metrics registry (``slo_attainment`` gauges, per-window
``slo_burn_rate.*`` gauges, ``slo_breaches_total`` counters) and in the
returned report dict, which the engine stamps into its snapshots as
``slo_attainment`` so the router's fleet records carry the fleet-wide
minimum. Stdlib-only, like every observability module, so the offline
report tool replays JSONL streams through the exact same arithmetic.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Dict, List, Optional

from fleetx_tpu_torch.observability.metrics import MetricsRegistry, get_registry

__all__ = ["SLOClass", "SLORegistry", "validate_slo_block", "TARGET_KEYS",
           "DEFAULT_OBJECTIVE", "DEFAULT_WINDOWS"]

#: snapshot keys a target may budget; every one regresses UP (a breach is
#: ``measured > threshold``) — refusal_rate is derived from the admission
#: counters, the rest are read off the snapshot verbatim
TARGET_KEYS = ("ttft_p50_s", "ttft_p99_s", "itl_p50_s", "itl_p99_s",
               "refusal_rate")

DEFAULT_OBJECTIVE = 0.99

#: multi-window default: a short window that reacts within seconds of a
#: regression and a long one that rides out single-snapshot noise
DEFAULT_WINDOWS = (12, 60)


def _real(v: Any) -> bool:
    """A genuine number (bools are config typos, not thresholds)."""
    return isinstance(v, (int, float)) and not isinstance(v, bool)


@dataclasses.dataclass
class SLOClass:
    """One request class's declarative targets (docs/serving.md)."""

    name: str
    targets: Dict[str, float]
    objective: float = DEFAULT_OBJECTIVE
    windows: tuple = DEFAULT_WINDOWS


def validate_slo_block(block: Any) -> List[SLOClass]:
    """Parse + eagerly validate a ``Serving.slo`` YAML block.

    Raises ``ValueError`` naming the offending key — at config time, not
    minutes into a serve when the first snapshot window closes. Returns
    the normalized class list (empty for a falsy block).
    """
    if not block:
        return []
    if not isinstance(block, dict):
        raise ValueError(f"Serving.slo must be a mapping, got "
                         f"{type(block).__name__}")
    if not any(isinstance(v, dict) for v in block.values()):
        block = {"default": block}  # flat shorthand: one implicit class
    classes: List[SLOClass] = []
    for name, spec in block.items():
        if not isinstance(spec, dict):
            raise ValueError(f"Serving.slo.{name} must be a mapping of "
                             f"targets, got {spec!r}")
        spec = dict(spec)
        objective = spec.pop("objective", DEFAULT_OBJECTIVE)
        if not _real(objective) or not 0.0 < float(objective) < 1.0:
            raise ValueError(f"Serving.slo.{name}.objective must be in "
                             f"(0, 1), got {objective!r}")
        windows = spec.pop("windows", list(DEFAULT_WINDOWS))
        if not isinstance(windows, (list, tuple)) or not windows or \
                any(isinstance(w, bool) or not isinstance(w, int) or w <= 0
                    for w in windows):
            raise ValueError(f"Serving.slo.{name}.windows must be a "
                             f"non-empty list of positive ints, got "
                             f"{windows!r}")
        targets: Dict[str, float] = {}
        for key, v in spec.items():
            if key not in TARGET_KEYS:
                raise ValueError(f"unknown SLO target Serving.slo.{name}."
                                 f"{key} (known: {', '.join(TARGET_KEYS)})")
            if not _real(v) or float(v) < 0.0:
                raise ValueError(f"Serving.slo.{name}.{key} must be a "
                                 f"number >= 0, got {v!r}")
            targets[key] = float(v)
        if not targets:
            raise ValueError(f"Serving.slo.{name} declares no targets "
                             f"(known: {', '.join(TARGET_KEYS)})")
        classes.append(SLOClass(name=str(name), targets=targets,
                                objective=float(objective),
                                windows=tuple(sorted(set(int(w)
                                                         for w in windows)))))
    return classes


def _measure(key: str, snapshot: dict) -> Optional[float]:
    """One target's measured value off a serving/fleet record (None =
    no sample this window, e.g. quantiles before the first completion)."""
    if key == "refusal_rate":
        pre = snapshot.get("refusal_rate")  # merged records may carry it
        if _real(pre):
            return float(pre)
        refused = snapshot.get("requests_refused")
        admitted = snapshot.get("requests_admitted")
        if not _real(refused) or not _real(admitted):
            return None
        total = refused + admitted
        return (refused / total) if total else None
    v = snapshot.get(key)
    return float(v) if _real(v) else None


class SLORegistry:
    """Rolling per-target attainment/burn evaluation over snapshots.

    One instance per engine (or per offline replay); gauges and counters
    land in the passed registry (process-global by default). Evaluation
    state is per-(class, target, window) deques of met/breach booleans —
    a window is ``maxlen`` snapshots, matching the "evaluated each
    snapshot window" contract rather than wall-clock bucketing.
    """

    def __init__(self, classes: List[SLOClass],
                 registry: Optional[MetricsRegistry] = None):
        assert classes, "SLORegistry needs at least one SLO class"
        self.classes = list(classes)
        self.metrics = registry or get_registry()
        self._met: Dict[tuple, deque] = {
            (c.name, t, w): deque(maxlen=w)
            for c in self.classes for t in c.targets for w in c.windows}
        self.evaluations = 0
        self.last: Optional[dict] = None

    @classmethod
    def from_config(cls, block: Any,
                    registry: Optional[MetricsRegistry] = None
                    ) -> Optional["SLORegistry"]:
        """A registry from a ``Serving.slo`` block (None when absent)."""
        classes = validate_slo_block(block)
        return cls(classes, registry=registry) if classes else None

    def observe(self, snapshot: dict) -> dict:
        """Evaluate one snapshot against every class/target; returns the
        report dict (and mirrors it into gauges/counters)."""
        self.evaluations += 1
        self.metrics.counter("slo_evaluations_total").inc()
        report: dict = {"classes": {}, "attainment": None, "breached": False}
        overall: Optional[float] = None
        for c in self.classes:
            cls_report: dict = {}
            for target, threshold in c.targets.items():
                measured = _measure(target, snapshot)
                if measured is not None:
                    met = measured <= threshold
                    for w in c.windows:
                        self._met[(c.name, target, w)].append(met)
                    if not met:
                        self.metrics.counter("slo_breaches_total").inc()
                        self.metrics.counter(
                            f"slo_breaches_total.{c.name}.{target}").inc()
                budget = 1.0 - c.objective
                attainment: Dict[str, Optional[float]] = {}
                burn: Dict[str, Optional[float]] = {}
                long_att: Optional[float] = None
                for w in c.windows:
                    hist = self._met[(c.name, target, w)]
                    att = (sum(hist) / len(hist)) if hist else None
                    attainment[str(w)] = att
                    burn[str(w)] = ((1.0 - att) / budget) if att is not None \
                        else None
                    if att is not None:
                        long_att = att  # windows sorted: last = longest
                        self.metrics.gauge(
                            f"slo_burn_rate.{c.name}.{target}.w{w}").set(
                            burn[str(w)])
                breached = long_att is not None and long_att < c.objective
                if long_att is not None:
                    self.metrics.gauge(
                        f"slo_attainment.{c.name}.{target}").set(long_att)
                    overall = long_att if overall is None \
                        else min(overall, long_att)
                cls_report[target] = {
                    "threshold": threshold, "measured": measured,
                    "met": None if measured is None
                    else measured <= threshold,
                    "objective": c.objective, "attainment": attainment,
                    "burn_rate": burn, "breached": breached,
                }
                report["breached"] = report["breached"] or breached
            report["classes"][c.name] = cls_report
        report["attainment"] = overall
        if overall is not None:
            self.metrics.gauge("slo_attainment").set(overall)
        self.last = report
        return report
