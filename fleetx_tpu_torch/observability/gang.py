"""Gang-wide observability: collective-wait metrics and cross-rank
merging (port of ``fleetx_tpu/observability/gang.py``).

- **collective-wait instrumentation** (:61-117) —
  ``resilience/coordination.py`` calls :func:`note_agreement` on every
  completed agreement: the wait lands in the ``barrier_wait_ms``
  histogram (and a per-name ``coord_wait_ms.<name>`` one),
  ``coord_agreements_total`` counts it, the last-arriving rank goes to
  the ``coord_last_rank`` gauge, and the per-rank publish times feed the
  installed arrival hook (``DerivedMetrics.update_arrivals``; the engine's
  ``Observability.install_arrival_hook`` sets the ``rank_skew`` gauge
  from it), so a slow rank is named while the run is healthy;
  :func:`note_timeout` counts ``coord_timeouts_total`` and notes the
  census in the flight ring;
- **cross-rank merging** (:119-232) — :func:`snapshot` packages one
  logging window's record and resilience counters for the loop-control
  vote; :func:`merge_snapshots` turns every rank's snapshots into
  gang-scoped records (counters summed, step-time min / median / max with
  the extreme rank, the fleet's throughput from the slowest rank);
  :func:`merge_rank_records` runs the same arithmetic offline over
  per-rank JSONL files for ``tools/metrics_report.py``.

Stdlib only (the registry and the flight ring are stdlib too), so the
coordination layer imports it without torch.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, List, Optional

from fleetx_tpu_torch.observability import flight
from fleetx_tpu_torch.observability.metrics import get_registry

__all__ = ["GANG_SCHEMA_VERSION", "GANG_COUNTERS", "GANG_HISTOGRAMS",
           "set_arrival_hook", "get_arrival_hook", "note_agreement",
           "note_timeout", "snapshot", "merge_snapshots",
           "merge_rank_records"]

#: records that carry cross-rank context declare this version; plain
#: single-process records carry none and count as version 1
GANG_SCHEMA_VERSION = 2

#: per-rank resilience counters published with every window snapshot and
#: summed into the gang record — one auditable stream instead of N logs
GANG_COUNTERS = (
    "nonfinite_skips", "rollbacks_total", "preemption_exits",
    "watchdog_stalls", "watchdog_gang_stalls", "ckpt_retries_total",
    "ckpt_verify_failed", "ckpt_commit_aborts", "sdc_replay_mismatches",
    "sdc_fingerprint_mismatches", "coord_timeouts_total",
)

#: histograms whose rolling-window summaries ride every snapshot and are
#: pooled (count-weighted mean, min of mins, max of maxes with the extreme
#: rank) into the gang record
GANG_HISTOGRAMS = ("barrier_wait_ms",)

# the arrival hook: installed by the engine once its DerivedMetrics
# exists, so the skew arithmetic stays in metrics.py and the coordination
# call sites need no plumbing
_arrival_hook: Optional[Callable[[Dict[int, float]], None]] = None


def set_arrival_hook(
        fn: Optional[Callable[[Dict[int, float]], None]]
) -> Optional[Callable[[Dict[int, float]], None]]:
    """Install (or clear) the per-agreement arrival-timestamp consumer;
    returns the previous hook."""
    global _arrival_hook
    prev = _arrival_hook
    _arrival_hook = fn
    return prev


def get_arrival_hook() -> Optional[Callable[[Dict[int, float]], None]]:
    """The installed hook (identity checks on facade teardown)."""
    return _arrival_hook


def note_agreement(name: str, waited_s: float,
                   arrivals: Optional[Dict[int, float]] = None,
                   rank: int = 0, world: int = 1) -> None:
    """One completed agreement's wait evidence → the shared registry.

    ``waited_s`` is this rank's entry-to-completion wall time (the skew it
    paid); ``arrivals`` maps rank → publish wall-clock time (ranks on one
    host share a clock).
    """
    reg = get_registry()
    wait_ms = max(float(waited_s), 0.0) * 1000.0
    reg.histogram("barrier_wait_ms").record(wait_ms)
    reg.histogram(f"coord_wait_ms.{name}").record(wait_ms)
    reg.counter("coord_agreements_total").inc()
    if arrivals and len(arrivals) > 1:
        last = max(arrivals, key=lambda r: arrivals[r])
        reg.gauge("coord_last_rank").set(last)
        hook = _arrival_hook
        if hook is not None:
            hook(dict(arrivals))


def note_timeout(name: str, arrived: Iterable[int],
                 missing: Iterable[int]) -> None:
    """An expired agreement: the counter and a flight-recorder event
    carrying the census (the straggler set is the post-mortem's first
    question)."""
    get_registry().counter("coord_timeouts_total").inc()
    flight.note("coord_timeout", name, arrived=sorted(arrived),
                missing=sorted(missing))


def snapshot(record: dict, registry, rank: int, window: int) -> dict:
    """Package one logging window for the loop-control vote.

    ``window`` is the rank's own stash counter — lockstep across ranks by
    construction (every rank runs every loop iteration in gang mode), so
    rank 0 aligns snapshots by it even when step counters diverge under
    the in-step non-finite skip.
    """
    return {
        "w": int(window),
        "rank": int(rank),
        "record": dict(record),
        "counters": {name: registry.counter(name).value
                     for name in GANG_COUNTERS},
        "hists": {name: registry.histogram(name).summary()
                  for name in GANG_HISTOGRAMS},
    }


def _median(xs: List[float]) -> float:
    ys = sorted(xs)
    n = len(ys)
    mid = n // 2
    return ys[mid] if n % 2 else (ys[mid - 1] + ys[mid]) / 2.0


def _merge_window(per_rank: Dict[int, dict], world: int) -> dict:
    """One window's per-rank snapshots → one gang-scoped record."""
    records = {r: s["record"] for r, s in per_rank.items()}
    ranks = sorted(records)
    step_times = {r: float(records[r].get("step_time") or 0.0)
                  for r in ranks}
    slowest = max(ranks, key=lambda r: step_times[r])
    fastest = min(ranks, key=lambda r: step_times[r])
    losses = [float(records[r].get("loss") or 0.0) for r in ranks]
    mfus = [records[r].get("mfu") for r in ranks
            if records[r].get("mfu") is not None]
    skews = {r: records[r].get("rank_skew") for r in ranks
             if records[r].get("rank_skew") is not None}
    merged: dict = {
        "ts": max(float(records[r].get("ts") or 0.0) for r in ranks),
        "step": max(int(records[r].get("step") or 0) for r in ranks),
        "scope": "gang",
        "schema_version": GANG_SCHEMA_VERSION,
        "world": int(world),
        "ranks_reported": len(ranks),
        "loss": sum(losses) / len(losses),
        # the gang advances at the slowest rank's pace — its window time
        # is the fleet's effective step time, its throughput the fleet's
        "step_time": step_times[slowest],
        "step_time_min": step_times[fastest],
        "step_time_median": _median(list(step_times.values())),
        "step_time_max": step_times[slowest],
        "step_time_min_rank": fastest,
        "step_time_max_rank": slowest,
        "tokens_per_sec": records[slowest].get("tokens_per_sec"),
        "samples_per_sec": records[slowest].get("samples_per_sec"),
        "mfu": (sum(mfus) / len(mfus)) if mfus else None,
        "global_batch_size": int(
            records[ranks[0]].get("global_batch_size") or 0),
    }
    if skews:
        worst = max(skews, key=lambda r: abs(float(skews[r])))
        merged["rank_skew_max"] = float(skews[worst])
        merged["rank_skew_max_rank"] = worst
    for name in GANG_COUNTERS:  # per-rank events summed to fleet totals
        merged[name] = sum(float(per_rank[r].get("counters", {})
                                 .get(name) or 0.0) for r in ranks)
    for name in GANG_HISTOGRAMS:  # rolling-window summaries, pooled
        hists = {r: per_rank[r].get("hists", {}).get(name) or {}
                 for r in ranks}
        total = sum(int(h.get("count") or 0) for h in hists.values())
        if not total:
            continue
        merged[f"{name}_mean"] = sum(
            float(h.get("mean") or 0.0) * int(h.get("count") or 0)
            for h in hists.values()) / total
        worst = max(ranks, key=lambda r: float(hists[r].get("max") or 0.0))
        merged[f"{name}_max"] = float(hists[worst].get("max") or 0.0)
        merged[f"{name}_max_rank"] = worst
    return merged


def merge_snapshots(snaps_by_rank: Dict[int, List[dict]],
                    world: int) -> List[dict]:
    """Every rank's pending snapshots → gang records, in window order.

    Windows are matched on the lockstep ``w`` counter; a window missing
    some ranks (a rank with observability off, or a mid-run join) still
    merges, with ``ranks_reported`` recording the actual coverage.
    """
    by_window: Dict[int, Dict[int, dict]] = {}
    for rank, snaps in snaps_by_rank.items():
        for snap in snaps or ():
            by_window.setdefault(int(snap["w"]), {})[int(rank)] = snap
    return [_merge_window(by_window[w], world)
            for w in sorted(by_window)]


def merge_rank_records(records_by_rank: Dict[Any, List[dict]],
                       world: Optional[int] = None) -> List[dict]:
    """Offline merge for ``tools/metrics_report.py``: align per-rank JSONL
    records positionally (windows are lockstep in gang mode) and run the
    same merge arithmetic the live path uses."""
    snaps: Dict[int, List[dict]] = {}
    for idx, (key, records) in enumerate(sorted(records_by_rank.items(),
                                                key=lambda kv: str(kv[0]))):
        rank = idx
        if records and isinstance(records[0].get("rank"), int):
            rank = records[0]["rank"]
        snaps[rank] = [{"w": w, "rank": rank, "record": rec,
                        "counters": {}}
                       for w, rec in enumerate(records)]
    return merge_snapshots(snaps, world or len(snaps))
