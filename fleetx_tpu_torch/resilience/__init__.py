"""Fault-tolerant training runtime (port of
``fleetx_tpu/resilience/__init__.py``; the ``Resilience`` facade :66-177).

One module per failure mode, as in the JAX package:

- ``policy``       — retry/backoff with jitter, transient-vs-fatal
  classification (checkpoint writes);
- ``preemption``   — SIGTERM/SIGINT → graceful checkpoint-and-exit at the
  next step boundary (also the serving replica's drain latch);
- ``guard``        — non-finite-streak / loss-spike policy with
  ``skip | rollback | abort`` actions;
- ``watchdog``     — hung-step heartbeat with stack dumps;
- ``faults``       — deterministic fault injection driving the drills;
- ``coordination`` — the agreement primitives, world-1 here;
- ``integrity``    — checkpoint digest manifests and verified restore.

``Resilience`` is the engine-facing facade built from the
``Resilience:`` YAML block: with the block absent or disabled every hook
is inert — no signal handlers, no threads, no per-step check — and the
process-wide fault plan, retry policy and agreement deadlines are reset,
so nothing leaks in from an engine built before. Recovery events surface
as counters of the shared registry (``nonfinite_skips``,
``nonfinite_windows``, ``rollbacks_total``, ``ckpt_retries_total``,
``preemption_exits``, ``watchdog_stalls``).

Not ported here: the SDC sentinel (``integrity.sentinel_every`` above 0
raises, ROADMAP.md, port queue item 8) and the gang watchdog
(``watchdog.gang_sync_steps`` above 0, item 12). Checkpoint manifests are
written and verified whatever ``enable`` says.
"""

from __future__ import annotations

from typing import Optional

from fleetx_tpu_torch.observability.metrics import get_registry
from fleetx_tpu_torch.resilience import coordination
from fleetx_tpu_torch.resilience import faults as faults_mod
from fleetx_tpu_torch.resilience.coordination import (  # noqa: F401
    CoordinationTimeout, get_coordinator, most_severe)
from fleetx_tpu_torch.resilience.faults import (  # noqa: F401
    FaultPlan, InjectedFault)
from fleetx_tpu_torch.resilience.guard import (  # noqa: F401
    TrainingAborted, TrainingGuard)
from fleetx_tpu_torch.resilience.policy import (  # noqa: F401
    RetryPolicy, call_with_retry, is_transient, set_default_policy)
from fleetx_tpu_torch.resilience.preemption import (  # noqa: F401
    PreemptionHandler)
from fleetx_tpu_torch.resilience.watchdog import StepWatchdog  # noqa: F401

__all__ = [
    "Resilience", "RetryPolicy", "TrainingGuard", "TrainingAborted",
    "PreemptionHandler", "StepWatchdog", "FaultPlan", "InjectedFault",
    "CoordinationTimeout", "call_with_retry", "is_transient",
    "set_default_policy", "get_coordinator", "most_severe",
]

#: SDC sentinel actions, in the order the Integrity docs list them
SENTINEL_ACTIONS = ("log", "quarantine", "abort")


def _on(value, default: bool = True) -> bool:
    """A config value as a bool, with ``None``/absent meaning
    ``default``."""
    return default if value is None else bool(value)


class Resilience:
    """Engine-facing facade over retry policy, guard, watchdog, preemption
    and fault injection, built once per engine from the ``Resilience:``
    config block."""

    def __init__(self, cfg: Optional[dict] = None):
        cfg = dict(cfg or {})
        self.enabled = bool(cfg.get("enable"))
        self.registry = get_registry()
        self.auto_resume = self.enabled and _on(cfg.get("auto_resume"))
        self.retry_policy = RetryPolicy.from_cfg(cfg.get("retry"))
        self.guard: Optional[TrainingGuard] = None
        self.guard_skip = False
        self.preemption: Optional[PreemptionHandler] = None
        self.preemption_save = True
        self.preemption_exit_code = 0
        self.watchdog_enabled = False
        self._watchdog_cfg: dict = {}
        self.faults = FaultPlan()
        if not self.enabled:
            # inert AND isolating: a disabled engine must not inherit a
            # previous engine's armed fault plan, tuned retry policy or
            # agreement deadlines
            faults_mod.install_plan(None)
            set_default_policy(None)
            coordination.configure(None, None)
            return
        integ_cfg = dict(cfg.get("integrity") or {})
        if int(integ_cfg.get("sentinel_every") or 0) > 0:
            raise NotImplementedError(
                "Resilience.integrity.sentinel_every > 0 (the SDC sentinel) "
                "is not ported yet (ROADMAP.md, port queue item 8)")
        action = str(integ_cfg.get("sentinel_action") or "log")
        if action not in SENTINEL_ACTIONS:
            raise ValueError(
                f"Resilience.integrity.sentinel_action must be one of "
                f"{SENTINEL_ACTIONS}, got {action!r}")
        coord_cfg = dict(cfg.get("coordination") or {})
        coordination.configure(coord_cfg.get("timeout_s"),
                               coord_cfg.get("poll_s"))
        # the process-wide default policy: checkpoint writes retry under
        # the engine's Resilience.retry settings
        set_default_policy(self.retry_policy)
        guard_cfg = dict(cfg.get("guard") or {})
        if _on(guard_cfg.get("enable")):
            # extend the fp16 scaler's in-step non-finite skip to every
            # dtype: a non-finite update is dropped, params survive
            self.guard_skip = _on(guard_cfg.get("skip_nonfinite_update"))
            self.guard = TrainingGuard.from_cfg(guard_cfg,
                                                skip_active=self.guard_skip,
                                                registry=self.registry)
        pre_cfg = dict(cfg.get("preemption") or {})
        if _on(pre_cfg.get("enable")):
            self.preemption = PreemptionHandler(pre_cfg.get("signals"))
        self.preemption_save = _on(pre_cfg.get("save_on_exit"))
        self.preemption_exit_code = int(pre_cfg.get("exit_code") or 0)
        wd_cfg = dict(cfg.get("watchdog") or {})
        self.watchdog_enabled = bool(wd_cfg.get("enable"))
        if self.watchdog_enabled and \
                int(wd_cfg.get("gang_sync_steps") or 0) > 0:
            raise NotImplementedError(
                "Resilience.watchdog.gang_sync_steps > 0 (the gang "
                "watchdog) needs a multi-process gang, not ported yet "
                "(ROADMAP.md, port queue item 12)")
        self._watchdog_cfg = wd_cfg
        self.faults = FaultPlan.from_cfg(cfg.get("faults"))
        # module-level install so core/checkpoint.py's injection points
        # fire without config plumbing (cleared when this plan is unarmed)
        faults_mod.install_plan(self.faults)

    @property
    def preempted(self) -> bool:
        """True once a graceful-shutdown signal has been latched."""
        return self.preemption is not None and self.preemption.triggered

    def make_watchdog(self, on_stall=None) -> Optional[StepWatchdog]:
        """A fresh (un-started) watchdog per fit, or None when disabled."""
        if not (self.enabled and self.watchdog_enabled):
            return None
        return StepWatchdog.from_cfg(self._watchdog_cfg, on_stall=on_stall,
                                     registry=self.registry)
