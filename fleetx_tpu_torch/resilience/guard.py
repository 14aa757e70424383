"""TrainingGuard: loss-health policy — non-finite streaks and loss spikes
(copy of ``fleetx_tpu/resilience/guard.py``).

The engine's in-step ``isfinite`` skip (historically fp16-scaler-only,
``eager_engine.py``) protects ONE step: a non-finite update is dropped and
the parameters survive. What it cannot do is decide when a run has gone
bad — a NaN *streak* means the data or the optimizer state is poisoned and
skipping forever just burns chips, and a sudden loss blow-up (OPT-175B
logbook's dominant "restart from an earlier checkpoint" trigger) often
precedes the NaNs. ``TrainingGuard`` owns that policy host-side:

- a consecutive non-finite counter with a configurable action once the
  streak reaches ``nonfinite_streak``: ``skip`` (tolerate and count),
  ``rollback`` (restore the last good checkpoint and rewind the data
  position), or ``abort``;
- an EWMA loss-spike detector (``loss > spike_factor × ewma`` after a
  warmup) with the same action set;
- a ``max_rollbacks`` budget so a deterministically-poisoned run escalates
  to ``abort`` instead of rollback-looping forever.

The guard only *decides*; the engine executes rollbacks and aborts. All
decisions surface as registry counters (``nonfinite_skips``,
``loss_spikes_total``, ``rollbacks_total`` from the engine side).
"""

from __future__ import annotations

import math
from typing import Optional

from fleetx_tpu_torch.observability import flight
from fleetx_tpu_torch.observability.metrics import get_registry
from fleetx_tpu_torch.utils.log import logger

__all__ = ["TrainingGuard", "TrainingAborted", "ACTIONS"]

ACTIONS = ("skip", "rollback", "abort")


class TrainingAborted(RuntimeError):
    """Raised by the engine when the guard (or a failed rollback) decides
    the run cannot continue — distinct from arbitrary crashes so
    supervisors can treat it as non-retryable."""


class TrainingGuard:
    """Streak/spike policy over the host-observed loss sequence.

    ``observe()`` is called once per logging window with the synced loss
    (and the step fn's device-computed ``finite`` flag when available) and
    returns ``None`` (healthy / tolerated), ``"rollback"`` or ``"abort"``.
    Granularity is therefore the logging window — with ``logging_freq: 1``
    every step is inspected.
    """

    def __init__(self, nonfinite_action: str = "skip",
                 nonfinite_streak: int = 3,
                 spike_action: str = "skip",
                 spike_factor: Optional[float] = None,
                 spike_ewma_alpha: float = 0.1,
                 spike_min_steps: int = 20,
                 max_rollbacks: int = 3,
                 skip_active: bool = True,
                 registry=None):
        assert nonfinite_action in ACTIONS, nonfinite_action
        assert spike_action in ACTIONS, spike_action
        self.nonfinite_action = nonfinite_action
        self.nonfinite_streak = max(int(nonfinite_streak), 1)
        self.spike_action = spike_action
        self.spike_factor = float(spike_factor) if spike_factor else None
        self.spike_ewma_alpha = float(spike_ewma_alpha)
        self.spike_min_steps = max(int(spike_min_steps), 1)
        self.max_rollbacks = max(int(max_rollbacks), 0)
        # honest counter naming: a window only counts as a SKIP when the
        # in-step update-skip is actually active; otherwise the update
        # landed and the event is recorded as nonfinite_windows
        self.skip_active = bool(skip_active)
        self.registry = registry or get_registry()
        self._streak = 0
        self._ewma: Optional[float] = None
        self._observed = 0
        self._rollbacks = 0

    @classmethod
    def from_cfg(cls, cfg: Optional[dict], skip_active: bool = True,
                 registry=None) -> "TrainingGuard":
        """Build from a ``Resilience.guard`` config block."""
        cfg = dict(cfg or {})
        return cls(
            nonfinite_action=str(cfg.get("nonfinite_action") or "skip"),
            nonfinite_streak=int(cfg.get("nonfinite_streak") or 3),
            spike_action=str(cfg.get("spike_action") or "skip"),
            spike_factor=cfg.get("spike_factor"),
            spike_ewma_alpha=float(cfg.get("spike_ewma_alpha") or 0.1),
            spike_min_steps=int(cfg.get("spike_min_steps") or 20),
            max_rollbacks=int(3 if cfg.get("max_rollbacks") is None
                              else cfg.get("max_rollbacks")),
            skip_active=skip_active, registry=registry)

    # --------------------------------------------------------------- policy
    def observe(self, step: int, loss: float,
                finite: Optional[bool] = None) -> Optional[str]:
        """Feed one window's loss; returns the action the engine must take.

        ``finite`` is the device-side flag from the step fn when present
        (it also covers grad norms); otherwise finiteness of ``loss``
        decides.
        """
        self._observed += 1
        ok = bool(finite) if finite is not None else math.isfinite(loss)
        if not ok:
            self._streak += 1
            # granularity is the observation window (one per logging_freq
            # steps): with the in-step skip active the window's update was
            # dropped on-device; without it the update landed and only the
            # observation is recorded
            self.registry.counter("nonfinite_skips" if self.skip_active
                                  else "nonfinite_windows").inc()
            # the flight ring wants the streak's BUILD-UP, not just the
            # final decision — a crash dump should show the run going bad
            flight.note("guard", "nonfinite", step=int(step),
                        streak=self._streak)
            logger.warning("non-finite loss at step %d (streak %d/%d, "
                           "action=%s)", step, self._streak,
                           self.nonfinite_streak, self.nonfinite_action)
            if self._streak >= self.nonfinite_streak:
                return self._escalate(self.nonfinite_action,
                                      f"non-finite streak of {self._streak}")
            return None
        self._streak = 0
        if self.spike_factor and self._ewma is not None and \
                self._observed > self.spike_min_steps and \
                loss > self.spike_factor * self._ewma:
            self.registry.counter("loss_spikes_total").inc()
            flight.note("guard", "loss_spike", step=int(step),
                        loss=float(loss), ewma=float(self._ewma))
            logger.warning("loss spike at step %d: %.4g > %.1fx ewma %.4g "
                           "(action=%s)", step, loss, self.spike_factor,
                           self._ewma, self.spike_action)
            decision = self._escalate(self.spike_action,
                                      f"loss spike {loss:.4g}")
            # a tolerated spike must not drag the EWMA up toward the spike
            # (that would mask a slow divergence); skip the update
            return decision
        a = self.spike_ewma_alpha
        self._ewma = (loss if self._ewma is None
                      else a * loss + (1.0 - a) * self._ewma)
        return None

    def _escalate(self, action: str, why: str) -> Optional[str]:
        """Map a tripped detector to the engine-facing decision."""
        if action == "skip":
            return None  # tolerate: the in-step skip already protected params
        if action == "rollback":
            if self._rollbacks >= self.max_rollbacks:
                logger.error("%s: rollback budget exhausted (%d) — aborting",
                             why, self.max_rollbacks)
                return "abort"
            return "rollback"
        return "abort"

    # ------------------------------------------------------------ lifecycle
    def note_rollback(self) -> None:
        """Engine notifies a completed rollback: reset streak/EWMA state and
        spend one unit of the rollback budget."""
        self._rollbacks += 1
        self._streak = 0
        self._ewma = None
        self._observed = 0

    @property
    def rollbacks(self) -> int:
        """Rollbacks performed so far (budget accounting)."""
        return self._rollbacks
