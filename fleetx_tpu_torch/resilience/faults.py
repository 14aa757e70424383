"""Deterministic fault injection for the training and checkpoint drills
(port of ``fleetx_tpu/resilience/faults.py``: ``FaultPlan`` :112-245 with
its training and checkpoint knobs and ``take_bitflip``, ``fire`` / ``fire_path`` :292-313, the
module-level plan :280-327 and ``_corrupt_payload`` :330).

``FaultPlan`` injects failures at exact, reproducible points so the
tests and ``chip_smoke.py`` drive the real recovery machinery:

- ``data_raise_at: K``       — raise from the data path at batch index K
  (the engine's global step numbering), once;
- ``nan_loss_at: [K, ...]``  — poison those batches' ``loss_mask`` with
  NaN, so the step's loss and grads are genuinely non-finite;
- ``sigterm_at: K``          — SIGTERM our own process before step K on
  a fresh run (a preemption);
- ``ckpt_write_fail_times: N`` — the first N checkpoint writes raise a
  transient ``InjectedFault`` (an ``OSError``) the retry policy absorbs;
- ``bitflip_param_at: K``    — flip one bit of a parameter after step K
  (the silent memory corruption the SDC sentinel's fingerprint sees;
  ``EagerEngine._apply_bitflip``);
- ``corrupt_ckpt_at: K``     — flip a byte of step K's just-written
  payload, sticky across write retries (the save-side read-back must
  refuse the step);
- ``corrupt_restore_at: K``  — flip a byte of step K's payload just
  before a restore reads it (the restore falls back to the newest step
  that verifies);
- ``only_rank: R``           — arm the plan on rank R alone.

Plans come from the ``Resilience.faults`` config block or the
``FLEETX_FAULTS`` env var (``"sigterm_at=5,ckpt_write_fail_times=1,
nan_loss_at=4:5"``), env winning per key. The module-level active plan
lets ``core/checkpoint.py`` reach its injection points without config
plumbing.

The other knobs of the JAX plan raise ``NotImplementedError``:
``slow_decode_ms_at``, ``blackhole_after`` and ``crash_mid_write`` are
the serving replica's chaos knobs (ROADMAP.md, port queue item 5).
"""

from __future__ import annotations

import os
import signal
from typing import Any, Optional

import numpy as np

from fleetx_tpu_torch.utils.log import logger

__all__ = ["FaultPlan", "InjectedFault", "install_plan", "active_plan",
           "fire", "fire_path", "ENV_VAR", "NOT_PORTED"]

ENV_VAR = "FLEETX_FAULTS"

#: knob → the ROADMAP port-queue item that brings it
NOT_PORTED = {"slow_decode_ms_at": 5, "blackhole_after": 5,
              "crash_mid_write": 5}


class InjectedFault(OSError):
    """Injected transient failure — an ``OSError`` so the retry policy
    classifies it exactly like the real I/O error it stands in for."""


def _this_rank(override: Optional[int] = None) -> int:
    """This process's rank (0 unless ``torch.distributed`` is up)."""
    if override is not None:
        return int(override)
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return int(dist.get_rank())
    return 0


def _parse_env(spec: str) -> dict:
    """``k=v,k=v`` with ``:``-separated int lists → a faults config dict."""
    out: dict = {}
    for part in spec.split(","):
        part = part.strip()
        if not part or "=" not in part:
            continue
        key, value = part.split("=", 1)
        if ":" in value:
            out[key.strip()] = [int(v) for v in value.split(":") if v]
        else:
            out[key.strip()] = int(value)
    return out


class FaultPlan:
    """One run's worth of armed faults; every method is a cheap no-op when
    its fault is not armed."""

    def __init__(self, data_raise_at: Optional[int] = None,
                 nan_loss_at: Optional[list] = None,
                 sigterm_at: Optional[int] = None,
                 ckpt_write_fail_times: int = 0,
                 bitflip_param_at: Optional[int] = None,
                 corrupt_ckpt_at: Optional[int] = None,
                 corrupt_restore_at: Optional[int] = None):
        self.data_raise_at = data_raise_at
        self.nan_loss_at = set(int(s) for s in (nan_loss_at or ()))
        self.sigterm_at = sigterm_at
        self.ckpt_write_fail_times = int(ckpt_write_fail_times or 0)
        self.bitflip_param_at = bitflip_param_at
        self.corrupt_ckpt_at = corrupt_ckpt_at
        self.corrupt_restore_at = corrupt_restore_at

    @classmethod
    def from_cfg(cls, cfg: Optional[dict], env: Optional[str] = None,
                 rank: Optional[int] = None) -> "FaultPlan":
        """Merge the config block and the env spec (env wins per key).

        ``only_rank`` arms the plan on that rank alone: every other rank
        gets an empty plan. ``rank`` overrides the rank lookup (tests).
        """
        merged = dict(cfg or {})
        env = os.environ.get(ENV_VAR) if env is None else env
        if env:
            merged.update(_parse_env(env))
        for key, item in NOT_PORTED.items():
            if merged.get(key) is not None:
                raise NotImplementedError(
                    f"Resilience.faults.{key} is not ported yet (ROADMAP.md, "
                    f"port queue item {item})")
        only = merged.get("only_rank")
        if only is not None and int(only) != _this_rank(rank):
            logger.info("fault plan targets rank %d only — disarmed on "
                        "rank %d", int(only), _this_rank(rank))
            return cls()
        nan_at = merged.get("nan_loss_at")
        if isinstance(nan_at, int):
            nan_at = [nan_at]

        def opt_int(key: str) -> Optional[int]:
            return None if merged.get(key) is None else int(merged[key])

        return cls(
            data_raise_at=opt_int("data_raise_at"),
            nan_loss_at=nan_at,
            sigterm_at=opt_int("sigterm_at"),
            ckpt_write_fail_times=int(merged.get("ckpt_write_fail_times")
                                      or 0),
            bitflip_param_at=opt_int("bitflip_param_at"),
            corrupt_ckpt_at=opt_int("corrupt_ckpt_at"),
            corrupt_restore_at=opt_int("corrupt_restore_at"))

    @property
    def armed(self) -> bool:
        """True when any fault is configured."""
        return bool(self.data_raise_at is not None or self.nan_loss_at
                    or self.sigterm_at is not None
                    or self.ckpt_write_fail_times
                    or self.bitflip_param_at is not None
                    or self.corrupt_ckpt_at is not None
                    or self.corrupt_restore_at is not None)

    # ------------------------------------------------------------- triggers
    def on_batch(self, index: int, batch: Any) -> Any:
        """Data-path hook on a host batch: raise or poison at batch
        ``index``, else pass ``batch`` through untouched."""
        if self.data_raise_at is not None and index == self.data_raise_at:
            self.data_raise_at = None  # once
            raise InjectedFault(
                f"injected data-path failure at batch {index}")
        if index in self.nan_loss_at and isinstance(batch, dict) and \
                "loss_mask" in batch:
            logger.warning("fault injection: NaN loss_mask at batch %d",
                           index)
            mask = np.asarray(batch["loss_mask"], dtype=np.float32).copy()
            mask[...] = np.nan
            batch = dict(batch, loss_mask=mask)
        return batch

    def maybe_sigterm(self, step: int, start_step: int = 0) -> None:
        """Send SIGTERM to our own process before step ``step`` (once), on
        a fresh run only (``start_step == 0``): a resumed process sails
        past the injection point."""
        if start_step:
            return
        if self.sigterm_at is not None and step >= self.sigterm_at:
            self.sigterm_at = None
            logger.warning("fault injection: SIGTERM self at step %d", step)
            os.kill(os.getpid(), signal.SIGTERM)

    def take_bitflip(self, step: int) -> bool:
        """True (once) when the parameter bit-flip is due at ``step``: the
        engine then flips one bit of its live parameters."""
        if self.bitflip_param_at is not None and \
                step >= self.bitflip_param_at:
            self.bitflip_param_at = None
            return True
        return False

    def fire(self, point: str) -> None:
        """Named-point hook for deep layers (``"ckpt_write"``)."""
        if point == "ckpt_write" and self.ckpt_write_fail_times > 0:
            self.ckpt_write_fail_times -= 1
            raise InjectedFault("injected checkpoint-write failure")

    def fire_path(self, point: str, path: str, step: int) -> None:
        """Corruption hooks keyed on a checkpoint step directory:
        ``"ckpt_written"`` after step ``corrupt_ckpt_at``'s state write
        (sticky: every retry's rewrite is re-corrupted), ``"ckpt_restore"``
        before step ``corrupt_restore_at`` is read back."""
        due = {"ckpt_written": self.corrupt_ckpt_at,
               "ckpt_restore": self.corrupt_restore_at}.get(point)
        if due is not None and int(step) == int(due):
            _corrupt_payload(path, point)


# ---------------------------------------------------------------------------
# Module-level active plan (checkpoint.py consults it without plumbing)
# ---------------------------------------------------------------------------

_active: Optional[FaultPlan] = None


def install_plan(plan: Optional[FaultPlan]) -> None:
    """Install (or clear, with None) the process-wide fault plan."""
    global _active
    _active = plan if plan is not None and plan.armed else None
    if _active is not None:
        logger.warning("fault-injection plan armed: %s", vars(plan))


def active_plan() -> Optional[FaultPlan]:
    """The armed process-wide plan, if any."""
    return _active


def fire(point: str) -> None:
    """Trigger the named injection point on the active plan (no-op when
    nothing is armed)."""
    if _active is not None:
        _active.fire(point)


def fire_path(point: str, path: str, step: int) -> None:
    """Trigger a path-keyed corruption point on the active plan (no-op
    when nothing is armed)."""
    if _active is not None:
        _active.fire_path(point, path, step)


def _corrupt_payload(path: str, point: str) -> None:
    """Flip one byte in the middle of the first payload file under
    ``path`` (sorted walk, metadata markers skipped)."""
    from fleetx_tpu_torch.resilience import integrity

    for rel in integrity._payload_files(path):
        target = os.path.join(path, rel)
        size = os.path.getsize(target)
        if size == 0:
            continue
        offset = size // 2
        with open(target, "r+b") as f:
            f.seek(offset)
            byte = f.read(1)
            f.seek(offset)
            f.write(bytes([byte[0] ^ 0xFF]))
        logger.warning("fault injection: corrupted byte %d of %s (%s)",
                       offset, target, point)
        return
    logger.warning("fault injection: no payload file to corrupt under %s",
                   path)
