"""Retry/backoff policy with transient-vs-fatal exception classification
(copy of ``fleetx_tpu/resilience/policy.py``).

Large-run practice (Megatron-LM / OPT-175B logbooks, PAPERS.md) shows the
dominant recoverable failures are transient I/O: a checkpoint write hitting
a briefly-full or flaky filesystem, a download racing a network blip. The
reference delegates all of this to the Paddle substrate; here ONE policy
object owns the decision "retry or die" so checkpoint save/restore
(``core/checkpoint.py``) and artifact fetching (``utils/download.py``)
behave identically under pressure.

Classification is by exception type: ``OSError`` and friends (which
already cover ``ConnectionError``, ``TimeoutError`` and
``urllib.error.URLError``) are transient; everything else — a shape
mismatch, an assertion, a keyboard interrupt — is fatal and re-raises
immediately, because retrying a deterministic bug only delays the
traceback. Backoff is exponential with decorrelating jitter so a fleet of
hosts retrying a shared filesystem does not thundering-herd it.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass, field
from typing import Callable, Optional, Tuple, Type

from fleetx_tpu_torch.utils.log import logger

__all__ = ["RetryPolicy", "DEFAULT_POLICY", "is_transient", "call_with_retry",
           "retrying", "set_default_policy", "get_default_policy"]

#: exception classes worth a second attempt — I/O and environment, never
#: logic errors. TimeoutError/ConnectionError/URLError are OSError
#: subclasses already; listed types are matched with isinstance.
TRANSIENT_TYPES: Tuple[Type[BaseException], ...] = (OSError,)


@dataclass(frozen=True)
class RetryPolicy:
    """How many times to retry a transient failure, and how to back off.

    ``max_attempts`` counts TOTAL attempts (1 = no retries). Sleep before
    attempt ``n`` (n >= 2) is ``backoff_s * 2**(n-2)`` capped at
    ``max_backoff_s``, scaled by a uniform jitter in
    ``[1 - jitter, 1 + jitter]``.
    """

    max_attempts: int = 3
    backoff_s: float = 0.5
    max_backoff_s: float = 30.0
    jitter: float = 0.25
    transient_types: Tuple[Type[BaseException], ...] = \
        field(default=TRANSIENT_TYPES)

    def sleep_for(self, attempt: int, rng: Optional[random.Random] = None
                  ) -> float:
        """Backoff seconds before retry number ``attempt`` (1-based)."""
        base = min(self.backoff_s * (2.0 ** max(attempt - 1, 0)),
                   self.max_backoff_s)
        if self.jitter <= 0:
            return base
        r = rng if rng is not None else random
        return base * r.uniform(1.0 - self.jitter, 1.0 + self.jitter)

    @classmethod
    def from_cfg(cls, cfg: Optional[dict]) -> "RetryPolicy":
        """Build from a ``Resilience.retry`` config block (missing keys keep
        the dataclass defaults)."""
        cfg = dict(cfg or {})
        kwargs = {}
        for key in ("max_attempts", "backoff_s", "max_backoff_s", "jitter"):
            if cfg.get(key) is not None:
                cast = int if key == "max_attempts" else float
                kwargs[key] = cast(cfg[key])
        return cls(**kwargs)


DEFAULT_POLICY = RetryPolicy()

#: process-wide default used by checkpoint.py / download.py when no policy
#: is passed explicitly; the engine overrides it from the Resilience block
_active_policy: RetryPolicy = DEFAULT_POLICY


def set_default_policy(policy: Optional[RetryPolicy]) -> None:
    """Install the process-wide retry policy (None restores the default)."""
    global _active_policy
    _active_policy = policy if policy is not None else DEFAULT_POLICY


def get_default_policy() -> RetryPolicy:
    """The process-wide retry policy currently in effect."""
    return _active_policy


def is_transient(exc: BaseException,
                 policy: Optional[RetryPolicy] = None) -> bool:
    """True when ``exc`` is worth retrying under ``policy``.

    A :class:`~fleetx_tpu_torch.resilience.coordination.CoordinationTimeout` is
    categorically fatal — even under a custom policy with widened
    ``transient_types`` — because an expired agreement deadline means the
    GANG diverged: retrying one rank's call would advance it a generation
    past its peers and convert a detectable straggler into a silent hang.
    """
    from fleetx_tpu_torch.resilience.coordination import CoordinationTimeout

    if isinstance(exc, CoordinationTimeout):
        return False
    types = (policy or _active_policy).transient_types
    return isinstance(exc, types)


def call_with_retry(fn: Callable, *, policy: Optional[RetryPolicy] = None,
                    desc: str = "operation",
                    counter=None, sleep: Callable[[float], None] = time.sleep):
    """Run ``fn()`` retrying transient failures per ``policy``.

    ``counter`` (an observability ``Counter`` or None) is bumped once per
    retry, so ``ckpt_retries_total``-style telemetry reflects every
    absorbed failure. Fatal exceptions and exhausted policies re-raise the
    LAST error unchanged — callers keep their existing except clauses.
    """
    policy = policy or _active_policy
    attempts = max(int(policy.max_attempts), 1)
    for attempt in range(1, attempts + 1):
        try:
            return fn()
        except BaseException as e:  # noqa: BLE001 — classified below
            if not is_transient(e, policy) or attempt >= attempts:
                raise
            if counter is not None:
                counter.inc()
            delay = policy.sleep_for(attempt)
            logger.warning("%s failed (%s: %s) — retry %d/%d in %.2fs",
                           desc, type(e).__name__, e, attempt,
                           attempts - 1, delay)
            if delay > 0:
                sleep(delay)


def retrying(desc: str = "operation", policy: Optional[RetryPolicy] = None,
             counter=None) -> Callable:
    """Decorator form of ``call_with_retry`` for free functions."""
    def wrap(fn: Callable) -> Callable:
        def inner(*args, **kwargs):
            return call_with_retry(lambda: fn(*args, **kwargs),
                                   policy=policy, desc=desc, counter=counter)
        inner.__name__ = getattr(fn, "__name__", "retrying")
        inner.__doc__ = fn.__doc__
        return inner
    return wrap
