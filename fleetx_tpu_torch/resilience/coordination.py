"""Cross-process agreement primitives for gangs (port of
``fleetx_tpu/resilience/coordination.py``: ``configure`` :58,
``CoordinationTimeout`` :67, ``most_severe`` :87, ``LocalCoordinator``
:102-129, ``DistributedCoordinator`` :137-340, ``get_coordinator`` /
``reset_coordinator`` :343-382).

Every recovery decision of the engine (the resume step, the guard's
verdict, the rollback step, the loop's exits, the commit of a save, the
SDC census) goes through a coordinator, so a gang of processes takes each
decision together:

- ``barrier(name)``        — timed rendezvous; a timeout reports *which
  ranks arrived* (the straggler set a hung-gang post-mortem needs);
- ``broadcast(name, v)``   — rank 0's JSON-serializable value to everyone;
- ``any_flag(name, f)``    — OR across ranks (one rank's SIGTERM latches
  preemption everywhere);
- ``all_gather(name, v)``  — every rank's value;
- ``majority(name, v)``    — most common value, deterministic tie-break.

The distributed form runs over the gang's ``torch.distributed.TCPStore``
(``utils/env.get_store``, under the ``fleetx/coord`` prefix), NOT over a
collective of the process group: the store can time out and say who is
missing, where a wedged gloo or NCCL collective says nothing. A wait that
expires (``DistStoreError`` from ``wait``) is a straggler census; a store
that fails (``DistNetworkError``: the store's host is gone) raises at
once, within the deadline. ``TCPStore`` lists no keys, so the arrival
census probes each rank's key with ``check``.

Calls are generation-counted per name: every rank must invoke the same
primitives in the same order (they are collectives). A process-lifetime
singleton (``get_coordinator``) keeps the generation counters monotonic
across engine rebuilds. Importing the module does not import torch.
"""

from __future__ import annotations

import datetime
import json
import time
from collections import Counter, defaultdict
from typing import Any, Dict, Iterable, Optional

from fleetx_tpu_torch.observability import gang as obs_gang
from fleetx_tpu_torch.utils.log import logger

__all__ = ["CoordinationTimeout", "LocalCoordinator", "DistributedCoordinator",
           "get_coordinator", "reset_coordinator", "configure",
           "most_severe", "DEFAULT_TIMEOUT_S"]

#: default agreement deadline — generous enough to ride out a checkpoint
#: restore on the slowest rank, small enough that a wedged gang surfaces
#: within one scheduler health-check interval
DEFAULT_TIMEOUT_S = 600.0
_DEFAULT_POLL_S = 0.05

_timeout_s = DEFAULT_TIMEOUT_S
_poll_s = _DEFAULT_POLL_S

#: the prefix of the agreements' keys in the gang's store
NAMESPACE = "fleetx/coord"


def configure(timeout_s: Optional[float] = None,
              poll_s: Optional[float] = None) -> None:
    """Set module-wide agreement defaults from ``Resilience.coordination``
    (None resets a knob to its built-in default)."""
    global _timeout_s, _poll_s
    _timeout_s = DEFAULT_TIMEOUT_S if timeout_s is None else float(timeout_s)
    _poll_s = _DEFAULT_POLL_S if poll_s is None else float(poll_s)


class CoordinationTimeout(RuntimeError):
    """An agreement deadline expired — carries the arrival census
    (``arrived`` / ``missing`` rank sets: the missing set is the
    straggler or crash suspect list)."""

    def __init__(self, name: str, arrived: Iterable[int],
                 missing: Iterable[int], timeout_s: float):
        self.name = name
        self.arrived = sorted(arrived)
        self.missing = sorted(missing)
        self.timeout_s = timeout_s
        super().__init__(
            f"coordination '{name}' timed out after {timeout_s:.1f}s: "
            f"arrived ranks {self.arrived}, missing ranks {self.missing}")


def most_severe(decisions: Iterable[Optional[str]]) -> Optional[str]:
    """Combine per-rank guard decisions into the gang's decision.

    Severity: ``None`` (healthy/tolerated) < ``"rollback"`` < ``"abort"``
    — any rank's rollback rolls everyone back, any abort aborts everyone.
    """
    rank = {None: 0, "rollback": 1, "abort": 2}
    worst = None
    for d in decisions:
        if rank.get(d, 0) > rank.get(worst, 0):
            worst = d
    return worst


class LocalCoordinator:
    """The world-1 coordinator: every agreement is this process's own
    value."""

    rank = 0
    world = 1

    def barrier(self, name: str, timeout_s: Optional[float] = None) -> None:
        """Trivially satisfied with one process."""

    def broadcast(self, name: str, value: Any = None,
                  timeout_s: Optional[float] = None) -> Any:
        """Rank 0 is the only rank: its value is the agreement."""
        return value

    def any_flag(self, name: str, flag: bool,
                 timeout_s: Optional[float] = None) -> bool:
        """OR over one rank."""
        return bool(flag)

    def all_gather(self, name: str, value: Any = None,
                   timeout_s: Optional[float] = None) -> Dict[int, Any]:
        """One-entry census."""
        return {0: value}

    def majority(self, name: str, value: Any = None,
                 timeout_s: Optional[float] = None) -> Any:
        """A one-vote election."""
        return value


def _is_expiry(exc: BaseException) -> bool:
    """Whether a store error is a wait that ran out of time
    (``DistStoreError``), not a failed store."""
    try:
        from torch.distributed import DistStoreError
    except ImportError:  # a torch without the distributed errors
        return False
    return isinstance(exc, DistStoreError)


class DistributedCoordinator:
    """Store implementation over ``torch.distributed.TCPStore``'s API
    (``set``, ``get``, ``wait``, ``check``, ``delete_key``).

    ``all_gather`` is the base primitive: every rank publishes
    ``<name>/<generation>/<rank>`` and waits on each peer's key (the
    store's server-side ``wait``: a rendezvous costs the actual rank
    skew, not a poll quantum) until all ``world`` ranks appear or the
    deadline expires — expiry raises :class:`CoordinationTimeout` with
    the arrival census. Barrier/any_flag/majority derive from it.
    ``broadcast`` is the one asymmetric call: rank 0 publishes, everyone
    else waits for its key.

    A rank deletes its *previous* generation's key when a new generation
    of the same name completes: observing all ranks in generation ``g``
    proves every rank finished ``g-1``, so the old keys are dead and the
    store stays bounded over million-step runs.
    """

    def __init__(self, store, rank: int, world: int):
        assert world >= 1 and 0 <= rank < world, (rank, world)
        self._store = store
        self.rank = int(rank)
        self.world = int(world)
        self._gen: Dict[str, int] = defaultdict(int)

    # ------------------------------------------------------------- internals
    @staticmethod
    def _prefix(name: str, gen: int) -> str:
        return f"{name}/{gen}"

    def _get(self, key: str) -> str:
        value = self._store.get(key)
        return value.decode() if isinstance(value, bytes) else str(value)

    def _await_key(self, key: str, remaining_s: float) -> Optional[str]:
        """Block until ``key`` exists (returning its payload) or
        ``remaining_s`` elapses (returning ``None``).

        Uses the store's server-side ``wait``; a wait that raises well
        before the deadline is a store failure, not an expiry, and is
        re-raised rather than reported as a straggler census (JAX's rule,
        ``_await_key`` :177-205).
        """
        t0 = time.monotonic()
        try:
            self._store.wait([key], datetime.timedelta(
                seconds=max(remaining_s, 0.001)))
        except Exception as e:  # noqa: BLE001 — classified below
            if not _is_expiry(e) or \
                    time.monotonic() - t0 < remaining_s * 0.9:
                # a failed store (its host gone, a dropped connection):
                # re-raise, healthy peers are not stragglers
                raise
            return None
        return self._get(key)

    def _arrived(self, prefix: str) -> Dict[int, str]:
        """Ranks that have published under ``prefix`` → their payloads
        (each rank's key probed: the store lists no keys)."""
        out: Dict[int, str] = {}
        for rank in range(self.world):
            key = f"{prefix}/{rank}"
            try:
                if self._store.check([key]):
                    out[rank] = self._get(key)
            except Exception:  # noqa: BLE001 — the census is best-effort
                pass
        return out

    def _gc_previous(self, name: str, gen: int) -> None:
        """Drop our own key from the completed previous generation."""
        if gen <= 0:
            return
        try:
            self._store.delete_key(
                f"{self._prefix(name, gen - 1)}/{self.rank}")
        except Exception:  # noqa: BLE001 — GC is best-effort
            pass

    # ------------------------------------------------------------ primitives
    def all_gather(self, name: str, value: Any = None,
                   timeout_s: Optional[float] = None) -> Dict[int, Any]:
        """Every rank's ``value`` for this generation of ``name``.

        Every payload rides in a ``{"__v": value, "__t": publish-time}``
        envelope: the entry-to-completion wait lands in the
        ``barrier_wait_ms`` histogram and the per-rank arrival census
        feeds the rolling straggler-skew estimate
        (``observability/gang.note_agreement``).
        """
        gen = self._gen[name]
        self._gen[name] += 1
        prefix = self._prefix(name, gen)
        t_entry = time.monotonic()
        own = json.dumps({"__v": value, "__t": time.time()})
        self._store.set(f"{prefix}/{self.rank}", own)
        timeout = _timeout_s if timeout_s is None else float(timeout_s)
        deadline = time.monotonic() + timeout
        # the per-peer waits return every payload (own value is known
        # locally): a success needs no census probe, which matters on the
        # once-per-step loop_flags vote
        payloads = {self.rank: own}
        for peer in range(self.world):
            if peer == self.rank:
                continue
            remaining = deadline - time.monotonic()
            payload = (self._await_key(f"{prefix}/{peer}", remaining)
                       if remaining > 0 else None)
            if payload is None:
                arrived = self._arrived(prefix)
                missing = set(range(self.world)) - set(arrived)
                obs_gang.note_timeout(f"{name}#{gen}", arrived, missing)
                raise CoordinationTimeout(f"{name}#{gen}", arrived, missing,
                                          timeout)
            payloads[peer] = payload
        self._gc_previous(name, gen)
        values: Dict[int, Any] = {}
        arrivals: Dict[int, float] = {}
        for rank, payload in payloads.items():
            decoded = json.loads(payload)
            values[rank] = decoded["__v"]
            arrivals[rank] = float(decoded["__t"])
        obs_gang.note_agreement(name, time.monotonic() - t_entry,
                                arrivals=arrivals, rank=self.rank,
                                world=self.world)
        return values

    def barrier(self, name: str, timeout_s: Optional[float] = None) -> None:
        """Timed rendezvous; :class:`CoordinationTimeout` names stragglers."""
        self.all_gather(name, None, timeout_s=timeout_s)

    def broadcast(self, name: str, value: Any = None,
                  timeout_s: Optional[float] = None) -> Any:
        """Rank 0's JSON-serializable ``value``, delivered to every rank."""
        gen = self._gen[name]
        self._gen[name] += 1
        key = f"{self._prefix(name, gen)}/0"
        if self.rank == 0:
            self._store.set(key, json.dumps(value))
            return value
        t_entry = time.monotonic()
        timeout = _timeout_s if timeout_s is None else float(timeout_s)
        payload = self._await_key(key, timeout)
        if payload is None:
            # the census is the set of PUBLISHED keys; a broadcast waiter
            # never writes one, so it must not report itself as arrived
            obs_gang.note_timeout(f"{name}#{gen}", [], [0])
            raise CoordinationTimeout(f"{name}#{gen}", [], [0], timeout)
        # wait histogram only — the one-publisher shape has no arrival
        # census to feed the skew estimate
        obs_gang.note_agreement(name, time.monotonic() - t_entry,
                                rank=self.rank, world=self.world)
        return json.loads(payload)

    def any_flag(self, name: str, flag: bool,
                 timeout_s: Optional[float] = None) -> bool:
        """True once ANY rank raised ``flag`` this generation."""
        votes = self.all_gather(name, bool(flag), timeout_s=timeout_s)
        return any(votes.values())

    def majority(self, name: str, value: Any = None,
                 timeout_s: Optional[float] = None) -> Any:
        """The most common value; ties break toward the lowest-rank holder
        so every rank resolves the same winner."""
        votes = self.all_gather(name, value, timeout_s=timeout_s)
        counts = Counter(json.dumps(v, sort_keys=True)
                         for v in votes.values())
        best = max(counts.items(),
                   key=lambda kv: (kv[1], -self._first_holder(votes, kv[0])))
        return json.loads(best[0])

    @staticmethod
    def _first_holder(votes: Dict[int, Any], encoded: str) -> int:
        """Lowest rank holding ``encoded`` (tie-break anchor)."""
        for rank in sorted(votes):
            if json.dumps(votes[rank], sort_keys=True) == encoded:
                return rank
        return 0


# ---------------------------------------------------------------------------
# Process-lifetime singleton
# ---------------------------------------------------------------------------

_coordinator = None


def get_coordinator():
    """The process-wide coordinator (built on first use).

    Distributed when the process group has more than one rank (over a
    ``PrefixStore`` of the gang's store), the world-1 one otherwise. A
    group of more than one rank without the gang's store raises: a gang
    never falls back to deciding alone. The instance persists until the
    process leaves the group (``utils/env.close_dist_env``), so generation
    counters stay monotonic across engine rebuilds.
    """
    global _coordinator
    if _coordinator is not None:
        return _coordinator
    from fleetx_tpu_torch.utils.env import get_rank, get_store, get_world_size

    world = get_world_size()
    if world > 1:
        store = get_store()
        if store is None:
            raise RuntimeError(
                f"a process group of {world} ranks without the gang's "
                f"store: join it through utils/env.init_dist_env")
        import torch.distributed as dist

        rank = get_rank()
        _coordinator = DistributedCoordinator(
            dist.PrefixStore(NAMESPACE, store), rank, world)
        logger.info("gang coordinator: rank %d of %d (TCPStore agreement)",
                    rank, world)
    else:
        _coordinator = LocalCoordinator()
    return _coordinator


def reset_coordinator() -> None:
    """Drop the singleton (a process leaving its group, and tests: a
    fresh coordinator restarts generation counters, which is unsafe while
    peers hold the old ones)."""
    global _coordinator
    _coordinator = None
