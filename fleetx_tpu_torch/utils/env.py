"""Ranks and seeding (port of ``fleetx_tpu/utils/env.py``).

- ``init_dist_env``: joins the process group that
  ``tools/supervise.py --num-procs N`` describes in ``FLEETX_COORDINATOR``,
  ``FLEETX_NUM_PROCESSES`` and ``FLEETX_PROCESS_ID`` (JAX's variables),
  over one ``torch.distributed.TCPStore`` it builds itself (rank 0 hosts
  it at the coordinator's address); ``get_store`` returns that store, on
  which the resilience runtime's agreements run
  (``resilience/coordination.py``); ``close_dist_env`` leaves the group;
- ``get_world_size``, ``get_rank``, ``get_local_world_size`` and
  ``get_local_rank``: the process group's ranks (1 and 0 without one);
- ``rank_device``: the device of this rank, ``cuda:{local_rank}`` when
  the host has a card per rank, ``cuda:0`` when its ranks share one; a
  CUDA device that cannot be had raises, it never drops to the CPU;
- ``set_seed``: numpy, ``random`` and a CPU ``torch.Generator``;
- ``rng_streams``: name-keyed seeds (``fleetx_tpu/utils/env.py:89-100``).

**The backend rule.** NCCL when every rank on this host has a CUDA
device of its own; gloo otherwise, which covers the CPU and ranks that
share one card (NCCL refuses two ranks on one device; gloo stages CUDA
tensors through pinned host memory, so each rank's compute stays on the
card). No knob chooses it.
"""

from __future__ import annotations

import datetime
import os
import random
import zlib
from typing import Optional, Union

import numpy as np
import torch

from fleetx_tpu_torch.utils.log import logger, set_rank_context

#: None = never called; else the first call's verdict
_initialized: Optional[bool] = None
#: the backend the process group was created with
_backend: Optional[str] = None
#: the gang's key-value store (rank 0 hosts it), None off-gang
_store = None

#: how long a rank waits in a collective of the default group
DEFAULT_TIMEOUT = datetime.timedelta(minutes=30)


def _env_int(name: str, default: int) -> int:
    value = os.environ.get(name)
    return int(value) if value not in (None, "") else default


def get_world_size() -> int:
    """Ranks in the process group (1 without one)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def get_rank() -> int:
    """This process's rank (0 without a process group)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def get_local_world_size() -> int:
    """Ranks on this host: ``LOCAL_WORLD_SIZE`` when a launcher sets it,
    else the whole world (``tools/supervise.py`` starts every member on
    its own host)."""
    return _env_int("LOCAL_WORLD_SIZE", get_world_size())


def get_local_rank() -> int:
    """This rank's index among the ranks of its host."""
    return _env_int("LOCAL_RANK", get_rank())


def backend_for(device_type: str, local_world_size: int) -> str:
    """The backend rule: ``nccl`` when the ranks of this host each have a
    CUDA device, else ``gloo``."""
    if device_type == "cuda" and torch.cuda.is_available() and \
            local_world_size <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def get_backend() -> Optional[str]:
    """The process group's backend (None before ``init_dist_env``)."""
    return _backend


def get_store():
    """The gang's ``TCPStore`` (None off-gang)."""
    return _store


def init_dist_env(coordinator_address: Optional[str] = None,
                  num_processes: Optional[int] = None,
                  process_id: Optional[int] = None,
                  device: Union[str, torch.device, None] = None) -> bool:
    """Join the process group when a coordinator is given (argument or
    ``FLEETX_COORDINATOR``); returns whether one is active.

    Rank 0 hosts a ``TCPStore`` at the coordinator's ``host:port``, every
    other rank connects to it, and ``init_process_group(store=...)`` runs
    on that store, once. A rank that cannot reach the store within
    ``DEFAULT_TIMEOUT`` raises: it never goes on as a world of one. A
    second call returns the first call's verdict and does nothing, where
    JAX's ``jax.distributed.initialize`` would raise. A call that raises
    (the coordinator is not up) leaves the verdict unset, so a retry can
    try again. ``device`` (default ``cuda``) feeds the backend rule: the
    CPU always takes gloo.
    """
    global _initialized, _backend, _store
    if _initialized is not None:
        return _initialized
    coordinator_address = coordinator_address or os.environ.get(
        "FLEETX_COORDINATOR")
    if not coordinator_address:
        _initialized = False
        return False
    import torch.distributed as dist

    world = int(num_processes or _env_int("FLEETX_NUM_PROCESSES", 1))
    rank = int(process_id if process_id is not None
               else _env_int("FLEETX_PROCESS_ID", 0))
    device_type = torch.device(device if device is not None
                               else "cuda").type
    local = _env_int("LOCAL_WORLD_SIZE", world)
    backend = backend_for(device_type, local)
    host, _, port = coordinator_address.rpartition(":")
    store = dist.TCPStore(host or "127.0.0.1", int(port), world,
                          is_master=rank == 0, timeout=DEFAULT_TIMEOUT)
    dist.init_process_group(backend=backend, store=store,
                            world_size=world, rank=rank,
                            timeout=DEFAULT_TIMEOUT)
    _backend, _store = backend, store
    set_rank_context(rank, world)
    logger.info("process group: rank %d/%d over %s (%d ranks on this host)",
                rank, world, backend, local)
    _initialized = True
    return True


#: how long rank 0, which hosts the store, waits at exit for the other
#: ranks to be done with it
EXIT_TIMEOUT = datetime.timedelta(seconds=60)


def close_dist_env() -> None:
    """Leave the process group, if this process joined one: a gang
    member's last act once its collectives are done (a process that
    exits with the group alive can abort in its threads' teardown).

    Every rank marks its exit in the store, and rank 0 waits for the
    others' marks (at most ``EXIT_TIMEOUT``) before it goes: its process
    hosts the store, and a peer still reading the last agreement's keys
    would lose its connection. The agreements' coordinator goes with the
    store."""
    global _initialized, _backend, _store
    import torch.distributed as dist

    from fleetx_tpu_torch.resilience.coordination import reset_coordinator

    if _store is not None:
        rank, world = get_rank(), get_world_size()
        try:
            _store.set(f"fleetx/exit/{rank}", "1")
            if rank == 0 and world > 1:
                _store.wait([f"fleetx/exit/{r}" for r in range(1, world)],
                            EXIT_TIMEOUT)
        except RuntimeError as e:  # a peer gone, or its mark late
            logger.warning("gang exit: %s", str(e).splitlines()[0])
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _initialized, _backend, _store = None, None, None
    reset_coordinator()


def rank_device(device: Union[str, torch.device, None] = None
                ) -> torch.device:
    """The device of this rank: a CUDA device without an index becomes
    ``cuda:{local_rank}`` when the host has a card for each of its ranks
    and ``cuda:0`` when they share one; anything else is kept. A CUDA
    device on a host without one raises."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available for this rank; pass device='cpu' "
            "(--device cpu) to run the gang on the CPU")
    if dev.index is None:
        own = get_local_world_size() <= torch.cuda.device_count()
        dev = torch.device("cuda", get_local_rank() if own else 0)
    torch.cuda.set_device(dev)
    return dev


def set_seed(seed: int) -> torch.Generator:
    """Seed numpy and ``random`` and return a CPU ``torch.Generator``
    seeded with ``seed``: the port passes generators explicitly instead
    of seeding torch's global one."""
    random.seed(seed)
    np.random.seed(seed)
    gen = torch.Generator()
    gen.manual_seed(int(seed))
    return gen


#: the named streams of a run
STREAMS = ("params", "dropout", "data", "sample")


def rng_streams(seed: int, names: tuple = STREAMS) -> dict:
    """Name → seed of an independent stream: the root seed with the
    crc32 of the stream's NAME folded in (as JAX's ``rng_streams`` folds
    it into its key), so adding or reordering names never moves an
    existing stream."""
    root = (int(seed) & 0xFFFFFFFF) << 31
    return {name: root | (zlib.crc32(name.encode()) & 0x7FFFFFFF)
            for name in names}
