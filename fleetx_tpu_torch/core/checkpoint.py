"""Checkpoint save / verify / load for one process on one device (port of
``fleetx_tpu/core/checkpoint.py``: the npz codec :190-277,
``save_checkpoint`` :281, the meta marker :431-473,
``finalize_async_saves`` :481,
``completed_steps`` / ``latest_step`` / ``latest_verified_step`` /
``peek_meta`` :572-623, ``gc_checkpoints`` :637, the verify mode and the
table of verified steps :83-130,
``_verify_payload_or_raise`` :680, ``load_params`` :727 and
``load_checkpoint`` :783).

A checkpoint is a directory ``<dir>/step_<N>`` holding, written in this
order:

1. ``state.npz``: the flat state, leaf ``i`` under ``leaf_<i>`` (the JAX
   package's per-rank codec), its dtype name in ``__dtypes__`` and its
   name (``params/gpt/layers/ln1/scale``, ``opt_state/mu/...``) in
   ``__names__``. numpy has no bfloat16, so a bf16 leaf is stored as its
   raw ``uint16`` bits and ``__dtypes__`` says ``bfloat16``;
2. ``fleetx_integrity.json``: the crc32 of the file and of every leaf
   (``resilience/integrity.py``);
3. ``fleetx_meta.json``: the completion marker (step, consumed_samples,
   epoch, seed). A step directory without it is a half-written save: it
   is skipped by every reader and removed by the next save of that step.

Every write is atomic (temp file, fsync, ``os.replace``) and runs under
``call_with_retry`` with the process-wide retry policy (the engine's
``Resilience.retry``): a transient ``OSError`` re-dispatches the write and
bumps ``ckpt_retries_total``. After the payload is written it is read
back and every leaf held to the digest taken from the in-memory state
(the JAX per-rank codec's read-back, :356-370); a mismatch that outlives
the retries raises ``WriteVerifyError`` and the step never gets its meta.
A load fires the ``ckpt_restore`` fault point, re-digests the file before
decoding a byte and every leaf after, and raises
``CheckpointIntegrityError`` on a mismatch; the engine then falls back to
the newest older step that verifies (``EagerEngine.load``). The fault
points are those of the JAX module: ``ckpt_write`` before each write
attempt, ``ckpt_written`` between the write and its read-back,
``ckpt_restore`` before a restore (``resilience/faults.py``).

Telemetry (as the JAX module's): the payload write runs under the span
``checkpoint_write``, the manifest and meta marker under
``ckpt_finalize``, a restore under ``checkpoint_restore``
(``observability/trace.span``: Chrome-trace events and
``torch.profiler`` ranges when telemetry is on, bare ranges otherwise);
the shared registry gets ``ckpt_save`` / ``ckpt_restore`` seconds,
``ckpt_saves_total`` / ``ckpt_restores_total`` and ``ckpt_bytes``.

Verification (``Resilience.integrity.verify_checkpoints``, on by
default; ``set_verify_mode``, set by the engine, newest engine wins): with
it off a save writes no manifest and reads nothing back, a restore
checks no digest, and ``peek_meta`` takes the newest completed step. A
read-back and a restore check count ``ckpt_verify_total``, a mismatch
``ckpt_verify_failed``. The process keeps the newest step each directory
has verified (a save's read-back, a restore's digests: ``_last_verified``)
and retention never prunes it, so a fall-back target survives a newer
step that is refused.

Asynchronous saves (``save_checkpoint(..., async_save=True)``): the call
returns once the state is snapshotted (a clone of every tensor leaf, on
its device and stream, so the next step's in-place updates cannot reach
it). A writer thread copies the snapshot into pinned host buffers,
allocated once (``reserve_host_buffers``) and reused, on its own CUDA
stream (ordered after the clone by an event), digests, writes and reads
the payload back. ``finalize_async_saves`` joins it and, under
``ckpt_finalize``, writes the manifest and the meta marker; a writer that
failed past its retries abandons the save (the directory removed,
``ckpt_failed_total`` counted, an error logged) and training goes on. At
most one save is outstanding: a new save finalizes the old one first. A
process that dies with a save outstanding leaves a step directory without
meta, a half-written save as above.

Not ported, because they need more than one rank: Orbax's sharded
codec, the gang two-phase commit and per-rank directories (ROADMAP item
12); the config value that asks for them raises in
``core/engine/eager_engine.py``.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Optional, Union

import numpy as np
import torch

from fleetx_tpu_torch.observability.metrics import get_registry
from fleetx_tpu_torch.observability.trace import span
from fleetx_tpu_torch.resilience import faults as faults_mod
from fleetx_tpu_torch.resilience import integrity
from fleetx_tpu_torch.resilience.integrity import (CheckpointIntegrityError,
                                                   WriteVerifyError)
from fleetx_tpu_torch.resilience.policy import call_with_retry
from fleetx_tpu_torch.utils.log import logger

__all__ = ["STATE_NAME", "META_NAME", "CheckpointIntegrityError",
           "WriteVerifyError", "set_verify_mode", "verify_mode",
           "save_checkpoint", "finalize_async_saves", "reserve_host_buffers", "completed_steps", "latest_step",
           "latest_verified_step", "peek_meta", "gc_checkpoints",
           "load_params", "load_checkpoint", "flatten", "unflatten",
           "step_dir", "step_dirs"]

META_NAME = "fleetx_meta.json"
STATE_NAME = "state.npz"

Leaf = Union[torch.Tensor, np.ndarray, int, float, bool, list]

#: manifests, read-backs and restore checks (``verify_checkpoints``)
_verify = True

#: newest step per directory with verified evidence in this process (a
#: save whose read-back passed, a restore whose digests held); retention
#: never prunes it
_last_verified: dict = {}

#: the outstanding asynchronous save, if any (at most one)
_pending: list = []

#: the writer's pinned host copy of each CUDA leaf, by name, allocated
#: once and reused (at most one save is outstanding, and the next one
#: starts after ``finalize_async_saves`` joined this one's writer): a copy
#: into pageable memory from the writer's thread held the training step
#: up for the whole copy, and so does pinning fresh memory (``PERF.md``,
#: the asynchronous save's findings)
_host_buffers: dict = {}


def set_verify_mode(on: bool) -> None:
    """Turn manifests, read-backs and restore checks on or off
    (``Resilience.integrity.verify_checkpoints``; the newest engine
    wins)."""
    global _verify
    _verify = bool(on)


def verify_mode() -> bool:
    """True when saves write manifests and restores verify digests."""
    return _verify


def _record_verified(directory: str, step: int) -> None:
    """Note ``step`` as the newest verified step under ``directory``."""
    key = os.path.abspath(directory)
    if step >= _last_verified.get(key, -1):
        _last_verified[key] = int(step)


def _record_refused(directory: str, step: int) -> None:
    """Forget a verified step that has since failed verification: gc
    must not keep the corrupt step in place of the good fall-back."""
    key = os.path.abspath(directory)
    if _last_verified.get(key) == int(step):
        del _last_verified[key]


def _record_refused_path(path: str) -> None:
    """``_record_refused`` keyed by a ``step_<N>`` directory (any other
    directory, an adapter's, has no entry)."""
    name = os.path.basename(os.path.abspath(path))
    if name.startswith("step_") and name[len("step_"):].isdigit():
        _record_refused(os.path.dirname(os.path.abspath(path)),
                        int(name[len("step_"):]))


def step_dir(directory: str, step: int) -> str:
    """The directory of step ``step`` under ``directory``."""
    return os.path.join(directory, f"step_{int(step)}")


# ------------------------------------------------------------ flat state
def flatten(tree: Any, prefix: str = "") -> dict:
    """Nested dict → ``{"a/b/c": leaf}`` in insertion order."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flatten(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def unflatten(flat: dict) -> dict:
    """``{"a/b/c": leaf}`` → nested dict (inverse of ``flatten``)."""
    out: dict = {}
    for name, leaf in flat.items():
        node = out
        *parents, last = name.split("/")
        for key in parents:
            node = node.setdefault(key, {})
        node[last] = leaf
    return out


def _to_host(leaf: Leaf) -> tuple:
    """``(numpy array, dtype name)`` of one leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().contiguous().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
        return arr, str(arr.dtype)
    arr = np.ascontiguousarray(np.asarray(leaf))
    return arr, str(arr.dtype)


def _to_torch(arr: np.ndarray, dtype: str) -> torch.Tensor:
    """A stored leaf as a CPU tensor of its saved dtype."""
    if not arr.flags.writeable:
        arr = arr.copy()
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    if str(arr.dtype) != dtype:
        raise ValueError(f"stored leaf has dtype {arr.dtype}, its record "
                         f"says {dtype}")
    return torch.from_numpy(arr)


# ----------------------------------------------------------------- meta
def _read_meta(path: str) -> Optional[dict]:
    """The step's meta dict, or None when absent or unreadable (a warning
    for the unreadable case: the step does not count as complete)."""
    target = os.path.join(path, META_NAME)
    if not os.path.exists(target):
        return None
    try:
        with open(target) as f:
            meta = json.load(f)
    except (OSError, json.JSONDecodeError, UnicodeDecodeError,
            ValueError) as e:
        logger.warning("corrupt checkpoint meta %s (%s) — treating %s as "
                       "incomplete", target, e, path)
        return None
    if not isinstance(meta, dict):
        logger.warning("checkpoint meta %s is not a dict — treating %s as "
                       "incomplete", target, path)
        return None
    return meta


# ----------------------------------------------------------------- save
def _host_arrays(state: dict) -> tuple:
    """``(npz arrays, dtype names)`` of a flat state, on the host."""
    arrays, dtypes = {}, []
    for i, name in enumerate(state):
        arr, dtype = _to_host(state[name])
        arrays[f"leaf_{i}"] = arr
        dtypes.append(dtype)
    arrays["__dtypes__"] = np.array(dtypes, dtype=str)
    arrays["__names__"] = np.array(list(state), dtype=str)
    return arrays, dtypes


def _write_payload(path: str, step: int, arrays: dict, dtypes: list,
                   retries) -> Optional[list]:
    """Write ``state.npz`` under the retry policy and, in verify mode,
    read every leaf back against its digest; the digests (None with
    verification off)."""
    digests = None
    if _verify:
        digests = [dict(integrity.digest_array(arrays[f"leaf_{i}"]),
                        dtype=dtype) for i, dtype in enumerate(dtypes)]
    reg = get_registry()

    def write_state():
        # the injection point first, so an injected failure takes the
        # retry path a real I/O error would
        faults_mod.fire("ckpt_write")
        integrity.atomic_write(os.path.join(path, STATE_NAME),
                               lambda f: np.savez(f, **arrays), mode="wb")
        # a byte rotting between the write and its read-back (the drill)
        faults_mod.fire_path("ckpt_written", path, int(step))
        if digests is None:
            return
        bad = integrity.verify_npz_leaves(path, digests)
        reg.counter("ckpt_verify_total").inc()
        if bad:
            reg.counter("ckpt_verify_failed").inc()
            raise WriteVerifyError(
                f"read-back verification of {path} failed: leaves {bad} "
                f"differ from the digests computed at save")

    with span("checkpoint_write", step=int(step)):
        call_with_retry(write_state, desc="checkpoint state write",
                        counter=retries)
    return digests


def _publish(path: str, meta: dict, digests: Optional[list],
             retries) -> None:
    """The manifest (verify mode), then the meta marker that completes
    the step; the step is then this process's newest verified one (as
    the JAX module records it, whatever the verify mode)."""
    if _verify:
        integrity.write_manifest(path, leaves=digests)
    call_with_retry(lambda: integrity.atomic_write(
        os.path.join(path, META_NAME), lambda f: json.dump(meta, f)),
        desc="checkpoint meta write", counter=retries)
    _record_verified(os.path.dirname(path), int(meta["step"]))


def _host_buffer(name: str, t: torch.Tensor) -> torch.Tensor:
    """The pinned host buffer of leaf ``name`` (made on first use)."""
    buf = _host_buffers.get(name)
    if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
        buf = _host_buffers[name] = torch.empty(t.shape, dtype=t.dtype,
                                                pin_memory=True)
    return buf


def reserve_host_buffers(state: dict) -> None:
    """Pin the host buffers of a CUDA state's asynchronous saves now (the
    engine's ``prepare``), so that no save pins them while training."""
    for name, t in state.items():
        if torch.is_tensor(t) and t.is_cuda:
            _host_buffer(name, t)


class _AsyncSave:
    """One outstanding asynchronous save: its snapshot, the writer thread
    that writes it, and the writer's outcome."""

    def __init__(self, path: str, step: int, meta: dict, snapshot: dict,
                 retries):
        self.path, self.step, self.meta = path, int(step), meta
        self.retries = retries
        self.digests: Optional[list] = None
        # a writer that ends any other way than by finishing abandons the
        # save: the meta is published only after a finished write
        self.error: Optional[BaseException] = RuntimeError(
            "the checkpoint writer did not finish")
        self._snapshot = snapshot
        # the clones were enqueued on the caller's stream: the writer's
        # copy to the host waits for them on a stream of its own
        self._device = next((t.device for t in snapshot.values()
                             if torch.is_tensor(t) and t.is_cuda), None)
        self._ready = None
        if self._device is not None:
            self._ready = torch.cuda.Event()
            self._ready.record(torch.cuda.current_stream(self._device))
        self.thread = threading.Thread(target=self._run, daemon=True,
                                       name=f"ckpt-writer-step{step}")
        self.thread.start()

    def _host(self) -> tuple:
        if self._device is None:
            return _host_arrays(self._snapshot)
        with torch.cuda.device(self._device):
            stream = torch.cuda.Stream(self._device)
            stream.wait_event(self._ready)
            with torch.cuda.stream(stream):
                host = {k: _host_buffer(k, v).copy_(v, non_blocking=True)
                        if torch.is_tensor(v) and v.is_cuda else v
                        for k, v in self._snapshot.items()}
            # the copies are done: the clones may go back to the allocator
            stream.synchronize()
        return _host_arrays(host)

    def _run(self) -> None:
        try:
            arrays, dtypes = self._host()
            self._snapshot = None  # the device copies go now
            self.digests = _write_payload(self.path, self.step, arrays,
                                          dtypes, self.retries)
            self.error = None
        except Exception as e:  # noqa: BLE001 — finalize abandons
            self.error = e
        finally:
            self._snapshot = None


def _snapshot(state: dict) -> dict:
    """A copy of every tensor leaf (on its device, enqueued on the
    current stream) and the scalars as they are."""
    with torch.no_grad():
        return {k: v.detach().clone() if torch.is_tensor(v) else v
                for k, v in state.items()}


def save_checkpoint(directory: str, step: int, state: dict,
                    meta: Optional[dict] = None,
                    async_save: bool = False) -> str:
    """Write ``state`` (flat ``{name: tensor | array | scalar}``) as step
    ``step`` under ``directory``: payload (read back and verified in
    verify mode), then the manifest, then the meta marker (``meta`` plus
    ``step``), each write retried under the process retry policy. A step
    directory left without its meta by an interrupted save is removed
    first. Returns the step directory; raises ``WriteVerifyError`` when
    the read-back still fails after the retries.

    ``async_save``: return once the state is snapshotted; the payload is
    written by a writer thread, and ``finalize_async_saves`` (which a
    later save calls first) publishes the manifest and the meta."""
    finalize_async_saves()  # at most one outstanding save
    path = os.path.abspath(step_dir(directory, step))
    if os.path.isdir(path) and _read_meta(path) is None:
        logger.info("removing half-written checkpoint: %s", path)
        shutil.rmtree(path)
    os.makedirs(path, exist_ok=True)
    reg = get_registry()
    retries = reg.counter("ckpt_retries_total")
    t0 = time.perf_counter()
    full_meta = dict(meta or {}, step=int(step))
    nbytes = sum(int(v.numel() * v.element_size()) if torch.is_tensor(v)
                 else int(np.asarray(v).nbytes) for v in state.values())
    if async_save:
        _pending.append(_AsyncSave(path, step, full_meta, _snapshot(state),
                                   retries))
        logger.info("async checkpoint started: %s", path)
    else:
        arrays, dtypes = _host_arrays(state)
        digests = _write_payload(path, step, arrays, dtypes, retries)
        with span("ckpt_finalize"):
            _publish(path, full_meta, digests, retries)
        logger.info("saved checkpoint: %s", path)
    # an asynchronous save reports its snapshot here; the write shows
    # under ckpt_finalize
    reg.histogram("ckpt_save").record(time.perf_counter() - t0)
    reg.counter("ckpt_saves_total").inc()
    reg.gauge("ckpt_bytes").set(nbytes)
    reg.counter("ckpt_bytes_total").inc(nbytes)
    return path


def finalize_async_saves() -> None:
    """Wait for the outstanding asynchronous save and complete it: the
    manifest and the meta marker, under the ``ckpt_finalize`` span and
    timer. A writer that failed past its retries abandons the save
    instead of ending training: the half-written directory goes at once
    (periodic saves never revisit its step), ``ckpt_failed_total``
    counts it and an error says so."""
    if not _pending:
        return
    reg = get_registry()
    with span("ckpt_finalize"), reg.timer("ckpt_finalize"):
        save = _pending.pop(0)
        save.thread.join()
        if save.error is not None:
            reg.counter("ckpt_failed_total").inc()
            logger.error(
                "async checkpoint write FAILED (%s: %s) — abandoning %s; "
                "training continues, the next periodic save retries from "
                "scratch", type(save.error).__name__, save.error, save.path)
            shutil.rmtree(save.path, ignore_errors=True)
            return
        _publish(save.path, save.meta, save.digests, save.retries)
        logger.info("async checkpoint finalized: %s", save.path)


# ------------------------------------------------------------- discovery
def step_dirs(directory: str) -> list:
    """Sorted ``(step, path)`` of every ``step_<N>`` directory under
    ``directory``, complete or not."""
    if not directory or not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        if not name.startswith("step_"):
            continue
        try:
            step = int(name[len("step_"):])
        except ValueError:
            continue
        out.append((step, os.path.join(directory, name)))
    return sorted(out)


def completed_steps(directory: str) -> list:
    """Sorted steps under ``directory`` with a readable meta marker."""
    return [step for step, path in step_dirs(directory)
            if _read_meta(path) is not None]


def latest_step(directory: str) -> Optional[int]:
    """The newest completed step under ``directory`` (None if none)."""
    steps = completed_steps(directory)
    return steps[-1] if steps else None


def latest_verified_step(directory: str) -> Optional[int]:
    """The newest completed step whose file digests hold (or that has no
    manifest); provably corrupt steps are skipped with an error log."""
    for step in reversed(completed_steps(directory)):
        path = step_dir(directory, step)
        report = integrity.verify_checkpoint_dir(path, files_only=True)
        if report["status"] != "corrupt":
            return step
        _record_refused(directory, step)
        logger.error("checkpoint %s failed integrity verification (files: "
                     "%s) — skipping it as a resume candidate", path,
                     report["mismatched_files"])
    return None


def peek_meta(directory: str) -> Optional[dict]:
    """The meta dict of the newest step that verifies (the newest
    completed one with verification off), without decoding the payload
    (the sampler's ``consumed_samples`` before a restore)."""
    step = latest_verified_step(directory) if _verify \
        else latest_step(directory)
    return None if step is None else _read_meta(step_dir(directory, step))


def gc_checkpoints(directory: str, keep_last: int,
                   keep_every: int = 0) -> int:
    """Remove old completed steps; returns how many went. The newest
    ``keep_last`` (at least 1: the newest step is never pruned), every
    step divisible by ``keep_every`` and the newest step this process
    verified survive; pruned steps count ``ckpt_gc_total``. Half-written
    directories (an outstanding asynchronous save's too) are left to
    ``save_checkpoint``."""
    steps = completed_steps(directory)
    keep = set(steps[-max(int(keep_last), 1):])
    if keep_every:
        keep.update(s for s in steps if s % int(keep_every) == 0)
    verified = _last_verified.get(os.path.abspath(directory))
    if verified is not None:
        keep.add(verified)
    pruned = 0
    for s in steps:
        if s not in keep:
            path = step_dir(directory, s)
            logger.info("checkpoint gc: pruning %s", path)
            shutil.rmtree(path, ignore_errors=True)
            pruned += 1
    if pruned:
        get_registry().counter("ckpt_gc_total").inc(pruned)
    return pruned


# ----------------------------------------------------------------- load
def _verify_payload_or_raise(path: str, step: int) -> Optional[dict]:
    """Fire the ``ckpt_restore`` fault point, then re-digest every payload
    file against the manifest before any byte is decoded; the manifest
    (None with verification off, or when absent: restored unverified,
    with a log line), or ``CheckpointIntegrityError`` naming the
    files."""
    faults_mod.fire_path("ckpt_restore", path, int(step))
    if not _verify:
        return None
    manifest = integrity.read_manifest(path)
    if manifest is None:
        logger.info("no integrity manifest under %s — restoring "
                    "unverified", path)
        return None
    reg = get_registry()
    reg.counter("ckpt_verify_total").inc()
    bad = integrity.verify_files(path, manifest)
    if bad:
        reg.counter("ckpt_verify_failed").inc()
        _record_refused(os.path.dirname(path), int(step))
        raise CheckpointIntegrityError(
            f"checkpoint {path} failed integrity verification: files {bad} "
            f"do not match the manifest digests — refusing to restore "
            f"corrupt state")
    return manifest


def _read_state(path: str, manifest: Optional[dict],
                select=lambda name: True) -> dict:
    """``{name: CPU tensor}`` of the selected leaves of a step's payload,
    each leaf's raw bytes checked against its manifest digest first."""
    target = os.path.join(path, STATE_NAME)
    if not os.path.exists(target):
        raise FileNotFoundError(
            f"{path} holds no {STATE_NAME}: not a checkpoint of this port "
            f"(a JAX package checkpoint keeps its state under Orbax's "
            f"state/ directory)")
    digests = (manifest or {}).get("leaves") or []
    out = {}
    with integrity.StoredNpz(target) as data:
        names = [str(n) for n in data.read("__names__")[0]]
        dtypes = [str(d) for d in data.read("__dtypes__")[0]]
        for i, name in enumerate(names):
            if not select(name):
                continue
            arr, crc = data.read(f"leaf_{i}")
            if i < len(digests) and \
                    not integrity.digest_matches(arr.nbytes, crc,
                                                 digests[i]):
                _record_refused_path(path)
                raise CheckpointIntegrityError(
                    f"checkpoint leaf {i} ({name}) of {path} does not match "
                    f"its manifest digest — refusing to restore corrupt "
                    f"state")
            out[name] = _to_torch(arr, dtypes[i])
    return out


def load_checkpoint(directory: str, step: int) -> tuple:
    """``(flat state of CPU tensors, meta)`` of step ``step``: the file
    verified before decoding and every leaf after, or
    ``CheckpointIntegrityError``."""
    path = os.path.abspath(step_dir(directory, step))
    reg = get_registry()
    t0 = time.perf_counter()
    with span("checkpoint_restore", step=int(step)):
        manifest = _verify_payload_or_raise(path, step)
        state = _read_state(path, manifest)
    reg.histogram("ckpt_restore").record(time.perf_counter() - t0)
    reg.counter("ckpt_restores_total").inc()
    reg.gauge("ckpt_bytes").set(sum(int(t.numel() * t.element_size())
                                    for t in state.values()))
    meta = _read_meta(path)
    if meta is None:
        raise RuntimeError(f"checkpoint meta unreadable for {path} — "
                           f"refusing to resume without step / "
                           f"consumed_samples")
    if manifest is not None:
        _record_verified(directory, int(step))
    logger.info("restored checkpoint: %s (step %d)", path,
                int(meta.get("step", step)))
    return state, meta


def load_params(directory: str, step: Optional[int] = None,
                device: Union[str, torch.device] = "cpu") -> dict:
    """The ``params`` subtree of a saved state (generation and serving
    have no optimizer), on ``device``; the newest completed step unless
    ``step`` is given. Raises when there is no checkpoint or it does not
    verify: no caller gets fresh weights in place of a configured
    checkpoint."""
    step = step if step is not None else latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no completed checkpoint under "
                                f"{directory!r}")
    path = os.path.abspath(step_dir(directory, step))
    manifest = _verify_payload_or_raise(path, step)
    flat = _read_state(path, manifest,
                       select=lambda name: name.startswith("params/"))
    if not flat:
        raise ValueError(f"checkpoint {path} holds no params/ leaves")
    device = torch.device(device)
    params = unflatten({name[len("params/"):]: t.to(device)
                        for name, t in flat.items()})
    logger.info("restored params from %s (step %d)", path, step)
    return params
