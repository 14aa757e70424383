"""Checkpoint save / verify / load for one process on one device (port of
``fleetx_tpu/core/checkpoint.py``: the npz codec :190-277,
``save_checkpoint`` :281, the meta marker :431-473,
``completed_steps`` / ``latest_step`` / ``latest_verified_step`` /
``peek_meta`` :572-623, ``gc_checkpoints`` :637,
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

Not ported, because they need more than one rank: Orbax's sharded
codec, the gang two-phase commit, per-rank directories (ROADMAP item 12)
and asynchronous saves (item 8); the config values that ask for them
raise in ``core/engine/eager_engine.py``. The JAX module's process-wide
table of the newest verified step, which its retention spares, is not
kept: a save here is synchronous and verified as it is written, so that
step is always the newest, which retention never prunes.
"""

from __future__ import annotations

import json
import os
import shutil
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
           "WriteVerifyError",
           "save_checkpoint", "completed_steps", "latest_step",
           "latest_verified_step", "peek_meta", "gc_checkpoints",
           "load_params", "load_checkpoint", "flatten", "unflatten",
           "step_dir", "step_dirs"]

META_NAME = "fleetx_meta.json"
STATE_NAME = "state.npz"

Leaf = Union[torch.Tensor, np.ndarray, int, float, bool, list]


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
def save_checkpoint(directory: str, step: int, state: dict,
                    meta: Optional[dict] = None) -> str:
    """Write ``state`` (flat ``{name: tensor | array | scalar}``) as step
    ``step`` under ``directory``: payload (read back and verified), then
    the manifest, then the meta marker (``meta`` plus ``step``), each
    write retried under the process retry policy. A step directory left
    without its meta by an interrupted save is removed first. Returns the
    step directory; raises ``WriteVerifyError`` when the read-back still
    fails after the retries."""
    path = os.path.abspath(step_dir(directory, step))
    if os.path.isdir(path) and _read_meta(path) is None:
        logger.info("removing half-written checkpoint: %s", path)
        shutil.rmtree(path)
    os.makedirs(path, exist_ok=True)
    reg = get_registry()
    retries = reg.counter("ckpt_retries_total")
    t0 = time.perf_counter()
    arrays, dtypes, digests = {}, [], []
    for i, name in enumerate(state):
        arr, dtype = _to_host(state[name])
        arrays[f"leaf_{i}"] = arr
        dtypes.append(dtype)
        digests.append(dict(integrity.digest_array(arr), dtype=dtype))
    arrays["__dtypes__"] = np.array(dtypes, dtype=str)
    arrays["__names__"] = np.array(list(state), dtype=str)

    def write_state():
        # the injection point first, so an injected failure takes the
        # retry path a real I/O error would
        faults_mod.fire("ckpt_write")
        integrity.atomic_write(os.path.join(path, STATE_NAME),
                               lambda f: np.savez(f, **arrays), mode="wb")
        # a byte rotting between the write and its read-back (the drill)
        faults_mod.fire_path("ckpt_written", path, int(step))
        bad = integrity.verify_npz_leaves(path, digests)
        if bad:
            raise WriteVerifyError(
                f"read-back verification of {path} failed: leaves {bad} "
                f"differ from the digests computed at save")

    with span("checkpoint_write", step=int(step)):
        call_with_retry(write_state, desc="checkpoint state write",
                        counter=retries)
    full_meta = dict(meta or {}, step=int(step))
    with span("ckpt_finalize"):
        integrity.write_manifest(path, leaves=digests)
        call_with_retry(lambda: integrity.atomic_write(
            os.path.join(path, META_NAME),
            lambda f: json.dump(full_meta, f)),
            desc="checkpoint meta write", counter=retries)
    nbytes = sum(int(a.nbytes) for a in arrays.values())
    reg.histogram("ckpt_save").record(time.perf_counter() - t0)
    reg.counter("ckpt_saves_total").inc()
    reg.gauge("ckpt_bytes").set(nbytes)
    reg.counter("ckpt_bytes_total").inc(nbytes)
    logger.info("saved checkpoint: %s", path)
    return path


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
        logger.error("checkpoint %s failed integrity verification (files: "
                     "%s) — skipping it as a resume candidate", path,
                     report["mismatched_files"])
    return None


def peek_meta(directory: str) -> Optional[dict]:
    """The meta dict of the newest step that verifies, without decoding
    the payload (the sampler's ``consumed_samples`` before a restore)."""
    step = latest_verified_step(directory)
    return None if step is None else _read_meta(step_dir(directory, step))


def gc_checkpoints(directory: str, keep_last: int,
                   keep_every: int = 0) -> int:
    """Remove old completed steps; returns how many went. The newest
    ``keep_last`` (at least 1: the newest step is never pruned) and every
    step divisible by ``keep_every`` survive. Half-written directories
    are left to ``save_checkpoint``."""
    steps = completed_steps(directory)
    keep = set(steps[-max(int(keep_last), 1):])
    if keep_every:
        keep.update(s for s in steps if s % int(keep_every) == 0)
    pruned = 0
    for s in steps:
        if s not in keep:
            path = step_dir(directory, s)
            logger.info("checkpoint gc: pruning %s", path)
            shutil.rmtree(path, ignore_errors=True)
            pruned += 1
    return pruned


# ----------------------------------------------------------------- load
def _verify_payload_or_raise(path: str, step: int) -> Optional[dict]:
    """Fire the ``ckpt_restore`` fault point, then re-digest every payload
    file against the manifest before any byte is decoded; the manifest
    (None when absent: restored unverified, with a log line), or
    ``CheckpointIntegrityError`` naming the files."""
    faults_mod.fire_path("ckpt_restore", path, int(step))
    manifest = integrity.read_manifest(path)
    if manifest is None:
        logger.info("no integrity manifest under %s — restoring "
                    "unverified", path)
        return None
    bad = integrity.verify_files(path, manifest)
    if bad:
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
    with np.load(target) as data:
        names = [str(n) for n in data["__names__"]]
        dtypes = [str(d) for d in data["__dtypes__"]]
        for i, name in enumerate(names):
            if not select(name):
                continue
            arr = data[f"leaf_{i}"]
            if i < len(digests) and \
                    not integrity.leaf_matches(arr, digests[i]):
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
