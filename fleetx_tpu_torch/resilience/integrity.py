"""Checkpoint integrity: digests, manifests, verification (port of
``fleetx_tpu/resilience/integrity.py``: ``CheckpointIntegrityError``
:58, ``WriteVerifyError`` :68, ``atomic_write`` :79, ``digest_bytes``
:100, ``digest_array`` :105,
``file_digests`` :152, ``write_manifest`` / ``read_manifest`` :164-198,
``verify_files`` / ``verify_leaves`` :202-240, ``verify_npz_leaves``
:243 and ``verify_checkpoint_dir`` :270).

Every saved step directory carries ``fleetx_integrity.json``::

    {"version": 1,
     "files": {relative path: {"crc32": int, "size": int}},
     "leaves": [{"crc32": int, "dtype": str, "shape": [...],
                 "nbytes": int}, ...]}

The digest is stdlib ``zlib.crc32`` of a file's bytes and of each leaf's
C-contiguous bytes, the same as the JAX package's, so its offline
auditor (``tools/verify_ckpt.py``) audits a port checkpoint too, leaves
included (the payload is ``state.npz`` with ``leaf_<i>`` entries, the
codec that auditor decodes). Stdlib and numpy only.

Not ported: ``tree_digests`` and ``params_fingerprint`` (JAX pytrees and
the SDC sentinel, ROADMAP item 8) and the preflight ``selftest`` of the
supervisor gang (item 8).
"""

from __future__ import annotations

import json
import os
import zlib
from typing import Any, Iterable, Optional

import numpy as np

from fleetx_tpu_torch.utils.log import logger

__all__ = ["MANIFEST_NAME", "CheckpointIntegrityError", "WriteVerifyError",
           "atomic_write",
           "digest_bytes", "digest_array", "file_digests", "write_manifest",
           "read_manifest", "verify_files", "verify_leaves",
           "leaf_matches", "verify_npz_leaves", "verify_checkpoint_dir"]

#: manifest file name inside a ``step_<N>`` checkpoint directory
MANIFEST_NAME = "fleetx_integrity.json"

#: files that are checkpoint metadata, never digested as payload
_NON_PAYLOAD = {"fleetx_meta.json", MANIFEST_NAME}

#: streaming chunk for file digests (bounded memory on multi-GB payloads)
_CHUNK = 1 << 20


class CheckpointIntegrityError(RuntimeError):
    """A checkpoint failed digest verification at restore.

    Not an ``OSError``: re-reading corrupt bytes does not repair them.
    The caller refuses the step loudly and falls back to the newest older
    step that verifies (``EagerEngine.load``).
    """


class WriteVerifyError(OSError):
    """A just-written checkpoint failed its read-back verification.

    An ``OSError`` on purpose: a torn write is transient-shaped, so the
    retry policy re-dispatches the whole write; a sticky failure (a dying
    disk, the ``corrupt_ckpt_at`` drill) exhausts the retries and surfaces
    as this error, and the step is never marked complete.
    """


def atomic_write(target: str, write, mode: str = "w") -> None:
    """Publish a file all-or-nothing: temp file, fsync, ``os.replace``;
    the temp file is removed on any failure."""
    tmp = f"{target}.tmp.{os.getpid()}"
    try:
        with open(tmp, mode) as f:
            write(f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, target)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise


def digest_bytes(data: bytes, seed: int = 0) -> int:
    """crc32 of ``data`` (unsigned 32-bit int)."""
    return zlib.crc32(data, seed) & 0xFFFFFFFF


def digest_array(arr: Any) -> dict:
    """Digest of one array leaf: crc32 of its C-contiguous bytes, plus the
    dtype, shape and byte count."""
    host = np.ascontiguousarray(np.asarray(arr))
    return {"crc32": digest_bytes(host.data), "dtype": str(host.dtype),
            "shape": list(host.shape), "nbytes": int(host.nbytes)}


def _payload_files(path: str) -> list:
    """Relative paths of every payload file under ``path``, sorted
    (metadata markers and temp files excluded)."""
    out = []
    for root, _, names in os.walk(path):
        for name in names:
            if name in _NON_PAYLOAD or ".tmp." in name:
                continue
            out.append(os.path.relpath(os.path.join(root, name), path))
    return sorted(out)


def _digest_file(target: str) -> dict:
    """Streaming crc32 and size of one file."""
    crc = 0
    size = 0
    with open(target, "rb") as f:
        while True:
            chunk = f.read(_CHUNK)
            if not chunk:
                break
            crc = zlib.crc32(chunk, crc)
            size += len(chunk)
    return {"crc32": crc & 0xFFFFFFFF, "size": size}


def file_digests(path: str) -> dict:
    """Relative path → ``{crc32, size}`` for every payload file under a
    step directory."""
    return {rel: _digest_file(os.path.join(path, rel))
            for rel in _payload_files(path)}


def write_manifest(path: str, leaves: Optional[list] = None) -> dict:
    """Digest the payload files under ``path`` and publish the manifest
    atomically; ``leaves`` are the per-leaf digests taken from the
    in-memory state at save. Returns the manifest."""
    manifest = {"version": 1, "files": file_digests(path)}
    if leaves is not None:
        manifest["leaves"] = leaves
    atomic_write(os.path.join(path, MANIFEST_NAME),
                 lambda f: json.dump(manifest, f))
    return manifest


def read_manifest(path: str) -> Optional[dict]:
    """The step directory's manifest, or None when it is absent or
    unreadable (then the step is unverifiable, with a warning)."""
    target = os.path.join(path, MANIFEST_NAME)
    if not os.path.exists(target):
        return None
    try:
        with open(target) as f:
            manifest = json.load(f)
    except (OSError, json.JSONDecodeError, UnicodeDecodeError,
            ValueError) as e:
        logger.warning("corrupt integrity manifest %s (%s) — treating %s "
                       "as unverifiable", target, e, path)
        return None
    if not isinstance(manifest, dict) or "files" not in manifest:
        logger.warning("malformed integrity manifest %s — treating %s as "
                       "unverifiable", target, path)
        return None
    return manifest


def verify_files(path: str, manifest: dict) -> list:
    """Re-digest the manifest's files; the relative paths that are missing
    or whose crc32 or size changed (empty = verified)."""
    bad = []
    for rel, want in sorted(manifest.get("files", {}).items()):
        target = os.path.join(path, rel)
        if not os.path.exists(target):
            bad.append(rel)
            continue
        got = _digest_file(target)
        if got["crc32"] != int(want["crc32"]) or \
                got["size"] != int(want["size"]):
            bad.append(rel)
    return bad


def leaf_matches(arr: Any, want: dict) -> bool:
    """True when ``arr``'s C-contiguous bytes have the digest's byte
    count and crc32."""
    host = np.ascontiguousarray(np.asarray(arr))
    return int(host.nbytes) == int(want["nbytes"]) and \
        digest_bytes(host.data) == int(want["crc32"])


def verify_leaves(arrays: Iterable[Any], manifest_leaves: list) -> list:
    """Indices of the arrays whose bytes differ from their manifest
    digests. Only bytes count (crc32 and byte count): a bf16 leaf stored
    as its raw ``uint16`` bits compares equal. A leaf whose byte count
    changed was recast on restore and is skipped, as in the JAX package."""
    bad = []
    for i, arr in enumerate(arrays):
        if i >= len(manifest_leaves):
            break
        want = manifest_leaves[i]
        if int(np.asarray(arr).nbytes) != int(want["nbytes"]):
            continue
        if not leaf_matches(arr, want):
            bad.append(i)
    return bad


def verify_npz_leaves(path: str, manifest_leaves: list) -> list:
    """Reload every ``leaf_<i>`` of the step's ``state.npz`` payload and
    compare it with its digest; the mismatching indices. An archive too
    corrupt to decode reports every leaf."""
    target = os.path.join(path, "state.npz")
    bad = []
    try:
        with np.load(target) as data:
            for i, want in enumerate(manifest_leaves):
                key = f"leaf_{i}"
                if key not in data or not leaf_matches(data[key], want):
                    bad.append(i)
    except Exception as e:  # noqa: BLE001 — undecodable == all corrupt
        logger.warning("npz payload %s unreadable during verification "
                       "(%s: %s)", target, type(e).__name__, e)
        return list(range(len(manifest_leaves)))
    return bad


def verify_checkpoint_dir(path: str, files_only: bool = False) -> dict:
    """Offline verification of one ``step_<N>`` directory.

    Returns ``{"status": "ok" | "corrupt" | "unverified",
    "files_checked", "leaves_checked", "mismatched_files",
    "mismatched_leaves"}``; ``unverified`` means no readable manifest.
    ``files_only`` skips decoding the npz leaves (the file digest already
    covers every byte of the archive).
    """
    manifest = read_manifest(path)
    if manifest is None:
        return {"status": "unverified", "files_checked": 0,
                "leaves_checked": 0, "mismatched_files": [],
                "mismatched_leaves": []}
    bad_files = verify_files(path, manifest)
    bad_leaves: list = []
    leaves = manifest.get("leaves")
    leaves_checked = 0
    if not files_only and leaves and \
            os.path.exists(os.path.join(path, "state.npz")):
        leaves_checked = len(leaves)
        bad_leaves = verify_npz_leaves(path, leaves)
    return {"status": "corrupt" if (bad_files or bad_leaves) else "ok",
            "files_checked": len(manifest.get("files", {})),
            "leaves_checked": leaves_checked,
            "mismatched_files": bad_files,
            "mismatched_leaves": bad_leaves}
