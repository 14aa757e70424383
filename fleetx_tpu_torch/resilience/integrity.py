"""Checkpoint integrity: digests, manifests, verification (port of
``fleetx_tpu/resilience/integrity.py``: ``CheckpointIntegrityError``
:58, ``WriteVerifyError`` :68, ``atomic_write`` :79, ``digest_bytes``
:100, ``digest_array`` :105,
``file_digests`` :152, ``write_manifest`` / ``read_manifest`` :164-198,
``verify_files`` / ``verify_leaves`` :202-240, ``verify_npz_leaves``
:243, ``verify_checkpoint_dir`` :270, ``params_fingerprint`` :311 and
the preflight ``selftest`` / ``main`` :356-410).

Every saved step directory carries ``fleetx_integrity.json``::

    {"version": 1,
     "files": {relative path: {"crc32": int, "size": int}},
     "leaves": [{"crc32": int, "dtype": str, "shape": [...],
                 "nbytes": int}, ...]}

The digest is stdlib ``zlib.crc32`` of a file's bytes and of each leaf's
C-contiguous bytes, the same as the JAX package's (a buffer or file of
``_PAR_MIN`` bytes or more is digested in ``_PAR_CHUNK`` pieces on
threads, ``zlib.crc32`` releasing the GIL, and the pieces' crcs combined
into the whole's: the same value), so its offline
auditor (``tools/verify_ckpt.py``) audits a port checkpoint too, leaves
included (the payload is ``state.npz`` with ``leaf_<i>`` entries, the
codec that auditor decodes). Stdlib and numpy; torch only inside the
two functions that compute on the device:

- ``params_fingerprint(leaves)``: the SDC sentinel's bit-content
  reduction of a parameter tree, equal bit for bit to the JAX function
  on the same values when ``leaves`` come in ``jax.tree.leaves`` order
  (``convert.jax_leaves``);
- ``selftest(size, repeats, device)``: the supervisor's preflight, a
  seeded f32 matmul on the device repeated and digested, run as
  ``python -m fleetx_tpu_torch.resilience.integrity --selftest [--device
  cpu]`` (on ``cuda`` unless asked; JSON on stdout, exit 0 on a healthy
  host, 1 otherwise).

Not ported: ``tree_digests`` (JAX pytrees; the codec digests its host
leaves itself).
"""

from __future__ import annotations

import json
import os
import struct
import threading
import zipfile
import zlib
from concurrent.futures import ThreadPoolExecutor
from functools import lru_cache
from typing import Any, Iterable, Optional

import numpy as np

from fleetx_tpu_torch.utils.log import logger

__all__ = ["MANIFEST_NAME", "CheckpointIntegrityError", "WriteVerifyError",
           "atomic_write", "params_fingerprint", "selftest", "main",
           "digest_bytes", "digest_array", "file_digests", "write_manifest",
           "read_manifest", "verify_files", "verify_leaves",
           "leaf_matches", "digest_matches", "StoredNpz",
           "verify_npz_leaves", "verify_checkpoint_dir"]

#: manifest file name inside a ``step_<N>`` checkpoint directory
MANIFEST_NAME = "fleetx_integrity.json"

#: files that are checkpoint metadata, never digested as payload
_NON_PAYLOAD = {"fleetx_meta.json", MANIFEST_NAME}

#: streaming chunk for file digests (bounded memory on multi-GB payloads)
_CHUNK = 1 << 20

#: a buffer or file of _PAR_MIN bytes or more is digested in _PAR_CHUNK
#: pieces on up to _PAR_THREADS threads (a core left to the training
#: step that an asynchronous save's writer runs beside), each thread
#: reading a file's pieces into one buffer it keeps
_PAR_CHUNK = 8 << 20
_PAR_MIN = 2 * _PAR_CHUNK
_PAR_THREADS = max(1, min(8, (os.cpu_count() or 1) - 1))
_pool_of: dict = {}
_pool_lock = threading.Lock()


def _pool() -> ThreadPoolExecutor:
    """This process's digest threads (made on first use; a forked child
    makes its own: it inherits no threads)."""
    with _pool_lock:
        pool = _pool_of.get(os.getpid())
        if pool is None:
            _pool_of.clear()
            pool = _pool_of[os.getpid()] = ThreadPoolExecutor(
                _PAR_THREADS, thread_name_prefix="crc32")
    return pool


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


def _gf2_times(mat: tuple, vec: int) -> int:
    """The GF(2) 32x32 matrix ``mat`` (one column a row) times ``vec``."""
    out, i = 0, 0
    while vec:
        if vec & 1:
            out ^= mat[i]
        vec >>= 1
        i += 1
    return out


def _gf2_square(mat: tuple) -> tuple:
    return tuple(_gf2_times(mat, mat[n]) for n in range(32))


@lru_cache(maxsize=1)
def _zero_byte_ops() -> tuple:
    """``ops[k]`` advances a crc32 register over 2**k zero bytes (the
    operators of zlib's ``crc32_combine``, which Python's zlib lacks)."""
    op = (0xEDB88320,) + tuple(1 << n for n in range(31))  # one zero bit
    for _ in range(3):                                      # 2, 4, 8 bits
        op = _gf2_square(op)
    ops = [op]
    for _ in range(63):
        ops.append(_gf2_square(ops[-1]))
    return tuple(ops)


def _crc32_combine(crc1: int, crc2: int, len2: int) -> int:
    """crc32 of ``a + b`` from ``crc1`` of ``a``, ``crc2`` of ``b`` and
    ``len2``, the byte length of ``b``."""
    ops, k = _zero_byte_ops(), 0
    while len2:
        if len2 & 1:
            crc1 = _gf2_times(ops[k], crc1)
        len2 >>= 1
        k += 1
    return crc1 ^ crc2


def _combine_pieces(seed: int, pieces: list) -> int:
    """Fold ``[(crc32, nbytes), ...]`` of consecutive pieces onto
    ``seed``, the crc32 of the bytes before them."""
    crc = seed & 0xFFFFFFFF
    for piece_crc, n in pieces:
        crc = _crc32_combine(crc, piece_crc, n)
    return crc


def digest_bytes(data: bytes, seed: int = 0) -> int:
    """crc32 of ``data`` (unsigned 32-bit int), continuing from ``seed``
    as ``zlib.crc32`` does; ``_PAR_MIN`` bytes or more in pieces on
    threads."""
    n = memoryview(data).nbytes
    if n < _PAR_MIN or _PAR_THREADS < 2:
        return zlib.crc32(data, seed) & 0xFFFFFFFF
    view = memoryview(data).cast("B")
    spans = [(o, min(_PAR_CHUNK, n - o)) for o in range(0, n, _PAR_CHUNK)]
    crcs = list(_pool().map(lambda s: zlib.crc32(view[s[0]:s[0] + s[1]]),
                            spans))
    return _combine_pieces(seed, [(c, s[1]) for c, s in zip(crcs, spans)])


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


_span_buffers = threading.local()


def _read_span(fd: int, offset: int, n: int) -> memoryview:
    """``n`` bytes of ``fd`` at ``offset`` (fewer only at the end), in a
    buffer of the calling thread's that the next call reuses (a fresh
    buffer a read would pay its page faults again)."""
    buf = getattr(_span_buffers, "buf", None)
    if buf is None or len(buf) < n:
        buf = _span_buffers.buf = bytearray(n)
    view = memoryview(buf)
    done = 0
    while done < n:
        got = os.preadv(fd, [view[done:n]], offset + done)
        if got <= 0:
            break
        done += got
    return view[:done]


def _digest_range(fd: int, offset: int, n: int) -> tuple:
    """``(crc32, bytes read)`` of ``n`` bytes of ``fd`` from ``offset``
    (fewer read only at the end of the file), in pieces on threads."""
    end = offset + n

    def piece(start: int) -> tuple:
        data = _read_span(fd, start, min(_PAR_CHUNK, end - start))
        return zlib.crc32(data), len(data)

    pieces = [p for p in _pool().map(piece, range(offset, end, _PAR_CHUNK))
              if p[1]]
    return _combine_pieces(0, pieces), sum(k for _, k in pieces)


def _digest_file(target: str) -> dict:
    """crc32 and size of one file: streamed, or from ``_PAR_MIN`` bytes
    on read and digested in pieces on threads."""
    with open(target, "rb") as f:
        size = os.fstat(f.fileno()).st_size
        if size >= _PAR_MIN and _PAR_THREADS >= 2:
            # a file that grew or shrank while read digests as read
            crc, size = _digest_range(f.fileno(), 0, size)
            return {"crc32": crc, "size": size}
        crc = 0
        size = 0
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


class StoredNpz:
    """The arrays of an ``np.savez`` archive, each read straight from the
    file into its array (``np.savez`` stores its members uncompressed)
    and digested once, on threads from ``_PAR_MIN`` bytes: ``read(key)``
    gives ``(array, crc32 of its bytes)``. The archive's own crc32 of
    each member is checked as ``zipfile`` checks it on a read
    (``zipfile.BadZipFile``), from the array's crc32 and its ``.npy``
    header's. A member stored any other way is read through
    ``zipfile``. Against ``np.load``: one pass over the bytes fewer,
    and no copies in 256 KiB pieces."""

    def __init__(self, target: str):
        self._file = open(target, "rb")
        try:
            self._zip = zipfile.ZipFile(self._file)
        except BaseException:
            self._file.close()
            raise
        self._members = {n[:-len(".npy")]: n for n in self._zip.namelist()
                         if n.endswith(".npy")}

    def __enter__(self) -> "StoredNpz":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        self._zip.close()
        self._file.close()

    def __contains__(self, key: str) -> bool:
        return key in self._members

    def _through_zipfile(self, info: zipfile.ZipInfo) -> tuple:
        with self._zip.open(info) as f:
            arr = np.lib.format.read_array(f, allow_pickle=False)
        return arr, digest_bytes(np.ascontiguousarray(arr).data)

    def _locate(self, key: str) -> tuple:
        """``(zip info, offset of the .npy header, its length, shape,
        dtype)`` of member ``key``; the offset None for a member read
        through ``zipfile``."""
        info = self._zip.getinfo(self._members[key])
        if info.compress_type != zipfile.ZIP_STORED or info.flag_bits & 1:
            return info, None, 0, None, None
        fd = self._file.fileno()
        head = os.pread(fd, 30, info.header_offset)
        if len(head) != 30 or head[:4] != b"PK\x03\x04":
            raise zipfile.BadZipFile(f"bad local header of {info.filename!r}")
        name_len, extra_len = struct.unpack("<HH", head[26:30])
        start = info.header_offset + 30 + name_len + extra_len
        self._file.seek(start)
        version = np.lib.format.read_magic(self._file)
        if version == (1, 0):
            shape, fortran, dtype = \
                np.lib.format.read_array_header_1_0(self._file)
        elif version == (2, 0):
            shape, fortran, dtype = \
                np.lib.format.read_array_header_2_0(self._file)
        else:
            raise ValueError(f"npy format {version} of {info.filename!r}")
        if fortran or dtype.hasobject:
            return info, None, 0, None, None
        head_len = self._file.tell() - start
        nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        if head_len + nbytes != info.file_size:
            raise zipfile.BadZipFile(f"{info.filename!r}: {info.file_size} "
                                     f"bytes stored for a {head_len}-byte "
                                     f"header and {nbytes} of data")
        return info, start, head_len, shape, dtype

    def _check(self, info: zipfile.ZipInfo, start: int, head_len: int,
               crc: int, nbytes: int) -> None:
        """The archive's crc32 of the member, from its data's and its
        header's, as ``zipfile`` checks it on a read."""
        head_crc = zlib.crc32(os.pread(self._file.fileno(), head_len, start))
        if _crc32_combine(head_crc, crc, nbytes) != info.CRC:
            raise zipfile.BadZipFile(f"Bad CRC-32 for file "
                                     f"{info.filename!r}")

    def read(self, key: str) -> tuple:
        """``(array, crc32 of its C-contiguous bytes)`` of member
        ``key``."""
        info, start, head_len, shape, dtype = self._locate(key)
        if start is None:
            return self._through_zipfile(info)
        arr = np.empty(shape, dtype=dtype)
        crc = 0
        if arr.nbytes:
            flat = memoryview(arr.reshape(-1).view(np.uint8))
            offset, done = start + head_len, 0
            while done < arr.nbytes:
                n = os.preadv(self._file.fileno(), [flat[done:]],
                              offset + done)
                if n <= 0:
                    raise zipfile.BadZipFile(f"{info.filename!r} is "
                                             f"truncated")
                done += n
            crc = digest_bytes(flat)
        self._check(info, start, head_len, crc, arr.nbytes)
        return arr, crc

    def digest(self, key: str) -> tuple:
        """``(byte count, crc32)`` of member ``key``'s C-contiguous
        array bytes, read in pieces into reused buffers (no array is
        made)."""
        info, start, head_len, shape, dtype = self._locate(key)
        if start is None:
            arr, crc = self._through_zipfile(info)
            return int(arr.nbytes), crc
        nbytes = info.file_size - head_len
        crc, got = _digest_range(self._file.fileno(), start + head_len,
                                 nbytes)
        if got != nbytes:
            raise zipfile.BadZipFile(f"{info.filename!r} is truncated")
        self._check(info, start, head_len, crc, nbytes)
        return nbytes, crc


def digest_matches(nbytes: int, crc: int, want: dict) -> bool:
    """``leaf_matches`` for bytes whose count and crc32 are known."""
    return int(nbytes) == int(want["nbytes"]) and crc == int(want["crc32"])


def verify_npz_leaves(path: str, manifest_leaves: list) -> list:
    """Reload every ``leaf_<i>`` of the step's ``state.npz`` payload and
    compare it with its digest; the mismatching indices. An archive too
    corrupt to decode reports every leaf."""
    target = os.path.join(path, "state.npz")
    bad = []
    try:
        with StoredNpz(target) as data:
            for i, want in enumerate(manifest_leaves):
                key = f"leaf_{i}"
                if key not in data or \
                        not digest_matches(*data.digest(key), want):
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


# ------------------------------------------- the SDC sentinel's fingerprint
#: the signed integer type of each float width: torch has no general
#: uint32 arithmetic on CUDA, so the bits are widened to int64 and masked
_BITS_AS = {1: "int8", 2: "int16", 4: "int32"}


def params_fingerprint(leaves: Iterable[Any], axes: Optional[list] = None,
                       mesh: Any = None) -> int:
    """A bit-content reduction of parameter tensors, on their device.

    JAX's (``fleetx_tpu/resilience/integrity.py:311``): every leaf's bits
    as unsigned integers (a float as the unsigned integer of its width, a
    bool as 0 / 1, any other integer mod 2**32) summed mod 2**32, and the
    leaf sums mixed positionally, ``total = total * 1000003 + s`` mod
    2**32, so that swapped leaves do not cancel. Here each leaf's bits are
    widened to int64 and summed exactly (a leaf below 2**31 elements of at
    most 32 bits cannot overflow), and the mix runs on the host after one
    read of all the sums. Equal to the JAX value when ``leaves`` are in
    ``jax.tree.leaves`` order (``convert.jax_leaves``); the sum of a leaf
    does not depend on its layout.

    On a mesh, ``leaves`` are a rank's blocks and ``axes`` (one entry a
    leaf) the mesh axes each is split on: a leaf's sum is additive over
    its blocks, so each block's exact sum is psum'd over those axes and
    every rank gets the fingerprint of the whole tree without gathering
    a parameter."""
    import torch

    sums = []
    for i, x in enumerate(leaves):
        x = x.detach()
        if x.numel() >= 2 ** 31:
            raise ValueError(f"a leaf of {x.numel()} elements could "
                             f"overflow the int64 sum")
        if x.dtype == torch.bool:
            v = x.to(torch.int64)
        elif x.is_floating_point():
            if x.element_size() > 4:  # f64: a deterministic downcast
                x = x.to(torch.float32)
            width = x.element_size()
            v = x.contiguous().view(getattr(torch, _BITS_AS[width])) \
                .to(torch.int64).bitwise_and_((1 << (8 * width)) - 1)
        else:
            v = x.to(torch.int64).bitwise_and_(0xFFFFFFFF)
        total = v.sum()
        if axes is not None and axes[i]:
            from fleetx_tpu_torch.parallel.mesh import psum_axes

            total = psum_axes(total, axes[i], mesh)
        sums.append(total)
    total = 0
    for s in (torch.stack(sums).tolist() if sums else []):
        total = (total * 1000003 + (s & 0xFFFFFFFF)) & 0xFFFFFFFF
    return total


# ------------------------------------------------------ preflight selftest
#: crc32 of the selftest's input block, a literal: a host whose zlib
#: tables are corrupt would reproduce its own wrong value if this were
#: computed at import on the same host (the JAX module's pin)
_SELFTEST_INPUT_CRC = 0x2F5700C1


def selftest(size: int = 192, repeats: int = 3, device=None) -> dict:
    """A short compute and digest self-test of one host's device.

    A seeded f32 matmul (the JAX selftest's inputs) runs ``repeats``
    times on ``device`` (``cuda`` unless given; without a GPU that
    raises) and each result is digested: on healthy hardware every repeat
    is bit for bit the same, so digests that differ mean the device
    computes or remembers wrong. The digest machinery is pinned against a
    known crc. ``FLEETX_SELFTEST_FORCE_FAIL`` (empty, ``*`` or this
    member's ``FLEETX_PREFLIGHT_MEMBER``) fails the test on purpose, the
    drill the preflight tests use. The report has the JAX selftest's keys
    and the device."""
    import time

    import torch

    from fleetx_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    member = os.environ.get("FLEETX_PREFLIGHT_MEMBER", "0")
    t0 = time.perf_counter()
    rng = np.random.RandomState(20260803)
    a = torch.from_numpy(rng.rand(size, size).astype(np.float32)).to(dev)
    b = torch.from_numpy(rng.rand(size, size).astype(np.float32)).to(dev)
    digests = [digest_bytes((a @ b).cpu().numpy().tobytes())
               for _ in range(max(int(repeats), 2))]
    crc_ok = digest_bytes(
        np.arange(4096, dtype=np.uint32).tobytes()) == _SELFTEST_INPUT_CRC
    compute_ok = len(set(digests)) == 1
    forced = os.environ.get("FLEETX_SELFTEST_FORCE_FAIL")
    forced_fail = forced is not None and forced in ("", "*", member)
    ok = compute_ok and crc_ok and not forced_fail
    return {"ok": ok, "member": member, "compute_ok": compute_ok,
            "crc_ok": crc_ok, "forced_fail": forced_fail,
            "digests": digests,
            "elapsed_s": round(time.perf_counter() - t0, 4),
            "device": str(dev)}


def main(argv: Optional[list] = None) -> int:
    """``python -m fleetx_tpu_torch.resilience.integrity --selftest
    [--device cpu]``: the JSON report on stdout; exit 0 on a healthy
    host, 1 otherwise."""
    import argparse

    parser = argparse.ArgumentParser(
        description="fleetx integrity selftest (preflight)")
    parser.add_argument("--selftest", action="store_true",
                        help="run the compute+digest self-test")
    parser.add_argument("--device", default=None,
                        help="the device to test (default: cuda)")
    args = parser.parse_args(argv)
    if not args.selftest:
        parser.error("nothing to do (pass --selftest)")
    report = selftest(device=args.device)
    print(json.dumps(report))
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
