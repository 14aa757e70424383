"""Port parity: asynchronous checkpoint saves, the verify mode and the
newest verified step (``fleetx_tpu_torch/core/checkpoint.py``), the
engine's ``async_save`` and ``sharding_offload`` handling, against the
JAX package (``tests/test_checkpoint.py::test_async_save_resume``,
``tests/test_resilience.py::test_finalize_abandons_on_sticky_commit_
failure``, ``tests/test_zz_integrity.py``'s gc and verify drills). The
JAX side runs its per-rank npz codec, the port's codec.

Engines train the tiny GPT of ``tests/test_engine.py`` (f32, dropout 0)
from the same seeded weights on the same numpy batches.

Tolerances: steps, counters, decisions, warnings and file lists are
equal; payloads and resumed losses are equal bit for bit.
"""

import logging
import os

import numpy as np
import pytest
import torch

import jax

from fleetx_tpu.core import checkpoint as j_ckpt
from fleetx_tpu.observability.metrics import get_registry as j_registry
from fleetx_tpu.parallel.mesh import build_mesh
from fleetx_tpu.resilience import faults as j_faults
from fleetx_tpu.resilience.integrity import CheckpointIntegrityError as JCIE
from fleetx_tpu.resilience.policy import set_default_policy as j_set_policy
from fleetx_tpu.utils.log import logger as j_logger
from fleetx_tpu_torch.core import checkpoint as C
from fleetx_tpu_torch.core.engine import EagerEngine
from fleetx_tpu_torch.core.module import GPTModule
from fleetx_tpu_torch.observability.metrics import get_registry
from fleetx_tpu_torch.optims import lr_scheduler as TLR
from fleetx_tpu_torch.optims import optimizer as TOPT
from fleetx_tpu_torch.resilience import faults as faults_mod
from fleetx_tpu_torch.resilience import integrity
from fleetx_tpu_torch.resilience import policy as P
from fleetx_tpu_torch.utils.log import logger

from test_engine import build_engine, make_batches, tiny_cfg

pytestmark = pytest.mark.torch_port


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """This file's tensors are tiny: torch runs them on one intra-op
    thread (its default pool, on cores the other test workers share,
    costs far more than the work). The count is restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _isolate_process_state():
    """Reset both packages' checkpoint and fault globals after each
    test."""
    yield
    C.finalize_async_saves()
    C.set_verify_mode(True)
    faults_mod.install_plan(None)
    P.set_default_policy(None)
    j_ckpt.set_per_rank_mode(False)
    j_ckpt.set_verify_mode(True)
    j_faults.install_plan(None)
    j_set_policy(None)


LR = {"name": "cosine", "max_lr": 1e-3, "min_lr": 1e-4, "warmup_steps": 2,
      "decay_steps": 100}
OPT = {"name": "AdamW", "weight_decay": 0.01,
       "grad_clip": {"clip_norm": 1.0}}
BATCHES = make_batches(6, seed=21)


def _engine(out: str, steps: int, async_save: bool = True, **save_load):
    cfg = tiny_cfg()
    cfg["Engine"]["max_steps"] = steps
    cfg["Engine"]["save_load"] = dict(
        {"save_steps": 2, "output_dir": out, "async_save": async_save},
        **save_load)
    lr = TLR.build_lr_scheduler(LR)
    return EagerEngine(cfg, GPTModule(cfg),
                       optimizer=TOPT.build_optimizer(OPT, lr),
                       lr_schedule=lr, device="cpu")


def _count(name: str) -> float:
    return get_registry().counter(name).value


def _j_count(name: str) -> float:
    return j_registry().counter(name).value


def _payload(path: str) -> dict:
    with np.load(os.path.join(path, C.STATE_NAME)) as data:
        return {k: data[k] for k in data.files}


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    """A synchronous 6-step run saving every 2 steps: its losses and
    directory."""
    out = str(tmp_path_factory.mktemp("sync") / "ckpt")
    eng = _engine(out, 6, async_save=False)
    return {"losses": eng.fit(BATCHES), "out": out}


def test_async_save_resume(tmp_path, uninterrupted):
    """JAX's ``test_async_save_resume``: the saves overlap training, fit
    finalizes the last one, and a new engine resumes at step 4. The
    payloads and manifests equal the synchronous run's, bit for bit, and
    the losses too."""
    out = str(tmp_path / "ckpt")
    eng = _engine(out, 4)
    started = []
    real = C._AsyncSave.__init__

    def spy(self, *a, **k):
        started.append(a[1])
        real(self, *a, **k)

    C._AsyncSave.__init__ = spy
    try:
        losses = eng.fit(BATCHES)
    finally:
        C._AsyncSave.__init__ = real
    assert started == [2, 4] and not C._pending
    assert C.latest_step(out) == 4 and C.completed_steps(out) == [2, 4]
    assert losses == uninterrupted["losses"][:4]
    for step in (2, 4):
        mine = _payload(C.step_dir(out, step))
        want = _payload(C.step_dir(uninterrupted["out"], step))
        assert sorted(mine) == sorted(want)
        assert all(np.array_equal(mine[k], want[k]) for k in mine)
        assert integrity.read_manifest(C.step_dir(out, step))["leaves"] == \
            integrity.read_manifest(
                C.step_dir(uninterrupted["out"], step))["leaves"]
    eng2 = _engine(out, 4)
    eng2.prepare()
    assert eng2.load(out) and eng2.step == 4


def test_sticky_writer_failure_abandons_the_save(tmp_path):
    """A writer that fails past its retries abandons the save at
    finalize (JAX's ``test_finalize_abandons_on_sticky_commit_failure``):
    ``ckpt_failed_total`` counts it, the half-written directory is gone,
    no meta, and training goes on to the next save."""
    out = str(tmp_path / "ckpt")
    eng = _engine(out, 4)  # its disabled Resilience resets the policy
    P.set_default_policy(P.RetryPolicy(max_attempts=2, backoff_s=0.0,
                                       jitter=0.0))
    faults_mod.install_plan(faults_mod.FaultPlan(ckpt_write_fail_times=2))
    failed = _count("ckpt_failed_total")
    losses = eng.fit(BATCHES)  # must not raise
    assert len(losses) == 4
    assert _count("ckpt_failed_total") - failed == 1
    assert not os.path.exists(C.step_dir(out, 2))
    assert C.completed_steps(out) == [4] and not C._pending


def test_kill_with_a_save_outstanding_then_a_clean_resume(tmp_path,
                                                          uninterrupted):
    """A process that dies with an asynchronous save outstanding leaves a
    step directory with its payload and no meta: readers skip it, the
    resume restores the step before, the next save of that step replaces
    it, and the resumed losses equal the uninterrupted run's bit for
    bit."""
    out = str(tmp_path / "ckpt")
    eng = _engine(out, 3)
    eng.fit(BATCHES[:3])  # steps 1-3: step 2 finalized at fit's end
    batch = eng.to_device(BATCHES[3])
    eng.train_step(batch)
    eng.save()  # step 4, outstanding
    dying = C._pending.pop()  # the process "dies": nobody finalizes
    dying.thread.join()
    assert os.path.exists(os.path.join(C.step_dir(out, 4), C.STATE_NAME))
    assert C.completed_steps(out) == [2] and C.peek_meta(out)["step"] == 2
    resume = _engine(out, 6, ckpt_dir=out)
    losses = resume.fit(BATCHES[2:])
    assert C.completed_steps(out) == [2, 4, 6]
    assert losses == uninterrupted["losses"][2:]


def test_gc_spares_the_newest_verified_step(tmp_path):
    """JAX's ``test_gc_never_prunes_the_last_verified_step`` on both
    packages: a verified restore of step 2 after steps 6 and 4 rot keeps
    step 2 through ``keep_last=1``; the same steps pruned."""
    j_ckpt.set_per_rank_mode(True)
    got = {}
    for side in ("jax", "port"):
        d = str(tmp_path / side)
        for s in (2, 4, 6):
            if side == "jax":
                j_ckpt.save_checkpoint(d, s, {"w": np.arange(
                    4, dtype=np.float32)}, meta={})
            else:
                C.save_checkpoint(d, s, {"w": torch.arange(
                    4, dtype=torch.float32)}, meta={})
        for s in (6, 4):
            _flip(os.path.join(d, f"step_{s}", C.STATE_NAME))
        if side == "jax":
            abstract = {"w": jax.ShapeDtypeStruct((4,), np.float32)}
            with pytest.raises(JCIE):
                j_ckpt.load_checkpoint(d, 6, abstract)
            j_ckpt.load_checkpoint(d, 2, abstract)
            pruned = j_ckpt.gc_checkpoints(d, keep_last=1)
        else:
            with pytest.raises(C.CheckpointIntegrityError):
                C.load_checkpoint(d, 6)
            C.load_checkpoint(d, 2)
            pruned = C.gc_checkpoints(d, keep_last=1)
        got[side] = (pruned, j_ckpt.completed_steps(d))
    assert got["port"] == got["jax"] == (1, [2, 6])


def _flip(path: str) -> None:
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.seek(size // 2)
        byte = f.read(1)
        f.seek(size // 2)
        f.write(bytes([byte[0] ^ 0xFF]))


def _rewrite_leaf(path: str) -> None:
    """Silent corruption: ``state.npz`` rewritten whole (a valid
    archive) with its first leaf's values changed."""
    target = os.path.join(path, C.STATE_NAME)
    data = _payload(path)
    data["leaf_0"] = data["leaf_0"] + 1
    with open(target, "wb") as f:
        np.savez(f, **data)


def test_verify_off_takes_the_jax_decisions_and_counts(tmp_path):
    """``verify_checkpoints: false`` on both packages over one sequence:
    no manifest; a silently rewritten payload restores unverified with
    the rewritten values; ``peek_meta`` takes the newest completed step;
    the verify mode back on refuses it. ``ckpt_verify_total`` and
    ``ckpt_verify_failed`` move alike on both."""
    j_ckpt.set_per_rank_mode(True)
    moves = {}
    for side in ("jax", "port"):
        lib = j_ckpt if side == "jax" else C
        count = _j_count if side == "jax" else _count
        before = [count("ckpt_verify_total"), count("ckpt_verify_failed")]
        d = str(tmp_path / side)
        w = np.arange(8, dtype=np.float32)
        state = {"w": w} if side == "jax" else {"w": torch.from_numpy(w)}
        abstract = {"w": jax.ShapeDtypeStruct((8,), np.float32)}

        def load(step):
            if side == "jax":
                return np.asarray(lib.load_checkpoint(d, step, abstract)[0]
                                  ["w"])
            return lib.load_checkpoint(d, step)[0]["w"].numpy()

        lib.save_checkpoint(d, 2, state, meta={})  # verified
        assert os.path.exists(os.path.join(d, "step_2",
                                           integrity.MANIFEST_NAME))
        lib.set_verify_mode(False)
        lib.save_checkpoint(d, 4, state, meta={})
        assert not os.path.exists(os.path.join(d, "step_4",
                                               integrity.MANIFEST_NAME))
        _rewrite_leaf(os.path.join(d, "step_2"))
        assert np.array_equal(load(2), w + 1)  # restored unverified
        assert lib.peek_meta(d)["step"] == 4
        lib.set_verify_mode(True)
        with pytest.raises((JCIE, C.CheckpointIntegrityError)):
            load(2)
        assert np.array_equal(load(4), w)  # no manifest: unverified
        moves[side] = [count("ckpt_verify_total") - before[0],
                       count("ckpt_verify_failed") - before[1]]
    assert moves["port"] == moves["jax"] == [2, 1]


def test_engine_sets_the_verify_mode(tmp_path):
    cfg = tiny_cfg()
    cfg["Resilience"] = {"integrity": {"verify_checkpoints": False}}
    lr = TLR.build_lr_scheduler(LR)
    EagerEngine(cfg, GPTModule(cfg), optimizer=TOPT.build_optimizer(OPT, lr),
                lr_schedule=lr, device="cpu")
    assert C.verify_mode() is False
    cfg["Resilience"] = None
    EagerEngine(cfg, GPTModule(cfg), optimizer=TOPT.build_optimizer(OPT, lr),
                lr_schedule=lr, device="cpu")
    assert C.verify_mode() is True


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        if "sharding_offload" in record.getMessage():
            self.lines.append(record.getMessage())


@pytest.mark.parametrize("hbm_gb", [None, 1e-4])
def test_sharding_offload_warnings_equal_the_jax_engines(devices8, hbm_gb):
    """``sharding_offload: true``: the JAX engine's warnings on the CPU,
    in its order and words (the step fits without it, unless the budget
    is tiny; the backend is not a TPU), and no offload after."""
    cfg = tiny_cfg()
    cfg["Distributed"] = {"sharding": {"sharding_offload": True}}
    if hbm_gb:
        cfg["Distributed"]["auto_layout"] = {"hbm_gb": hbm_gb}
    got = {}
    for side, lg in (("jax", j_logger), ("port", logger)):
        handler = _Lines()
        lg.addHandler(handler)
        try:
            if side == "jax":
                eng = build_engine(cfg, build_mesh({}, devices=devices8[:1]))
            else:
                lr = TLR.build_lr_scheduler(LR)
                eng = EagerEngine(cfg, GPTModule(cfg),
                                  optimizer=TOPT.build_optimizer(OPT, lr),
                                  lr_schedule=lr, device="cpu")
        finally:
            lg.removeHandler(handler)
        assert eng.sharding_offload is False
        got[side] = handler.lines
    assert got["port"] == got["jax"]
    assert len(got["port"]) == (1 if hbm_gb else 2)
    assert "requires a TPU backend" in got["port"][-1]


# ------------------------------------------------------------- the codec
@pytest.fixture
def small_pieces(monkeypatch):
    """The threaded digests on pieces of 64 bytes, from 128."""
    monkeypatch.setattr(integrity, "_PAR_CHUNK", 64)
    monkeypatch.setattr(integrity, "_PAR_MIN", 128)


@pytest.mark.parametrize("n", [0, 1, 127, 128, 129, 192, 64 * 5 + 3])
def test_threaded_digests_equal_zlib_and_the_jax_packages(
        tmp_path, small_pieces, n):
    """A buffer and a file digested in pieces on threads give
    ``zlib.crc32``'s value, continued from any seed, and the JAX
    package's ``digest_bytes``."""
    import zlib

    from fleetx_tpu.resilience import integrity as j_integrity

    data = np.random.default_rng(n).integers(0, 256, n, np.uint8).tobytes()
    for seed in (0, 7, 0xFFFFFFFF):
        assert integrity.digest_bytes(data, seed) == zlib.crc32(data, seed) \
            == j_integrity.digest_bytes(data, seed)
    path = tmp_path / "blob"
    path.write_bytes(data)
    assert integrity._digest_file(str(path)) == {"crc32": zlib.crc32(data),
                                                 "size": n}


def _codec_arrays() -> dict:
    rng = np.random.default_rng(3)
    return {"f32": rng.standard_normal((7, 9)).astype(np.float32),
            "bits": rng.integers(0, 2 ** 16, 50, dtype=np.uint16),
            "flags": np.array([True, False, True]),
            "count": np.array(7, np.int64),
            "empty": np.zeros((0, 3), np.float32),
            "names": np.array(["params/w", "opt/m"], dtype=str),
            "fortran": np.asfortranarray(rng.standard_normal((5, 6)))}


def test_stored_npz_reads_what_np_load_reads(tmp_path, small_pieces):
    """Every member of an ``np.savez`` archive read straight from the
    file equals ``np.load``'s, with the crc32 of its bytes, which the
    member's digest alone (no array made) gives too."""
    import zlib

    arrays = _codec_arrays()
    path = str(tmp_path / "state.npz")
    np.savez(path, **arrays)
    with integrity.StoredNpz(path) as got, np.load(path) as want:
        assert "f32" in got and "leaf_0" not in got
        for key in arrays:
            arr, crc = got.read(key)
            assert arr.dtype == want[key].dtype and np.array_equal(
                arr, want[key])
            assert crc == zlib.crc32(np.ascontiguousarray(arr).tobytes())
            assert got.digest(key) == (arr.nbytes, crc)


@pytest.mark.parametrize("where", ["data", "header"])
def test_stored_npz_refuses_a_flipped_byte(tmp_path, small_pieces, where):
    """A byte flipped in a member's data or its ``.npy`` header fails
    the read and the digest, as ``np.load`` fails it."""
    path = str(tmp_path / "state.npz")
    np.savez(path, w=np.arange(1000, dtype=np.float32))
    with open(path, "rb") as f:
        blob = f.read()
    start = blob.index(b"\x93NUMPY")
    offset = start + 20 if where == "header" else len(blob) // 2
    _flip_at(path, offset)
    with pytest.raises(Exception):
        with np.load(path) as data:
            data["w"]
    for method in ("read", "digest"):
        with pytest.raises(Exception):
            with integrity.StoredNpz(path) as data:
                getattr(data, method)("w")


def _flip_at(path: str, offset: int) -> None:
    with open(path, "r+b") as f:
        f.seek(offset)
        byte = f.read(1)
        f.seek(offset)
        f.write(bytes([byte[0] ^ 0xFF]))
