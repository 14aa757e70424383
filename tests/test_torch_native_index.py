"""The port's native index builder, its datasets and its shard runner,
against the JAX package.

- ``fleetx_tpu_torch.data.native`` (``index_builder.cpp`` built with
  ``g++`` into ``fleetx_tpu_torch/_build/``) equals the JAX package's
  numpy builders and JAX's native builder byte for byte, on
  ``tests/test_native_index.py``'s random corpora and blends;
- ``GPTDataset`` and ``BlendedDataset`` of the port, whose indices now
  come from the native builder (the numpy builders made to raise, so the
  fallback cannot hide a failure), yield JAX's samples on a corpus the
  test writes;
- ``tools/multiprocess_tool.run_commands`` gives JAX's return codes for
  an exit code, a timeout (its whole process group killed), a command
  ``stop_on_error`` cancelled and a signal death.

Where this host has no ``g++`` the native cases skip, naming it.
Tolerance: exact (integer indices and token samples).
"""

import os
import shutil

import numpy as np
import pytest

from fleetx_tpu.data.dataset import gpt_dataset as JG
from fleetx_tpu.tools import multiprocess_tool as j_mp
from fleetx_tpu_torch.data import native
from fleetx_tpu_torch.data.dataset import gpt_dataset as TG
from fleetx_tpu_torch.tools import multiprocess_tool as t_mp

pytestmark = pytest.mark.torch_port


@pytest.fixture(scope="module")
def builders():
    """The port's native builder, and JAX's (built by its own ``make``)
    when that builds; skips where there is no C++ compiler."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this host: the native builder cannot build")
    native.index_builder._ensure()
    from fleetx_tpu.data import native as j_native

    try:
        j_native.index_builder._ensure()
        jax_native = j_native.index_builder
    except Exception:  # noqa: BLE001 — JAX's make may be missing; numpy stays
        jax_native = None
    return native.index_builder, jax_native


def _sample_case(seed: int):
    """``tests/test_native_index.py``'s random corpus for ``seed``."""
    rng = np.random.RandomState(seed)
    n_docs = rng.randint(1, 200)
    sizes = rng.randint(1, 50, size=n_docs).astype(np.int32)
    if seed % 2:
        sizes[rng.randint(0, n_docs, size=max(1, n_docs // 10))] = 0
    epochs = rng.randint(1, 4)
    doc_idx = np.tile(np.arange(n_docs, dtype=np.int32), epochs)
    rng.shuffle(doc_idx)
    seq_length = int(rng.randint(4, 33))
    total = int(sizes[doc_idx].sum())
    num_samples = int(rng.randint(1, max(2, (total - 1) // seq_length + 5)))
    return sizes, doc_idx, seq_length, num_samples, total


def _blend_case(seed: int):
    rng = np.random.RandomState(seed)
    n = rng.randint(2, 8)
    w = rng.rand(n) + 0.01
    return w / w.sum(), int(rng.randint(10, 2000))


CASES = [("sample", s) for s in range(5)] + [("blend", s) for s in range(3)]


@pytest.mark.parametrize("kind,seed", CASES)
def test_native_builder_equals_both_jax_builders(builders, kind, seed):
    ours, jax_native = builders
    if kind == "sample":
        sizes, doc_idx, seq, n, total = _sample_case(seed)
        assert total > seq, "every seeded corpus is longer than a sample"
        got = ours.build_sample_idx(sizes, doc_idx, seq, n)
        refs = [JG.build_sample_idx(sizes, doc_idx, seq, n)]
        if jax_native is not None:
            refs.append(jax_native.build_sample_idx(sizes, doc_idx, seq, n))
        for ref in refs:
            assert got.dtype == ref.dtype and got.shape == ref.shape
            assert got.tobytes() == ref.tobytes()
        return
    w, n = _blend_case(seed)
    got = ours.build_blending_indices(w, n)
    refs = [JG.build_blending_indices(w, n)]
    if jax_native is not None:
        refs.append(jax_native.build_blending_indices(w, n))
    for ref in refs:
        for a, b in zip(got, ref):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    counts = np.bincount(got[0], minlength=len(w))
    np.testing.assert_allclose(counts / n, w, atol=len(w) / n)


def test_library_lands_in_the_build_dir_and_refuses_bad_input(builders):
    ours, _ = builders
    assert ours.path == native.library_path()
    assert os.path.dirname(ours.path) == native.BUILD_DIR
    assert os.path.basename(native.BUILD_DIR) == "_build"
    assert not [n for n in os.listdir(os.path.dirname(native.SOURCE))
                if n.endswith(".so")]        # the package dir stays clean
    with pytest.raises(ValueError, match="blended datasets"):
        ours.build_blending_indices(np.ones(native.MAX_BLENDED + 1), 4)
    with pytest.raises(ValueError, match="outside sizes"):
        ours.build_sample_idx(np.ones(3, np.int32),
                              np.array([0, 3], np.int32), 1, 1)


def _corpus(root, name: str, seed: int) -> str:
    rng = np.random.RandomState(seed)
    docs = [rng.randint(0, 500, size=rng.randint(1, 90)).tolist()
            for _ in range(40)]
    prefix = os.path.join(root, name)
    JG.write_corpus(prefix, docs)
    return prefix


def test_datasets_yield_the_jax_samples_through_the_native_builder(
        builders, tmp_path, monkeypatch):
    def numpy_path(*args, **kwargs):
        raise AssertionError("the numpy fallback ran")

    monkeypatch.setattr(TG, "build_sample_idx", numpy_path)
    monkeypatch.setattr(TG, "build_blending_indices", numpy_path)
    prefixes = [_corpus(str(tmp_path), f"shard{i}", i) for i in range(2)]
    kw = dict(num_samples=60, seq_length=16, seed=1234, eos_id=499)
    ours = [TG.GPTDataset(p, name=f"s{i}", cache_dir=str(tmp_path / "t"),
                          **kw) for i, p in enumerate(prefixes)]
    theirs = [JG.GPTDataset(p, name=f"s{i}", cache_dir=str(tmp_path / "j"),
                            **kw) for i, p in enumerate(prefixes)]
    for a, b in zip(ours, theirs):
        assert len(a) == len(b) > 0
        for kind in ("doc_idx", "sample_idx", "shuffle_idx"):
            assert np.asarray(getattr(a, kind)).tobytes() == \
                np.asarray(getattr(b, kind)).tobytes(), kind
    blend_t = TG.BlendedDataset(ours, [0.3, 0.7], 50)
    blend_j = JG.BlendedDataset(theirs, [0.3, 0.7], 50)
    assert len(blend_t) == len(blend_j) == 50
    for i in range(len(blend_t)):
        got, want = blend_t[i], blend_j[i]
        assert sorted(got) == sorted(want)
        for key in want:
            assert got[key].dtype == want[key].dtype
            assert np.array_equal(got[key], want[key]), (i, key)
    # a second dataset on the same cache reads the files the first wrote
    again = TG.GPTDataset(prefixes[0], name="s0",
                          cache_dir=str(tmp_path / "t"), **kw)
    assert np.array_equal(again[3]["tokens"], ours[0][3]["tokens"])


RUNS = {
    "exit_codes": (["exit 3", "true", "exit 0"], {}),
    "timeout": (["sleep 5", "true"], {"timeout": 0.5}),
    # one worker: whether it takes the second command before the failure
    # cancels it is a race in both runners; the third is always cancelled
    # (the second holds the worker for a second)
    "cancelled": (["exit 4", "sleep 1", "true", "true"],
                  {"num_workers": 1, "stop_on_error": True}),
    "signal_death": (["kill -TERM $$", "kill -INT $$"], {}),
}


@pytest.mark.parametrize("case", sorted(RUNS))
def test_run_commands_equals_the_jax_runner(case):
    commands, kw = RUNS[case]
    got = t_mp.run_commands(commands, **kw)
    want = j_mp.run_commands(commands, **kw)
    assert (t_mp.RC_CANCELLED, t_mp.RC_TIMEOUT) == (j_mp.RC_CANCELLED,
                                                    j_mp.RC_TIMEOUT)
    if case == "cancelled":
        for codes in (got, want):
            assert codes[1] in (0, t_mp.RC_CANCELLED)
            codes[1] = None
    assert got == want
    assert got == {"exit_codes": [3, 0, 0],
                   "timeout": [t_mp.RC_TIMEOUT, 0],
                   "cancelled": [4, None, t_mp.RC_CANCELLED,
                                 t_mp.RC_CANCELLED],
                   "signal_death": [143, 130]}[case]


def test_a_timeout_kills_the_whole_pipeline(tmp_path):
    marker = tmp_path / "late"
    rc = t_mp.run_commands([f"sleep 1 && touch {marker}"], timeout=0.3)
    assert rc == [t_mp.RC_TIMEOUT]
    import time

    time.sleep(1.5)
    assert not marker.exists()             # the sleep's group went too
