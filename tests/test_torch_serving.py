"""Port parity: the serving slice as a whole (``fleetx_tpu_torch/serving``).

The JAX params come from ``model.init(PRNGKey(0))`` at the tiny config of
``tests/test_zz_serving.py`` and pass through ``convert.params_from_jax``,
so both sides run the same weights. The JAX side runs as its own serving
tests run it on the CPU (the Pallas decode kernel in interpret mode); the
port runs on CPU tensors (the kernel's plain version).

Tolerances: ``_forward`` hidden states and written pools agree within
f32 atol 1e-4 (the same math, summed in another order by another
library); greedy serving tokens must be IDENTICAL.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fleetx_tpu.models.gpt import generation as JG
from fleetx_tpu.models.gpt.model import GPTForPretraining
from fleetx_tpu.models.gpt.model import config_from_dict as j_config
from fleetx_tpu.serving import decode as JD
from fleetx_tpu.serving.engine import ServingConfig as JServingConfig
from fleetx_tpu.serving.engine import ServingEngine as JServingEngine
from fleetx_tpu_torch.convert import params_from_jax
from fleetx_tpu_torch.models.gpt import generation as TG
from fleetx_tpu_torch.models.gpt.model import config_from_dict as t_config
from fleetx_tpu_torch.serving import decode as TD
from fleetx_tpu_torch.serving.engine import ServingConfig as TServingConfig
from fleetx_tpu_torch.serving.engine import ServingEngine as TServingEngine
from fleetx_tpu_torch.serving.paged_cache import (NULL_PAGE, PageAllocator,
                                                  PageAllocatorError,
                                                  init_pool)

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

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL_DICT = dict(vocab_size=97, hidden_size=64, num_layers=2,
                  num_attention_heads=4, max_position_embeddings=64,
                  hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
                  use_flash_attention=False, dtype="float32",
                  param_dtype="float32")
EOS = 96


@pytest.fixture(scope="module")
def weights():
    """(jax cfg, jax params, port cfg, port params) on the same weights."""
    from flax.core import meta

    jcfg = j_config(MODEL_DICT)
    jparams = meta.unbox(GPTForPretraining(jcfg).init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 8), jnp.int32),
        None, deterministic=True)["params"])
    tcfg = t_config(MODEL_DICT)
    tparams = params_from_jax(jax.device_get(jparams), tcfg, "cpu")
    return jcfg, jparams, tcfg, tparams


def test_converter_rejects_missing_extra_and_misshapen_leaves(weights):
    jcfg, jparams, tcfg, _ = weights
    tree = jax.device_get(jparams)
    bad = {"gpt": dict(tree["gpt"])}
    del bad["gpt"]["ln_f"]
    with pytest.raises(ValueError, match="missing leaves"):
        params_from_jax(bad, tcfg)
    bad = {"gpt": dict(tree["gpt"], extra=np.zeros(3))}
    with pytest.raises(ValueError, match="unexpected leaves"):
        params_from_jax(bad, tcfg)
    wide = t_config(dict(MODEL_DICT, vocab_size=98))
    with pytest.raises(ValueError, match="word_embeddings"):
        params_from_jax(tree, wide)


# ---------------------------------------------------------------------------
# _forward: prefill and decode shapes, both decode attention paths
# ---------------------------------------------------------------------------

def _pools(cfg, rng, pages, ps):
    """Random (K, V) pool contents as numpy, shared by both sides."""
    shape = (cfg.num_layers, pages, ps, cfg.num_attention_heads,
             cfg.head_dim)
    return (rng.randn(*shape).astype(np.float32),
            rng.randn(*shape).astype(np.float32))


@pytest.mark.parametrize("mode", ["prefill", "decode_gather",
                                  "decode_kernel"])
def test_forward_matches_jax(weights, mode):
    jcfg, jparams, tcfg, tparams = weights
    rng = np.random.RandomState(0)
    pages, ps, ppr = 12, 4, 4
    pk, pv = _pools(tcfg, rng, pages, ps)
    if mode == "prefill":
        tokens = rng.randint(0, 97, size=(1, 8)).astype(np.int32)
        positions = np.array([[4, 5, 6, 7, 8, -1, -1, -1]], np.int32)
        tables = np.array([[3, 7, 5, NULL_PAGE]], np.int32)
    else:
        tokens = rng.randint(0, 97, size=(4,)).astype(np.int32)[:, None]
        positions = np.array([[9], [-1], [0], [15]], np.int32)
        tables = np.array([[1, 2, 4, NULL_PAGE], [NULL_PAGE] * 4,
                           [6, NULL_PAGE, NULL_PAGE, NULL_PAGE],
                           [8, 9, 10, 11]], np.int32)
    kernel = mode == "decode_kernel"
    jx, jk, jv = JD._forward(jparams, jcfg, jnp.asarray(tokens),
                             jnp.asarray(positions), jnp.asarray(pk),
                             jnp.asarray(pv), jnp.asarray(tables), False,
                             paged_kernel=kernel)
    tk, tv = torch.from_numpy(pk.copy()), torch.from_numpy(pv.copy())
    tx, tk2, tv2 = TD._forward(tparams, tcfg, torch.from_numpy(tokens),
                               torch.from_numpy(positions), tk, tv,
                               torch.from_numpy(tables), paged_kernel=kernel)
    assert tk2 is tk and tv2 is tv  # updated in place
    valid = (positions >= 0).reshape(-1)
    np.testing.assert_allclose(tx.numpy().reshape(-1, 64)[valid],
                               np.asarray(jx).reshape(-1, 64)[valid],
                               atol=1e-4, rtol=0)
    # every page but the null page (invalid slots scatter there, with
    # duplicate indices whose winner is unspecified on both sides)
    for j, t in ((jk, tk), (jv, tv)):
        np.testing.assert_allclose(t.numpy()[:, 1:], np.asarray(j)[:, 1:],
                                   atol=1e-4, rtol=0)


# ---------------------------------------------------------------------------
# the engine: greedy tokens identical to the JAX engine
# ---------------------------------------------------------------------------

def _drive(engine, case):
    """One request mix; returns (tokens, preemptions) per request."""
    if case == "chunked_prefill":
        prompts = [[5, 9, 23, 41], [7, 3],
                   [11, 2, 8, 4, 19, 33, 7, 6, 1, 2, 3]]  # 11 > chunk of 4
        reqs = [engine.submit(p, 6, request_id=f"r{i}")
                for i, p in enumerate(prompts)]
    elif case == "join_mid_stream":
        a = engine.submit([5, 9, 23, 41], 8, request_id="a")
        for _ in range(4):  # prefill + a few decode steps
            engine.step()
        assert a.state == "running" and len(a.tokens) >= 1
        reqs = [a, engine.submit([7, 3, 11], 8, request_id="b")]
    else:  # preempt_youngest: 8 usable pages for 4 growing requests
        reqs = [engine.submit([5 + i, 9, 23, 41], 8, request_id=f"pe{i}")
                for i in range(4)]
    engine.run_until_drained()
    assert all(r.state == "finished" and r.error is None for r in reqs)
    assert engine.allocator.allocated_pages == 0
    return [r.tokens for r in reqs], [r.preemptions for r in reqs]


@pytest.mark.parametrize("case", ["chunked_prefill", "join_mid_stream",
                                  "preempt_youngest"])
def test_engine_tokens_identical_to_jax_engine(weights, case):
    jcfg, jparams, tcfg, tparams = weights
    geo = dict(max_batch=4, page_size=4, max_seq_len=32, prefill_chunk=4,
               num_pages=9 if case == "preempt_youngest" else 33)
    jeng = JServingEngine(jcfg, jparams, JServingConfig(**geo),
                          eos_token_id=EOS)
    teng = TServingEngine(tcfg, tparams, TServingConfig(**geo),
                          eos_token_id=EOS, device="cpu")
    assert jeng.paged_kernel_active and teng.paged_kernel_active
    want, want_pre = _drive(jeng, case)
    got, got_pre = _drive(teng, case)
    assert got == want
    assert got_pre == want_pre
    if case == "preempt_youngest":
        assert sum(got_pre) > 0 and got_pre[0] == 0
    snap = teng.serving_snapshot()
    assert snap["decode_path"] == "paged_kernel"
    assert snap["requests_completed"] >= len(got)


def test_gather_engine_tokens_identical_to_kernel_engine(weights):
    """The engine with ``paged_kernel: false`` takes the gather path and
    decodes the same greedy tokens."""
    _, _, tcfg, tparams = weights
    geo = dict(max_batch=4, page_size=4, max_seq_len=32, prefill_chunk=4,
               num_pages=33)
    runs = {}
    for kernel in (True, False):
        eng = TServingEngine(tcfg, tparams,
                             TServingConfig(**geo, paged_kernel=kernel),
                             eos_token_id=EOS, device="cpu")
        assert eng.serving_snapshot()["decode_path"] == \
            ("paged_kernel" if kernel else "gather")
        runs[kernel] = _drive(eng, "chunked_prefill")[0]
    assert runs[True] == runs[False]


# ---------------------------------------------------------------------------
# page allocator units (tests/test_zz_serving.py:72-118 against the port)
# ---------------------------------------------------------------------------

def _alloc_roundtrip():
    a = PageAllocator(num_pages=5, page_size=4)
    assert a.usable_pages == 4 and a.free_pages == 4
    pages = a.alloc(4)
    assert pages is not None and len(set(pages)) == 4
    assert NULL_PAGE not in pages
    assert a.free_pages == 0 and a.occupancy() == 1.0
    a.free(pages)
    assert a.free_pages == 4 and a.allocated_pages == 0
    assert a.occupancy() == 0.0


def _oom_all_or_nothing():
    a = PageAllocator(num_pages=4, page_size=4)
    assert a.alloc(4) is None  # only 3 usable — no partial grant
    assert a.free_pages == 3
    first = a.alloc(2)
    assert a.alloc(2) is None and a.free_pages == 1
    a.free(first)
    assert a.alloc(3) is not None


def _fits_ever_vs_can_allocate():
    a = PageAllocator(num_pages=4, page_size=4)
    held = a.alloc(2)
    assert a.fits_ever(3) and not a.can_allocate(3)
    assert not a.fits_ever(4)
    a.free(held)
    assert a.can_allocate(3)


def _pages_needed_and_fragmentation():
    a = PageAllocator(num_pages=9, page_size=4)
    assert a.pages_needed(1) == 1 and a.pages_needed(4) == 1
    assert a.pages_needed(5) == 2 and a.pages_needed(0) == 1
    a.alloc(2)  # 8 slots reserved
    assert a.internal_fragmentation(used_slots=6) == pytest.approx(0.25)
    assert a.internal_fragmentation(used_slots=8) == 0.0
    assert a.internal_fragmentation(used_slots=0) == 1.0


def _free_list_reuses_freed_pages():
    a = PageAllocator(num_pages=4, page_size=4)
    pages = a.alloc(3)
    a.free(pages)
    assert sorted(a.alloc(3)) == sorted(pages)


def _errors_are_real_exceptions():
    a = PageAllocator(num_pages=6, page_size=4)
    pages = a.alloc(2)
    a.free(pages)
    for bad in (lambda: a.free(pages), lambda: a.free([NULL_PAGE]),
                lambda: a.alloc(0), lambda: a.alloc(-3)):
        with pytest.raises(PageAllocatorError):
            bad()
    assert a.alloc(6) is None  # exhaustion stays None


ALLOCATOR_CASES = {f.__name__.lstrip("_"): f for f in (
    _alloc_roundtrip, _oom_all_or_nothing, _fits_ever_vs_can_allocate,
    _pages_needed_and_fragmentation, _free_list_reuses_freed_pages,
    _errors_are_real_exceptions)}


@pytest.mark.parametrize("case", sorted(ALLOCATOR_CASES))
def test_page_allocator(case):
    ALLOCATOR_CASES[case]()


def test_init_pool_layout(weights):
    _, _, tcfg, _ = weights
    k, v = init_pool(tcfg, 9, 4, device="cpu")
    assert k.shape == v.shape == (2, 9, 4, 4, 16)
    assert k.dtype == torch.float32 and not k.any()


# ---------------------------------------------------------------------------
# sampling transforms and config loading
# ---------------------------------------------------------------------------

def test_sampling_transforms_match_jax():
    logits = np.random.RandomState(0).randn(3, 97).astype(np.float32) * 3
    jl, tl = jnp.asarray(logits), torch.from_numpy(logits)
    steps = [("apply_temperature", 0.7), ("apply_top_k", 5),
             ("apply_top_p", 0.9), ("apply_top_k", 0), ("apply_top_p", 1.0)]
    for name, arg in steps:
        j = np.asarray(getattr(JG, name)(jl, arg))
        t = getattr(TG, name)(tl, arg).numpy()
        np.testing.assert_array_equal(t == TG.NEG_INF, j == JG.NEG_INF)
        np.testing.assert_allclose(t, j, rtol=1e-6, err_msg=name)
        jl, tl = jnp.asarray(j), torch.from_numpy(t)
    assert TG.NEG_INF == float(JG.NEG_INF)


def test_serving_recipe_config_matches_jax_loader():
    from fleetx_tpu.utils import config as jconfig
    from fleetx_tpu_torch.utils import config as tconfig

    path = os.path.join(REPO, "fleetx_tpu", "configs", "nlp", "gpt",
                        "serving_gpt_345M.yaml")
    want = jconfig.process_serving_config(jconfig.parse_config(path))
    got = tconfig.process_serving_config(tconfig.parse_config(path))
    assert got == want
    sc = TServingConfig.from_dict(dict(got["Serving"]))
    assert (sc.max_batch, sc.page_size, sc.num_pages, sc.max_seq_len,
            sc.prefill_chunk) == (16, 16, 513, 1024, 128)
    cfg = t_config(dict(got["Model"]))
    assert (cfg.num_layers, cfg.hidden_size, cfg.num_attention_heads,
            cfg.head_dim, cfg.vocab_size, cfg.dtype) == \
        (24, 1024, 16, 64, 50304, torch.bfloat16)
    over = tconfig.override_config(tconfig.parse_config(path),
                                   ["Serving.max_batch=4", "Model.dtype=x"])
    assert over.Serving.max_batch == 4 and over.Model.dtype == "x"
    bad = tconfig.parse_config(path)
    bad["Serving"]["router"]["hedge_ms"] = -1
    with pytest.raises(ValueError, match="Serving.router invalid"):
        tconfig.process_serving_config(bad)
