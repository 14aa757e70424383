"""Port parity: generation (``fleetx_tpu_torch/models/gpt/generation.py``
and the dense decode cache of ``models/gpt/model.py``;
``GPTGenerationModule`` and the task entry point are
``tests/test_torch_generation_task.py``).

The weights are drawn with numpy from a seed (wider than the init, so
the continuations vary), fed to the JAX model as they are and to the
port through ``convert.params_from_jax``. Two configs: the tiny f32 model
of ``tests/test_zz_serving.py`` (hidden 64, plain LayerNorm on both
sides), and hidden 128 with ``fused_residual_norm`` on (the JAX side runs
its Pallas kernel in interpret mode where its gate admits the shape, the
port the kernel's plain version on CPU tensors).

Tolerances (f32): cached logits of the prefill and of each decode step
atol 1e-5; greedy and beam-search tokens IDENTICAL; beam scores atol
1e-5; processors atol 1e-6 on the values and exact on which entries they
mask. Sampling is not bit-equal to ``jax.random`` (the port draws from a
``torch.Generator``): it is held to the same support and to
reproducibility under one seed.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fleetx_tpu.models.gpt import generation as JG
from fleetx_tpu.models.gpt.model import GPTForPretraining
from fleetx_tpu.models.gpt.model import config_from_dict as j_config
from fleetx_tpu.models.gpt.model import init_cache as j_init_cache
from fleetx_tpu_torch.convert import params_from_jax
from fleetx_tpu_torch.models.gpt import generation as G
from fleetx_tpu_torch.models.gpt import model as M
from fleetx_tpu_torch.ops import fused_norm as FN

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

BASE = dict(vocab_size=97, num_layers=2, max_position_embeddings=64,
            hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
            use_flash_attention=False, dtype="float32",
            param_dtype="float32")
CONFIGS = {
    "tiny64": dict(BASE, hidden_size=64, num_attention_heads=4,
                   fused_residual_norm=False),
    "fused128": dict(BASE, hidden_size=128, num_attention_heads=2,
                     fused_residual_norm=True),
}
PROMPTS = [[5, 9, 23, 41, 7], [3, 4], [60, 61, 62, 63, 64, 65, 66, 2],
           [88]]
PAD = 0
#: the JAX decoders compiled whole (the model and the config static), as
#: a caller jits them; eager dispatch of their loops costs seconds a call
JGENERATE = jax.jit(JG.generate, static_argnums=(0, 2))
JBEAM = jax.jit(JG.beam_search, static_argnums=(0, 2))


def _weights(cfg: M.GPTConfig, seed: int = 0) -> dict:
    """A numpy parameter tree in the JAX layout: kernels and embeddings
    std 0.1 (five times the init's, so greedy continuations vary, and
    activations and logits of order 1), biases 0.05, LayerNorm scales
    1 ± 0.1."""
    rng = np.random.RandomState(seed)

    def build(node, path):
        if isinstance(node, dict):
            return {k: build(v, path + (k,)) for k, v in node.items()}
        if path[-1] == "scale":
            return (1 + 0.1 * rng.randn(*node)).astype(np.float32)
        std = 0.05 if "bias" in path[-1] else 0.1
        return (std * rng.randn(*node)).astype(np.float32)

    return build(M.param_shapes(cfg), ())


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def model(request):
    """(jax model, jax params, port cfg, port params)."""
    d = CONFIGS[request.param]
    tcfg = M.config_from_dict(d)
    tree = _weights(tcfg)
    jmodel = GPTForPretraining(j_config(d))
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    return jmodel, jparams, tcfg, params_from_jax(tree, tcfg)


@pytest.fixture(scope="module")
def tiny():
    d = CONFIGS["tiny64"]
    tcfg = M.config_from_dict(d)
    tree = _weights(tcfg, seed=1)
    return (GPTForPretraining(j_config(d)),
            jax.tree_util.tree_map(jnp.asarray, tree), tcfg,
            params_from_jax(tree, tcfg))


def _padded(prompts=PROMPTS):
    tokens, mask = G.left_pad(prompts, PAD)
    return tokens, mask, G.to_tensors(tokens, mask, "cpu")


def test_cached_logits_match_jax(model):
    """Prefill over left-padded prompts, then two one-token steps."""
    jmodel, jparams, tcfg, tparams = model
    tokens, mask, (tt, tm) = _padded()
    b, plen = tokens.shape
    jcache = j_init_cache(jmodel.cfg, b, plen + 2)
    tcache = M.init_cache(tcfg, b, plen + 2)
    launches = FN.fwd_call.launches
    apply = jax.jit(jmodel.apply, static_argnames=("deterministic",))
    j_logits, jcache = apply({"params": jparams}, jnp.asarray(tokens),
                             None, cache=jcache, deterministic=True,
                             attention_mask=jnp.asarray(mask))
    with torch.no_grad():
        t_logits, tcache = M.gpt_for_pretraining(
            tparams, tcfg, tt, cache=tcache, attention_mask=tm)
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                               rtol=0, atol=1e-5)
    assert tcache.index == plen and torch.equal(tcache.mask[:, :plen],
                                                tm.bool())
    pos = mask.sum(axis=1)
    rng = np.random.RandomState(3)
    for step in range(2):
        tok = rng.randint(1, 97, size=(b, 1)).astype(np.int32)
        p = (pos + step)[:, None].astype(np.int32)
        j_logits, jcache = apply(
            {"params": jparams}, jnp.asarray(tok), jnp.asarray(p),
            cache=jcache, deterministic=True)
        with torch.no_grad():
            t_logits, tcache = M.gpt_for_pretraining(
                tparams, tcfg, torch.from_numpy(tok).long(),
                torch.from_numpy(p).long(), cache=tcache)
        np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                                   rtol=0, atol=1e-5)
    np.testing.assert_array_equal(tcache.mask.numpy(), np.asarray(jcache.mask))
    np.testing.assert_allclose(tcache.key.numpy(), np.asarray(jcache.key),
                               rtol=0, atol=1e-5)
    # CPU tensors never launch a kernel, fused or not
    assert FN.fwd_call.launches == launches


def test_decode_cache_takes_the_fused_norm_gate_at_every_length():
    """With a cache, every LayerNorm goes through ``FN`` wherever its gate
    admits ``[b, s, hidden]``: 2 × layers + 1 calls a model call, the
    one-token steps included."""
    tcfg = M.config_from_dict(CONFIGS["fused128"])
    params = params_from_jax(_weights(tcfg), tcfg)
    for s in (7, 1):
        x = torch.zeros((3, s, tcfg.hidden_size))
        assert FN.fused_norm_supported(x) and FN.fused_norm_supported(x, x)
    calls = []
    real = FN.fused_residual_norm

    def counting(*a, **k):
        calls.append(a[0].shape)
        return real(*a, **k)

    FN.fused_residual_norm = counting
    try:
        cache = M.init_cache(tcfg, 3, 9)
        with torch.no_grad():
            M.gpt_for_pretraining(params, tcfg, torch.ones((3, 7),
                                                           dtype=torch.long),
                                  cache=cache)
            M.gpt_for_pretraining(params, tcfg, torch.ones((3, 1),
                                                           dtype=torch.long),
                                  cache=cache)
    finally:
        FN.fused_residual_norm = real
    per_call = 2 * tcfg.num_layers + 1
    assert len(calls) == 2 * per_call
    assert [c[1] for c in calls] == [7] * per_call + [1] * per_call


GREEDY = {
    "plain": {},
    "min_len_penalty": dict(min_new_tokens=4, repetition_penalty=1.5),
    "return3": dict(num_return_sequences=3),
    "forced": dict(forced_bos_token_id=11, forced_eos_token_id=12),
}


@pytest.mark.parametrize("case", sorted(GREEDY))
def test_greedy_generate_is_token_identical(tiny, case):
    jmodel, jparams, tcfg, tparams = tiny
    tokens, mask, (tt, tm) = _padded()
    kw = dict(max_new_tokens=9, do_sample=False, eos_token_id=96,
              pad_token_id=PAD, **GREEDY[case])
    want = np.asarray(JGENERATE(jmodel, jparams, JG.GenerationConfig(**kw),
                                  jnp.asarray(tokens), jnp.asarray(mask),
                                  jax.random.PRNGKey(1)))
    got = G.generate(tcfg, tparams, G.GenerationConfig(**kw), tt, tm)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    n = GREEDY[case].get("num_return_sequences", 1)
    assert got.shape == (len(PROMPTS) * n, 9)
    if n > 1:  # prompt-major rows, identical under greedy
        rows = got.numpy().reshape(len(PROMPTS), n, 9)
        assert (rows == rows[:, :1]).all()
    if "forced_bos_token_id" in GREEDY[case]:
        assert (got[:, 0] == 11).all() and (got[:, -1] == 12).all()


def test_greedy_generate_through_the_fused_norm_path(model):
    jmodel, jparams, tcfg, tparams = model
    tokens, mask, (tt, tm) = _padded()
    kw = dict(max_new_tokens=9, do_sample=False, eos_token_id=96,
              pad_token_id=PAD)
    want = np.asarray(JGENERATE(jmodel, jparams, JG.GenerationConfig(**kw),
                                  jnp.asarray(tokens), jnp.asarray(mask),
                                  jax.random.PRNGKey(1)))
    got = G.generate(tcfg, tparams, G.GenerationConfig(**kw), tt, tm)
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(np.unique(want)) > 4  # the continuations vary


def test_eos_stops_a_row_and_pads_it(tiny):
    """The eos id is the third token row 0 emits: row 0 stops there and
    is padded, the others run on."""
    jmodel, jparams, tcfg, tparams = tiny
    tokens, mask, (tt, tm) = _padded()
    base = G.GenerationConfig(max_new_tokens=9, do_sample=False,
                              eos_token_id=96, pad_token_id=PAD)
    first = G.generate(tcfg, tparams, base, tt, tm).numpy()
    eos = int(first[0, 2])
    kw = dict(max_new_tokens=9, do_sample=False, eos_token_id=eos,
              pad_token_id=PAD)
    want = np.asarray(JGENERATE(jmodel, jparams, JG.GenerationConfig(**kw),
                                  jnp.asarray(tokens), jnp.asarray(mask),
                                  jax.random.PRNGKey(1)))
    got = G.generate(tcfg, tparams, G.GenerationConfig(**kw), tt, tm).numpy()
    np.testing.assert_array_equal(got, want)
    stop = list(got[0]).index(eos)
    assert stop <= 2 and (got[0, stop + 1:] == PAD).all()


BEAMS = {
    "beams4": dict(num_beams=4),
    "groups2_diverse_length": dict(num_beams=4, num_beam_groups=2,
                                   diversity_rate=0.7, length_penalty=1.0),
    "groups3_penalties": dict(num_beams=3, num_beam_groups=3,
                              diversity_rate=2.0, repetition_penalty=1.3,
                              min_new_tokens=2),
}


@pytest.mark.parametrize("case", sorted(BEAMS))
def test_beam_search_matches_jax(tiny, case):
    jmodel, jparams, tcfg, tparams = tiny
    tokens, mask, (tt, tm) = _padded()
    kw = dict(max_new_tokens=7, do_sample=False, eos_token_id=96,
              pad_token_id=PAD, **BEAMS[case])
    j_seqs, j_scores = JBEAM(jmodel, jparams,
                                      JG.GenerationConfig(**kw),
                                      jnp.asarray(tokens), jnp.asarray(mask))
    seqs, scores = G.beam_search(tcfg, tparams, G.GenerationConfig(**kw),
                                 tt, tm)
    np.testing.assert_array_equal(seqs.numpy(), np.asarray(j_seqs))
    np.testing.assert_allclose(scores.numpy(), np.asarray(j_scores), rtol=0,
                               atol=1e-5)
    # best-first per prompt
    assert (np.diff(scores.numpy(), axis=1) <= 0).all()


def test_beam_search_with_eos_freezes_finished_beams(tiny):
    jmodel, jparams, tcfg, tparams = tiny
    tokens, mask, (tt, tm) = _padded()
    probe = G.GenerationConfig(max_new_tokens=6, do_sample=False,
                               eos_token_id=96, pad_token_id=PAD,
                               num_beams=4)
    seqs, _ = G.beam_search(tcfg, tparams, probe, tt, tm)
    eos = int(seqs[0, 1])
    kw = dict(max_new_tokens=6, do_sample=False, eos_token_id=eos,
              pad_token_id=PAD, num_beams=4, length_penalty=0.5)
    j_seqs, j_scores = JBEAM(jmodel, jparams,
                                      JG.GenerationConfig(**kw),
                                      jnp.asarray(tokens), jnp.asarray(mask))
    seqs, scores = G.beam_search(tcfg, tparams, G.GenerationConfig(**kw),
                                 tt, tm)
    np.testing.assert_array_equal(seqs.numpy(), np.asarray(j_seqs))
    np.testing.assert_allclose(scores.numpy(), np.asarray(j_scores), rtol=0,
                               atol=1e-5)
    assert (seqs.numpy() == eos).any()


def test_one_beam_is_greedy(tiny):
    _, _, tcfg, tparams = tiny
    _, _, (tt, tm) = _padded()
    kw = dict(max_new_tokens=8, do_sample=False, eos_token_id=96,
              pad_token_id=PAD)
    seqs, _ = G.beam_search(tcfg, tparams,
                            G.GenerationConfig(num_beams=1, **kw), tt, tm)
    greedy = G.generate(tcfg, tparams, G.GenerationConfig(**kw), tt, tm)
    assert torch.equal(seqs, greedy)


# ------------------------------------------------------------ processors
def _proc_inputs(seed=0, b=4, v=31, plen=6, max_new=5):
    rng = np.random.RandomState(seed)
    logits = (3 * rng.randn(b, v)).astype(np.float32)
    seqs = rng.randint(0, v, (b, plen + max_new)).astype(np.int32)
    mask = rng.rand(b, plen + max_new) > 0.3
    return logits, seqs, mask


PROCESSORS = {
    "min_length": lambda m: m.min_length_processor(3, 7),
    "repetition": lambda m: m.repetition_penalty_processor(1.7),
    "forced_bos": lambda m: m.forced_bos_processor(5),
    "forced_eos": lambda m: m.forced_eos_processor(4, 9),
}


@pytest.mark.parametrize("name", sorted(PROCESSORS))
@pytest.mark.parametrize("step", [0, 2, 3])
@pytest.mark.parametrize("with_mask", [True, False])
def test_processor_matches_jax(name, step, with_mask):
    logits, seqs, mask = _proc_inputs(seed=step)
    jfn, tfn = PROCESSORS[name](JG), PROCESSORS[name](G)
    jm = jnp.asarray(mask) if with_mask else None
    tm = torch.from_numpy(mask) if with_mask else None
    want = np.asarray(jfn(jnp.asarray(logits), jnp.int32(step),
                          jnp.asarray(seqs), jm))
    got = tfn(torch.from_numpy(logits), step, torch.from_numpy(seqs),
              tm).numpy()
    np.testing.assert_array_equal(got == float(G.NEG_INF),
                                  want == float(JG.NEG_INF))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("group", [0, 1, 2])
def test_hamming_diversity_matches_jax(group):
    rng = np.random.RandomState(group)
    nb, ng, batch, v = 6, 3, 2, 13
    logits = rng.randn(batch * nb // ng, v).astype(np.float32)
    current = rng.randint(0, v, batch * nb).astype(np.int32)
    want = JG.hamming_diversity_processor(0.8, nb, ng)(
        jnp.asarray(logits), jnp.asarray(current), group)
    got = G.hamming_diversity_processor(0.8, nb, ng)(
        torch.from_numpy(logits), torch.from_numpy(current), group)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("k,p,temp", [(0, 0.0, 1.0), (5, 0.0, 0.7),
                                      (0, 0.75, 1.0), (50, 0.75, 1.3),
                                      (3, 0.2, 0.5)])
def test_sampling_filters_match_jax_support(k, p, temp):
    """temperature → top-k → top-p: the same values and the same kept
    set (the support a draw comes from)."""
    logits, _, _ = _proc_inputs(seed=k, b=6, v=64)
    want = JG.apply_top_p(JG.apply_top_k(JG.apply_temperature(
        jnp.asarray(logits), temp), k), p)
    got = G.apply_top_p(G.apply_top_k(G.apply_temperature(
        torch.from_numpy(logits), temp), k), p)
    np.testing.assert_array_equal(got.numpy() > G.NEG_INF,
                                  np.asarray(want) > JG.NEG_INF)
    keep = got.numpy() > G.NEG_INF
    np.testing.assert_allclose(got.numpy()[keep], np.asarray(want)[keep],
                               rtol=1e-6, atol=1e-6)


def test_sampling_is_reproducible_and_stays_in_the_support(tiny):
    """The same seed gives the same draws; every draw lies in the support
    the JAX filters keep for its logits; other seeds give other draws."""
    _, _, tcfg, tparams = tiny
    _, _, (tt, tm) = _padded()
    gc = G.GenerationConfig(max_new_tokens=12, do_sample=True, top_k=5,
                            top_p=0.9, temperature=1.2, eos_token_id=96,
                            pad_token_id=PAD, num_return_sequences=2)

    def draw(seed):
        gen = torch.Generator().manual_seed(seed)
        return G.generate(tcfg, tparams, gc, tt, tm, gen)

    a, b, c = draw(3), draw(3), draw(4)
    assert torch.equal(a, b) and not torch.equal(a, c)
    # replay each row (prompt + draws) through the model without a cache:
    # the logits before each draw (a causal model's position t sees only
    # tokens up to t), and every draw inside the support the JAX filters
    # keep there
    rows = torch.arange(len(PROMPTS)).repeat_interleave(2)
    for r in range(a.shape[0]):
        prompt = PROMPTS[int(rows[r])]
        ids = torch.tensor([prompt + a[r, :-1].tolist()])
        with torch.no_grad():
            logits = M.gpt_for_pretraining(tparams, tcfg, ids)[0]
        kept = np.asarray(JG.apply_top_p(JG.apply_top_k(
            JG.apply_temperature(jnp.asarray(
                logits[len(prompt) - 1:].numpy()), 1.2), 5), 0.9))
        drawn = kept[np.arange(a.shape[1]), a[r].numpy()]
        assert (drawn > JG.NEG_INF).all(), r


def test_categorical_never_draws_a_masked_token():
    logits = torch.full((64, 10), G.NEG_INF)
    logits[:, 3] = 0.0
    logits[::2, 7] = 0.0
    gen = torch.Generator().manual_seed(0)
    draws = G.categorical(logits, gen)
    assert set(draws[1::2].tolist()) == {3}
    assert set(draws[::2].tolist()) == {3, 7}


def test_left_pad_matches_jax():
    for width in (None, 3, 10):
        want = JG.left_pad(PROMPTS, 9, width)
        got = G.left_pad(PROMPTS, 9, width)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, np.asarray(b))
