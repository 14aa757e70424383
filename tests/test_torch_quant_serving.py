"""Port parity: quantized serving (``fleetx_tpu_torch/serving/decode.py``
with ``quantize``, the engine's ``Serving.quantize_decode``) and the
replica ``tools/serve.build_engine`` merging a LoRA adapter artifact.

The JAX params come from ``model.init(PRNGKey(0))`` at the tiny config of
``tests/test_zz_serving.py`` and pass through ``convert.params_from_jax``,
so both sides run the same weights. The JAX side runs as its serving
tests run it on the CPU (jitted steps, the Pallas decode kernel in
interpret mode); the port runs on CPU tensors (the kernel's plain
version).

Tolerances: the kernels ``prepare_params`` quantizes once are bit for bit
the per-layer quantization the JAX steps run (eager, f32); ``_forward``
hidden states, written pools and the first-chunk logits within f32 atol
1e-5 of JAX's (measured: 1e-6 and below; the same math summed in
another order by another library, and the jitted JAX steps may divide
by a scale through its reciprocal, so a value an ulp from a rounding
boundary of the int8 grid could move one step, which these inputs do
not hit); greedy serving tokens must be IDENTICAL.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

from fleetx_tpu.finetune import lora as JL
from fleetx_tpu.models.gpt.model import GPTForPretraining
from fleetx_tpu.models.gpt.model import config_from_dict as j_config
from fleetx_tpu.ops import quantization as JQ
from fleetx_tpu.serving import decode as JD
from fleetx_tpu.serving.engine import ServingConfig as JServingConfig
from fleetx_tpu.serving.engine import ServingEngine as JServingEngine
from fleetx_tpu_torch.convert import params_from_jax
from fleetx_tpu_torch.core import checkpoint as C
from fleetx_tpu_torch.finetune import checkpoint as TC
from fleetx_tpu_torch.finetune import lora as TL
from fleetx_tpu_torch.models.gpt.model import config_from_dict as t_config
from fleetx_tpu_torch.serving import decode as TD
from fleetx_tpu_torch.serving.engine import ServingConfig as TServingConfig
from fleetx_tpu_torch.serving.engine import ServingEngine as TServingEngine
from fleetx_tpu_torch.serving.paged_cache import NULL_PAGE

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
LORA_YAML = os.path.join(REPO, "fleetx_tpu", "configs", "nlp", "gpt",
                         "finetune_gpt_345M_lora.yaml")
MODEL_DICT = dict(vocab_size=97, hidden_size=64, num_layers=2,
                  num_attention_heads=4, max_position_embeddings=64,
                  hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
                  use_flash_attention=False, dtype="float32",
                  param_dtype="float32")
EOS = 96
RANK, ALPHA = 4, 8.0
#: four requests of ragged prompt lengths (one longer than a prefill
#: chunk) and budgets: the decode batch carries inactive slots and
#: finished rows beside the live ones
PROMPTS = [[5, 9, 23, 41], [7, 3], [11, 2, 8, 4, 19, 33, 7, 6, 1], [60]]
MAX_NEW = [8, 3, 6, 7]
GEO = dict(max_batch=6, page_size=4, max_seq_len=32, prefill_chunk=8,
           num_pages=33)


@pytest.fixture(scope="module")
def weights():
    """(jax cfg, jax params, port cfg, port params) on the same weights."""
    model = GPTForPretraining(j_config(MODEL_DICT))
    jparams = jax.jit(lambda k: meta.unbox(model.init(
        {"params": k}, jnp.zeros((1, 8), jnp.int32), None,
        deterministic=True)["params"]))(jax.random.PRNGKey(0))
    tcfg = t_config(MODEL_DICT)
    return (j_config(MODEL_DICT), jparams, tcfg,
            params_from_jax(jax.device_get(jparams), tcfg, "cpu"))


def test_prepared_kernels_are_the_per_call_quantization(weights):
    """``prepare_params(quantize=True)`` quantizes each stacked kernel
    once; every layer equals the JAX steps' per-call ``fake_quant`` of that
    layer's kernel cast to the compute dtype, bit for bit."""
    jcfg, jparams, tcfg, tparams = weights
    prepared = TD.prepare_params(tparams, tcfg, "cpu", quantize=True)
    plain = TD.prepare_params(tparams, tcfg, "cpu")
    axes = {"qkv_kernel": 0, "out_kernel": (0, 1), "wi_kernel": 0,
            "wo_kernel": 0}
    for (group, name), _ in TD.QUANT_KERNELS.items():
        got = prepared["gpt"]["layers"][group][name]
        assert not torch.equal(got, plain["gpt"]["layers"][group][name])
        for i in range(tcfg.num_layers):
            layer = jparams["gpt"]["layers"][group][name][i]
            want = JQ.fake_quant(layer.astype(jcfg.dtype), jcfg.qat_bits,
                                 axis=axes[name])
            np.testing.assert_array_equal(got[i].numpy(), np.asarray(want))
    # the other leaves are untouched by the quantization
    for name, leaf in C.flatten(prepared).items():
        if not name.endswith(tuple(n for _, n in TD.QUANT_KERNELS)):
            assert torch.equal(leaf, C.flatten(plain)[name]), name


@pytest.mark.parametrize("mode", ["prefill", "decode_kernel",
                                  "decode_gather"])
def test_quantized_forward_matches_jax(weights, mode):
    """The quantized stack against the JAX one, with the rows beside the
    live ones (padded prefill positions, inactive decode slots) in the
    per-tensor scales on both sides."""
    jcfg, jparams, tcfg, tparams = weights
    rng = np.random.RandomState(0)
    pages, ps = 12, 4
    shape = (tcfg.num_layers, pages, ps, tcfg.num_attention_heads,
             tcfg.head_dim)
    pk = rng.randn(*shape).astype(np.float32)
    pv = rng.randn(*shape).astype(np.float32)
    if mode == "prefill":
        tokens = rng.randint(0, 97, size=(1, 8)).astype(np.int32)
        positions = np.array([[4, 5, 6, 7, 8, -1, -1, -1]], np.int32)
        tables = np.array([[3, 7, 5, NULL_PAGE]], np.int32)
    else:
        tokens = rng.randint(0, 97, size=(4, 1)).astype(np.int32)
        positions = np.array([[9], [-1], [0], [15]], np.int32)
        tables = np.array([[1, 2, 4, NULL_PAGE], [NULL_PAGE] * 4,
                           [6, NULL_PAGE, NULL_PAGE, NULL_PAGE],
                           [8, 9, 10, 11]], np.int32)
    kernel = mode == "decode_kernel"
    jx, jk, _ = jax.jit(
        lambda *a: JD._forward(jparams, jcfg, *a, True,
                               paged_kernel=kernel))(
        jnp.asarray(tokens), jnp.asarray(positions), jnp.asarray(pk),
        jnp.asarray(pv), jnp.asarray(tables))
    prepared = TD.prepare_params(tparams, tcfg, "cpu", quantize=True)
    tk, tv = torch.from_numpy(pk.copy()), torch.from_numpy(pv.copy())
    tx, tk, _ = TD._forward(prepared, tcfg, torch.from_numpy(tokens),
                            torch.from_numpy(positions), tk, tv,
                            torch.from_numpy(tables), paged_kernel=kernel,
                            quantize=True)
    valid = (positions >= 0).reshape(-1)
    h = tcfg.hidden_size
    np.testing.assert_allclose(tx.numpy().reshape(-1, h)[valid],
                               np.asarray(jx).reshape(-1, h)[valid],
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-5,
                               rtol=0)
    # and the quantization is really on: the unquantized stack differs
    ux, _, _ = TD._forward(TD.prepare_params(tparams, tcfg, "cpu"), tcfg,
                           torch.from_numpy(tokens),
                           torch.from_numpy(positions),
                           torch.from_numpy(pk.copy()),
                           torch.from_numpy(pv.copy()),
                           torch.from_numpy(tables), paged_kernel=kernel)
    assert float((ux - tx).abs().max()) > 1e-3


def _serve(engine) -> list:
    reqs = [engine.submit(p, n, request_id=f"q{i}")
            for i, (p, n) in enumerate(zip(PROMPTS, MAX_NEW))]
    engine.run_until_drained()
    assert all(r.state == "finished" and r.error is None for r in reqs)
    return [r.tokens for r in reqs]


def _first_chunk_logits(engine, rng) -> np.ndarray:
    """The prefill step's f32 logits on the first prompt (the JAX test's
    drift probe): one chunk into pages 1-2 of a fresh table."""
    table = np.zeros((1, engine.pages_per_req), np.int32)
    table[0, :2] = [1, 2]
    tokens = np.zeros((1, GEO["prefill_chunk"]), np.int32)
    tokens[0, :4] = PROMPTS[0]
    out = engine._fns["prefill"](engine.params, engine.pool_k,
                                 engine.pool_v, tokens, table, np.int32(0),
                                 np.int32(4), rng)
    return np.asarray(out[3])[0]


def test_quantized_engine_tokens_identical_to_jax_engine(weights):
    """A ragged multi-request batch through both quantized engines: the
    greedy tokens identical, the first-chunk logits within 1e-5, and the
    quantized logits within the JAX test's 5 % drift bound of the
    unquantized ones."""
    jcfg, jparams, tcfg, tparams = weights
    jeng = JServingEngine(jcfg, jparams,
                          JServingConfig(**GEO, quantize_decode=True),
                          eos_token_id=EOS)
    teng = TServingEngine(tcfg, tparams,
                          TServingConfig(**GEO, quantize_decode=True),
                          eos_token_id=EOS, device="cpu")
    assert teng.serving.quantize_decode and jeng.paged_kernel_active and \
        teng.paged_kernel_active
    want = _serve(jeng)
    got = _serve(teng)
    assert got == want
    assert [len(t) for t in got] == MAX_NEW or any(
        EOS in t for t in got)
    j_logits = np.asarray(_first_chunk_logits(jeng, jax.random.PRNGKey(0)))
    t_logits = _first_chunk_logits(teng, None)
    np.testing.assert_allclose(t_logits, j_logits, atol=1e-5, rtol=0)
    fp = TServingEngine(tcfg, tparams, TServingConfig(**GEO),
                        eos_token_id=EOS, device="cpu")
    fp_logits = _first_chunk_logits(fp, None)
    drift = np.abs(t_logits - fp_logits).max() / np.abs(fp_logits).max()
    assert 0.0 < drift < 0.05, drift
    snap = teng.serving_snapshot()
    assert snap["decode_path"] == "paged_kernel"


def _adapted(jparams) -> dict:
    """The JAX base with injected adapters, B filled with seeded noise
    (numpy tree)."""
    adapted = jax.device_get(jax.jit(lambda p: JL.inject_adapters(
        p, rank=RANK, rng=jax.random.PRNGKey(3)))(jparams))
    rng = np.random.RandomState(1)
    for group in adapted["gpt"]["layers"].values():
        for key in list(group):
            if key.endswith("_lora_b"):
                group[key] = (0.05 * rng.randn(*group[key].shape)).astype(
                    np.float32)
    return adapted


def test_build_engine_merges_adapter_and_decodes_the_jax_tokens(
        weights, tmp_path):
    """``finetune_gpt_345M_lora.yaml`` shrunk to the tiny model, with a
    base checkpoint and an adapter artifact: the replica merges the
    adapters and decodes int8 (the yaml's ``quantize_decode: true``) the
    tokens of the JAX engine on the JAX-merged weights."""
    from fleetx_tpu_torch.tools import serve

    jcfg, jparams, tcfg, _ = weights
    adapted = _adapted(jparams)
    tree = params_from_jax(adapted, tcfg)
    base, _ = TL.split_adapters(tree)
    ckpt = str(tmp_path / "base")
    C.save_checkpoint(ckpt, 3, dict(step=3, **C.flatten(base, "params/")))
    ad_dir = str(tmp_path / "adapter")
    TC.save_adapter(ad_dir, 5, tree, base_dir=ckpt, rank=RANK, alpha=ALPHA)

    overrides = [f"Model.{k}={v}" for k, v in MODEL_DICT.items()] + [
        f"Serving.{k}={v}" for k, v in GEO.items()] + [
        f"Serving.ckpt_dir={ckpt}", f"Serving.adapter_dir={ad_dir}",
        f"Generation.eos_token_id={EOS}"]
    cfg = serve.load_config(LORA_YAML, overrides)
    assert cfg["Model"]["module"] == "LoRAGPTModule" and cfg["FineTune"]
    engine = serve.build_engine(cfg, device="cpu")
    assert engine.serving.quantize_decode and \
        engine.serving.adapter_dir == ad_dir
    got = _serve(engine)

    merged = JL.merge_adapters(adapted, alpha=ALPHA)
    jeng = JServingEngine(jcfg, merged,
                          JServingConfig(**GEO, quantize_decode=True),
                          eos_token_id=EOS)
    assert got == _serve(jeng)
    # the adapters changed the model: the base alone decodes otherwise
    plain = serve.build_engine(serve.load_config(LORA_YAML, overrides + [
        "Serving.adapter_dir=None"]), device="cpu")
    assert _serve(plain) != got

    # an adapter without its base checkpoint is refused, as in JAX
    bad = serve.load_config(LORA_YAML, overrides + ["Serving.ckpt_dir=None"])
    with pytest.raises(ValueError, match="requires Serving.ckpt_dir"):
        serve.build_engine(bad, device="cpu")
    # ... and so is a base the adapter was not trained against
    drifted = dict(C.flatten(base, "params/"))
    drifted["params/gpt/ln_f/bias"] = drifted["params/gpt/ln_f/bias"] + 1e-3
    other = str(tmp_path / "other")
    C.save_checkpoint(other, 3, dict(step=3, **drifted))
    with pytest.raises(TC.AdapterDriftError, match="gpt/ln_f/bias"):
        serve.build_engine(serve.load_config(LORA_YAML, overrides + [
            f"Serving.ckpt_dir={other}"]), device="cpu")
