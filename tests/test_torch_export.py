"""Port parity: export and inference (``fleetx_tpu_torch/utils/export.py``,
``core/engine/inference_engine.py``, the exported-program seam of
``models/gpt/generation.py``, the kernels' custom ops in
``ops/flash_attention.py`` and ``ops/fused_norm.py``; the entry points
``tools.export``, ``tools.inference`` and ``tasks.gpt.inference`` as
processes are ``tests/test_torch_export_cli.py``).

Artifacts are exported on the CPU from the inference recipe shrunk to a
tiny model (hidden 128, 2 layers, 2 heads of 64, vocab 512, seq 128, f32;
the flash and norm kernels configured, so the programs record their
custom ops and run their plain versions here). Weights: the JAX model's
init converted by ``convert.params_from_jax``, written to a checkpoint
the tools read.

Tolerances: the exported forward equals the eager forward bit for bit
(the same ops on the same inputs) and is within 1e-5 of the JAX
``model.apply`` (atol; f32); greedy and beam tokens through the exported
programs identical to the eager decoders and greedy identical to the JAX
``generate``; sampling under one seed identical to eager sampling.
"""

import os

import numpy as np
import pytest
import torch

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
INF_YAML = os.path.join(REPO, "fleetx_tpu", "configs", "nlp", "gpt",
                        "inference_gpt_345M_single_card.yaml")
VOCAB, SEQ, PROMPT, NEW, EOS = 512, 128, 16, 6, 511
MODEL = dict(vocab_size=VOCAB, hidden_size=128, num_layers=2,
             num_attention_heads=2, max_position_embeddings=SEQ,
             hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
             use_flash_attention=True, fused_residual_norm=True,
             dtype="float32", param_dtype="float32")
TINY = ["Model.num_layers=2", "Model.hidden_size=128",
        "Model.num_attention_heads=2", f"Model.vocab_size={VOCAB}",
        f"Model.max_position_embeddings={SEQ}", f"Global.max_seq_len={SEQ}",
        "Model.dtype=float32", "Model.hidden_dropout_prob=0.0",
        "Model.attention_probs_dropout_prob=0.0",
        "Global.global_batch_size=2", "Global.local_batch_size=2",
        "Global.micro_batch_size=2", f"Generation.max_dec_len={NEW}",
        f"Generation.eos_token_id={EOS}", f"Generation.pad_token_id={EOS}",
        f"Inference.prompt_len={PROMPT}", "Generation.min_dec_len=0"]
STRATEGIES = {
    "greedy": ["Generation.decode_strategy=greedy_search"],
    "sampling": [],
    "beam": ["Generation.decode_strategy=beam_search",
             "Generation.num_beams=4", "Generation.num_return_sequences=2"],
}


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """(checkpoint dir, jax params, port params) of the tiny model."""
    import jax
    from flax.core import meta

    from fleetx_tpu.core.module import GPTModule as JGPTModule
    from fleetx_tpu_torch.convert import params_from_jax
    from fleetx_tpu_torch.core.engine import EagerEngine
    from fleetx_tpu_torch.core.module import GPTModule

    plain = dict(MODEL, use_flash_attention=False, fused_residual_norm=False)
    batch = {"tokens": np.zeros((1, SEQ), np.int32),
             "position_ids": np.arange(SEQ, dtype=np.int32)[None]}
    jparams = meta.unbox(JGPTModule({"Model": plain}).init_variables(
        jax.random.PRNGKey(5), batch))
    out = str(tmp_path_factory.mktemp("ckpt"))
    cfg = {"Model": dict(MODEL), "Engine": {"save_load": {
        "output_dir": out}}}
    eng = EagerEngine(cfg, GPTModule(cfg), device="cpu")
    eng.params = params_from_jax(jax.device_get(jparams),
                                 eng.module.model_cfg)
    eng.prepare()
    eng.save()
    return out, jparams, params_from_jax(jax.device_get(jparams),
                                         eng.module.model_cfg)


def _cfg(ckpt_dir: str, model_dir: str, extra=()):
    from fleetx_tpu_torch.utils.config import get_config

    return get_config(INF_YAML, TINY + list(extra) + [
        f"Engine.save_load.ckpt_dir={ckpt_dir}",
        f"Inference.model_dir={model_dir}"])


@pytest.fixture(scope="module")
def artifacts(ckpt, tmp_path_factory):
    """target name → (model dir, config), exported in this process."""
    from fleetx_tpu_torch.tools import export as X

    out = {}
    for name, extra in [("forward", ["Inference.target=forward"])] + [
            (k, v) for k, v in STRATEGIES.items()]:
        d = str(tmp_path_factory.mktemp(name))
        cfg = _cfg(ckpt[0], d, extra)
        rec = X.export(cfg, device="cpu")
        assert rec["model_dir"] == d and rec["artifact_bytes"] > 0
        out[name] = (d, cfg)
    return out


def _graph_ops(model_dir: str) -> set:
    from fleetx_tpu_torch.utils.export import load_exported

    programs, _ = load_exported(model_dir, "cpu")
    return {str(n.target) for p in programs.values()
            for n in p.graph.nodes if n.op == "call_function"}


def test_forward_round_trip_matches_eager_and_jax(ckpt, artifacts):
    import jax.numpy as jnp

    from fleetx_tpu.models.gpt.model import GPTForPretraining
    from fleetx_tpu.models.gpt.model import config_from_dict as j_config
    from fleetx_tpu_torch.core.engine.inference_engine import \
        InferenceEngine
    from fleetx_tpu_torch.core.module import GPTModule

    _, jparams, tparams = ckpt
    eng = InferenceEngine(artifacts["forward"][0], device="cpu")
    assert eng.target == "forward" and eng.meta["device"] == "cpu"
    assert eng.meta["inputs"]["model"][0] == {"shape": [1, SEQ],
                                             "dtype": "int64"}
    rng = np.random.RandomState(1)
    tokens = rng.randint(0, VOCAB, (1, SEQ))
    pos = np.arange(SEQ)[None]
    got = eng.predict([tokens, pos])[0]
    module = GPTModule({"Model": dict(MODEL)})
    want = module.predict_step(tparams, {
        "tokens": torch.from_numpy(tokens), "position_ids":
            torch.from_numpy(pos)}).numpy()
    assert got.shape == (1, SEQ, VOCAB) and np.array_equal(got, want)
    plain = dict(MODEL, use_flash_attention=False, fused_residual_norm=False)
    ref = GPTForPretraining(j_config(plain)).apply(
        {"params": jparams}, jnp.asarray(tokens), jnp.asarray(pos),
        deterministic=True)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=1e-5)


def test_programs_hold_the_kernels_custom_ops(artifacts, ckpt, tmp_path):
    """With the kernels configured the forward records the flash and norm
    ops and the generation programs the norm op; with them off, none."""
    from fleetx_tpu_torch.tools import export as X

    fwd = _graph_ops(artifacts["forward"][0])
    assert "fleetx_tpu_torch.flash_fwd.default" in fwd
    assert "fleetx_tpu_torch.fused_norm_fwd.default" in fwd
    gen = _graph_ops(artifacts["greedy"][0])
    assert "fleetx_tpu_torch.fused_norm_fwd.default" in gen
    assert "fleetx_tpu_torch.flash_fwd.default" not in gen
    off = str(tmp_path / "off")
    X.export(_cfg(ckpt[0], off, ["Inference.target=forward",
                                 "Model.use_flash_attention=False",
                                 "Model.fused_residual_norm=False"]),
             device="cpu")
    assert not any(op.startswith("fleetx_tpu_torch.")
                   for op in _graph_ops(off))


def _prompts():
    from fleetx_tpu_torch.models.gpt import generation as G

    rng = np.random.RandomState(2)
    return G.left_pad([list(rng.randint(0, 500, 11))], EOS, width=PROMPT)


@pytest.mark.parametrize("name", sorted(STRATEGIES))
def test_generation_programs_match_the_eager_decoders(artifacts, ckpt,
                                                      name):
    """The decode loop over the two exported programs against the eager
    ``generate_rows`` on the same weights, prompts and seed."""
    from fleetx_tpu_torch.core.engine.inference_engine import \
        InferenceEngine
    from fleetx_tpu_torch.core.module import GPTGenerationModule
    from fleetx_tpu_torch.models.gpt import generation as G

    model_dir, cfg = artifacts[name]
    eng = InferenceEngine(model_dir, device="cpu")
    assert set(eng.programs) == {"prefill", "decode"}
    tokens, mask = _prompts()
    got = eng.predict([tokens, mask, np.array([0, 1234], np.uint32)])[0]
    module = GPTGenerationModule(cfg)
    gen = torch.Generator()
    gen.manual_seed(1234)
    want = G.generate_rows(module.model_cfg, ckpt[2], module.gen_cfg,
                           *G.to_tensors(tokens, mask, "cpu"),
                           module.use_beam_search, gen).numpy()
    rows = 2 if name == "beam" else 1
    assert got.shape == (rows, NEW) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    if name == "greedy":
        assert len(set(got[0].tolist())) > 1  # the weights vary the output


def test_greedy_through_the_programs_matches_jax_generate(artifacts, ckpt):
    import jax
    import jax.numpy as jnp

    from fleetx_tpu.models.gpt import generation as JG
    from fleetx_tpu.models.gpt.model import GPTForPretraining
    from fleetx_tpu.models.gpt.model import config_from_dict as j_config
    from fleetx_tpu_torch.core.engine.inference_engine import \
        InferenceEngine

    eng = InferenceEngine(artifacts["greedy"][0], device="cpu")
    tokens, mask = _prompts()
    got = eng.predict([tokens, mask, np.zeros(2, np.uint32)])[0]
    plain = dict(MODEL, use_flash_attention=False, fused_residual_norm=False)
    gen_cfg = JG.GenerationConfig(max_new_tokens=NEW, do_sample=False,
                                  eos_token_id=EOS, pad_token_id=EOS)
    want = jax.jit(JG.generate, static_argnums=(0, 2))(
        GPTForPretraining(j_config(plain)), ckpt[1], gen_cfg,
        jnp.asarray(tokens), jnp.asarray(mask), jax.random.PRNGKey(0))
    np.testing.assert_array_equal(got, np.asarray(want))


def test_eval_engine_inference_delegates_to_the_export(artifacts):
    """``EagerEngine(mode="inference").inference`` loads
    ``Inference.model_dir`` on its device and returns the exported
    program's outputs."""
    from fleetx_tpu_torch.core.engine import EagerEngine
    from fleetx_tpu_torch.core.engine.inference_engine import \
        InferenceEngine
    from fleetx_tpu_torch.models import build_module

    model_dir, cfg = artifacts["forward"]
    eng = EagerEngine(cfg, build_module(cfg), device="cpu",
                      mode="inference")
    inputs = [np.arange(SEQ)[None] % VOCAB, np.arange(SEQ)[None]]
    got = eng.inference(inputs)
    assert eng._inference_engine.device.type == "cpu"
    want = InferenceEngine(model_dir, device="cpu").predict(inputs)
    assert len(got) == len(want) == 1 and np.array_equal(got[0], want[0])


def test_inference_engine_counters_and_refusals(artifacts, tmp_path):
    from fleetx_tpu_torch.core.engine.inference_engine import (
        InferenceEngine, seed_from_key, serving_mesh)
    from fleetx_tpu_torch.observability.metrics import get_registry
    from fleetx_tpu_torch.utils.export import load_exported

    reg = get_registry()
    before = {k: reg.counter(k).value for k in
              ("requests_total", "requests_failed_total")}
    eng = InferenceEngine(artifacts["forward"][0], device="cpu")
    pos = np.arange(SEQ)[None]
    eng.predict([np.zeros((1, SEQ), np.int32), pos])
    eng.predict([np.ones((1, SEQ), np.int32), pos])
    with pytest.raises(Exception):  # not the exported input shape
        eng.predict([np.zeros((1, SEQ // 2), np.int32), pos[:, :SEQ // 2]])
    assert reg.counter("requests_total").value == \
        before["requests_total"] + 3
    assert reg.counter("requests_failed_total").value == \
        before["requests_failed_total"] + 1
    assert eng.latency_summary()["count"] >= 1
    assert seed_from_key(np.array([0, 1234], np.uint32)) == 1234
    assert seed_from_key(np.array([1, 2], np.uint32)) == (1 << 32) | 2
    assert serving_mesh({"dp_degree": 1, "mp_degree": 1}) is None
    # in a world of one rank a degree above 1 is JAX's world mismatch
    for dist in ({"dp_degree": 2}, {"mp_degree": 2},
                 {"sharding": {"sharding_degree": 2}}):
        with pytest.raises(ValueError, match=r"mesh shape .* != 1 devices"):
            serving_mesh(dist)
    # mp above 1 needs the tensor-parallel forward; a non-mesh is refused
    from fleetx_tpu_torch.parallel.mesh import build_mesh

    with pytest.raises(NotImplementedError, match="item 12"):
        InferenceEngine(artifacts["forward"][0], mesh=build_mesh(
            {"mp_degree": 2}, world_size=2), device="cpu")
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        InferenceEngine(artifacts["forward"][0], mesh=object(),
                        device="cpu")
    with pytest.raises(ValueError, match="exported for cpu"):
        load_exported(artifacts["forward"][0], "meta")
