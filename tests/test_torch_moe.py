"""Port parity: the mixture-of-experts GPT (``fleetx_tpu_torch/models/gpt/
moe.py``, its wiring in ``models/gpt/model.py`` and ``GPTModule``).

The same numpy inputs and converted weights go through the JAX package
(``MoEMlp``, ``GPTModule`` with ``moe_num_experts``, the JAX engine and
decoder; the Pallas kernels off there, since interpret mode costs seconds
a call on the CPU) and the port on CPU tensors (its kernel wrappers on
their plain versions).

Tolerances:

- ``moe_mlp`` (dispatch by index) and ``moe_mlp_plain`` (JAX's one-hot
  einsums) against ``MoEMlp`` in f32, at capacity factor 0.5 so that
  token-choices are dropped, with a token whose router row is tied across
  every expert: the output and every grad atol 1e-5, the aux atol 1e-6
  (f32 sums of the same few terms in another order);
- bf16 drift bound: the output within 2**-6 of its largest magnitude
  (each expert's two products are rounded to bf16 by both libraries,
  summed in another order, so single elements differ by a bf16 ulp or
  two, 2**-8 relative, before the gelu and the second product);
- a 2-layer, 4-expert GPT (capacity factor 1.0: some choices dropped)
  under plain, ``full`` and ``dots`` recompute, ``vocab_chunk`` and QAT
  (the MoE FFN unquantized, as in JAX; the attention's activation sites
  fed JAX's quantized activations as ``tests/test_torch_qat.py`` does,
  since fake-quant is a step function): loss + aux atol 1e-5, the aux
  atol 1e-6, every grad leaf atol 1e-5 with rtol 1e-4
  (``tests/test_torch_train.py``'s bounds);
- a 3-step ``fit`` against the JAX engine at a constant LR: every logged
  loss atol 1e-5;
- greedy generation token-identical (4 prompts: 3 slots an expert at
  each decode step, so decode steps drop choices on both sides);
- the decay mask leaf by leaf.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.core import meta

import fleetx_tpu.ops.quantization as JQ
from fleetx_tpu.core.module import GPTModule as JGPTModule
from fleetx_tpu.models.gpt import generation as JG
from fleetx_tpu.models.gpt.model import GPTForPretraining
from fleetx_tpu.models.gpt.model import config_from_dict as j_config
from fleetx_tpu.models.gpt.moe import MoEMlp
from fleetx_tpu.optims import optimizer as JOPT
from fleetx_tpu_torch.convert import check_tree, params_from_jax
from fleetx_tpu_torch.core.module import GPTModule
from fleetx_tpu_torch.models.gpt import generation as G
from fleetx_tpu_torch.models.gpt import model as M
from fleetx_tpu_torch.models.gpt import moe as MOE
from fleetx_tpu_torch.optims import optimizer as TOPT
from fleetx_tpu_torch.optims.optimizer import tree_leaves_with_path

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


MOE_YAML = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "fleetx_tpu", "configs", "nlp", "gpt",
    "pretrain_gpt_moe_8expert_mp4.yaml")
VOCAB, SEQ, BATCH, E = 256, 128, 2, 4
MODEL = dict(vocab_size=VOCAB, hidden_size=128, num_layers=2,
             num_attention_heads=2, max_position_embeddings=SEQ,
             hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
             use_flash_attention=True, fused_residual_norm=True,
             moe_num_experts=E, moe_top_k=2, moe_capacity_factor=1.0,
             moe_aux_weight=0.01, dtype="float32", param_dtype="float32")
PLAIN = dict(MODEL, use_flash_attention=False, fused_residual_norm=False)
#: the GPT variants held to JAX: (Model overrides, Quantization block)
VARIANTS = {
    "plain": ({}, None),
    "full": (dict(use_recompute=True, recompute_granularity="full"), None),
    "dots": (dict(use_recompute=True, recompute_granularity="dots"), None),
    "vocab_chunk": (dict(vocab_chunk=96), None),
    "qat": ({}, {"enable": True, "weight_bits": 8, "activation_bits": 8}),
}


def _batches(n: int, seed: int = 0) -> list:
    rng = np.random.RandomState(seed)
    return [{"tokens": rng.randint(0, VOCAB, (BATCH, SEQ)).astype(np.int32),
             "position_ids": np.broadcast_to(
                 np.arange(SEQ, dtype=np.int32), (BATCH, SEQ)).copy(),
             "labels": rng.randint(0, VOCAB, (BATCH, SEQ)).astype(np.int32),
             "loss_mask": (rng.rand(BATCH, SEQ) > 0.1).astype(np.float32)}
            for _ in range(n)]


def _tb(batch: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _rebuild(tree, leaves):
    it = iter(leaves)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return next(it)

    return walk(tree)


def _leaves(tree) -> list:
    return [p.clone().requires_grad_(True)
            for _, p in tree_leaves_with_path(tree)]


# ------------------------------------------------------------ the FFN alone
MLP_T, MLP_H = (3, 8), 32


def _mlp_case(dtype: str):
    """(jax cfg, port cfg, jax params, port params, x, probe): capacity
    factor 0.5, 8 experts, top-2, 24 tokens; token 0's input is zero, so
    its router row ties across every expert."""
    d = dict(hidden_size=MLP_H, num_layers=1, num_attention_heads=2,
             moe_num_experts=8, moe_top_k=2, moe_capacity_factor=0.5,
             dtype=dtype, param_dtype="float32")
    jcfg, tcfg = j_config(d), M.config_from_dict(d)
    rng = np.random.RandomState(0)
    x = rng.randn(*MLP_T, MLP_H).astype(np.float32)
    x[0, 0] = 0.0
    jparams = meta.unbox(MoEMlp(jcfg).init(jax.random.PRNGKey(0),
                                           jnp.asarray(x))["params"])
    # biases nonzero, so that the empty slots' outputs would show
    jparams = dict(jax.device_get(jparams))
    for k in ("wi_bias", "wo_bias"):
        jparams[k] = (0.1 * rng.randn(*jparams[k].shape)).astype(np.float32)
    tparams = {k: torch.from_numpy(np.array(v)) for k, v in jparams.items()}
    probe = rng.randn(*MLP_T, MLP_H).astype(np.float32)
    return jcfg, tcfg, jparams, tparams, x, probe


@pytest.fixture(scope="module")
def mlp_f32():
    """The f32 case and JAX's output, aux and grads of
    ``sum(y · probe) + aux``."""
    jcfg, tcfg, jparams, tparams, x, probe = _mlp_case("float32")
    mod = MoEMlp(jcfg)

    def run(p, xx):
        y, aux_vars = mod.apply({"params": p}, xx, mutable=["losses"])
        aux = sum(jnp.sum(a) for a in jax.tree.leaves(aux_vars))
        return jnp.sum(y * probe) + aux, (y, aux)

    (_, (y, aux)), grads = jax.value_and_grad(run, argnums=(0, 1),
                                              has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, jparams), jnp.asarray(x))
    return tcfg, tparams, x, probe, np.asarray(y), float(aux), \
        jax.device_get(grads)


@pytest.mark.parametrize("impl", ["index", "plain"])
def test_moe_mlp_matches_jax_with_drops_and_a_tie(mlp_f32, impl):
    tcfg, tparams, x, probe, y_want, aux_want, (g_p, g_x) = mlp_f32
    fn = MOE.moe_mlp if impl == "index" else MOE.moe_mlp_plain
    leaves = {k: v.clone().requires_grad_(True) for k, v in tparams.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    y, aux = fn(leaves, xt, tcfg)
    np.testing.assert_allclose(y.detach().numpy(), y_want, rtol=0,
                               atol=1e-5)
    assert abs(float(aux.detach()) - aux_want) <= 1e-6
    obj = (y * torch.from_numpy(probe)).sum() + aux
    grads = torch.autograd.grad(obj, [xt] + list(leaves.values()))
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(g_x), rtol=0,
                               atol=1e-5)
    for (k, _), g in zip(leaves.items(), grads[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(g_p[k]), rtol=0,
                                   atol=1e-5, err_msg=k)


def test_routing_ties_to_the_lower_index_and_drops_past_capacity(mlp_f32):
    tcfg, tparams, x, *_ = mlp_f32
    r = MOE.route(tparams["router_kernel"],
                  torch.from_numpy(x).reshape(-1, MLP_H), tcfg)
    t = MLP_T[0] * MLP_T[1]
    # jax.lax.top_k orders equal values by index; the tied row picks 0, 1
    assert r.experts[0].tolist() == [0, 1]
    assert torch.allclose(r.gates[0], torch.tensor([0.5, 0.5]))
    assert r.capacity == int(max(1, -(-0.5 * 2 * t // 8))) == 3
    assert 0.0 < float(r.dropped_share) < 1.0
    # GShard priority: a first choice is never dropped while a second
    # choice at the same expert is kept
    for e in range(8):
        first = r.keep[:, 0][r.experts[:, 0] == e]
        second = r.keep[:, 1][r.experts[:, 1] == e]
        if second.any():
            assert first.all(), e
    for tokens in (1, 7, 8, 3072, 8192):
        jax_cap = int(max(1, -(-1.25 * 2 * tokens // 8)))
        assert MOE.capacity(M.GPTConfig(moe_num_experts=8), tokens) == \
            jax_cap


def test_moe_mlp_bf16_within_the_drift_bound():
    jcfg, tcfg, jparams, tparams, x, _ = _mlp_case("bfloat16")
    want, _ = MoEMlp(jcfg).apply({"params": jax.tree_util.tree_map(
        jnp.asarray, jparams)}, jnp.asarray(x), mutable=["losses"])
    want = np.asarray(want.astype(jnp.float32))
    with torch.no_grad():
        got, _ = MOE.moe_mlp(tparams, torch.from_numpy(x), tcfg)
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want).max()
    assert err <= 2.0 ** -6 * np.abs(want).max(), err


# -------------------------------------------------------------- the GPT
@pytest.fixture(scope="module")
def weights():
    """(unboxed JAX params of the plain MoE model, the port's tree)."""
    jmod = JGPTModule({"Model": dict(PLAIN)})
    jparams = meta.unbox(jax.jit(lambda rng: jmod.init_variables(
        rng, _batches(1)[0]))(jax.random.PRNGKey(0)))
    return jparams, params_from_jax(jax.device_get(jparams),
                                    M.config_from_dict(dict(MODEL)))


def _record_jax(mp) -> list:
    """Every JAX ``fake_quant`` call from now on, in program order."""
    calls, orig = [], JQ.fake_quant

    def recording(x, bits=8, axis=None):
        q = orig(x, bits, axis)
        jax.debug.callback(lambda a, b: calls.append(
            (np.asarray(a), np.asarray(b), bits, axis)), x, q, ordered=True)
        return q

    mp.setattr(JQ, "fake_quant", recording)
    return calls


def _forced(mp, jax_calls: list) -> None:
    """The port's activation sites return JAX's quantized values in
    order (their own input first checked against JAX's within 1e-5)."""
    calls = iter([c for c in jax_calls if c[3] is None])
    orig = M.fake_quant

    def forced(x, bits=8, axis=None):
        if axis is not None:
            return orig(x, bits, axis)
        jx, jq, _, _ = next(calls)
        np.testing.assert_allclose(x.detach().numpy(), jx.reshape(x.shape),
                                   rtol=0, atol=1e-5)
        q = torch.from_numpy(jq.reshape(x.shape).copy())
        return x + (q - x).detach()

    mp.setattr(M, "fake_quant", forced)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_loss_aux_and_grads_match_jax(weights, variant, monkeypatch):
    jparams, tparams = weights
    knobs, quant = VARIANTS[variant]
    cfg = {"Model": dict(PLAIN, **knobs)}
    if quant:
        cfg["Quantization"] = quant
    batch = _batches(1, seed=2)[0]
    mp = pytest.MonkeyPatch()
    calls = _record_jax(mp) if quant else []
    jmod = JGPTModule(cfg)
    (j_total, j_metrics), j_grads = jax.jit(jax.value_and_grad(
        lambda p: jmod.training_loss(p, batch, jax.random.PRNGKey(3),
                                     jnp.int32(0)), has_aux=True))(jparams)
    jax.effects_barrier()
    mp.undo()
    if quant:
        # 4 sites in each layer's attention, none in the MoE FFN
        assert len(calls) == 4 * MODEL["num_layers"]
        _forced(monkeypatch, calls)
    tmod = GPTModule(dict(cfg, Model=dict(MODEL, **knobs)))
    leaves = _leaves(tparams)
    total, metrics = tmod.training_loss(_rebuild(tparams, leaves),
                                        _tb(batch), seed=3, step=0)
    grads = torch.autograd.grad(total, leaves)
    assert abs(float(total.detach()) - float(j_total)) <= 1e-5
    loss, aux = float(metrics["loss"].detach()), \
        float(metrics["moe_aux"].detach())
    assert abs(loss - float(j_metrics["loss"])) <= 1e-5
    assert abs(aux - float(j_metrics["moe_aux"])) <= 1e-6
    # the aux is in the objective: about E * (1/E) * aux_weight per layer
    assert 0.5 * 0.02 < aux < 2 * 0.02
    want = params_from_jax(jax.device_get(j_grads), tmod.model_cfg)
    for (path, w), g in zip(tree_leaves_with_path(want), grads):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg="/".join(path))


def test_validation_ignores_the_aux_and_the_model_drops_choices(weights):
    jparams, tparams = weights
    batch = _batches(1, seed=5)[0]
    jmod = JGPTModule({"Model": dict(PLAIN)})
    want = float(jax.jit(lambda p: jmod.validation_loss(p, batch)[0])(
        jparams))
    tmod = GPTModule({"Model": dict(MODEL)})
    with torch.no_grad():
        loss, metrics = tmod.validation_loss(tparams, _tb(batch))
        train, _ = tmod.training_loss(tparams, _tb(batch), seed=0, step=0)
    assert abs(float(loss) - want) <= 1e-5 and set(metrics) == {"loss"}
    assert float(train) > float(loss) + 0.01  # the aux is not in eval
    # at capacity factor 1.0 some token-choices of the first layer drop
    emb = tparams["gpt"]["embeddings"]
    x = emb["word_embeddings"][_tb(batch)["tokens"]] \
        + emb["position_embeddings"][:SEQ]
    lp = {k: v[0] for k, v in tparams["gpt"]["layers"]["mlp"].items()}
    r = MOE.route(lp["router_kernel"], x.reshape(-1, 128),
                  tmod.model_cfg)
    assert r.capacity == BATCH * SEQ * 2 // E and \
        float(r.dropped_share) > 0.0


def test_fit_loss_curve_matches_jax_engine(devices8):
    from fleetx_tpu.core.engine import EagerEngine as JEngine
    from fleetx_tpu.optims import lr_scheduler as JLR
    from fleetx_tpu.parallel.mesh import build_mesh
    from fleetx_tpu_torch.core.engine import EagerEngine
    from fleetx_tpu_torch.optims import lr_scheduler as TLR

    n = 3
    opt = {"name": "AdamW", "grad_clip": {"clip_norm": 1.0},
           "lr": {"name": "constant", "learning_rate": 1e-3}}
    cfg = {"Model": dict(MODEL), "Global": {"seed": 7}, "Optimizer": opt,
           "Engine": {"max_steps": n, "logging_freq": 1, "eval_freq": 0}}
    j_cfg = dict(cfg, Model=dict(PLAIN))
    batches = _batches(n, seed=4)
    j_lr = JLR.build_lr_scheduler(opt["lr"])
    j_eng = JEngine(j_cfg, JGPTModule(j_cfg),
                    optimizer=JOPT.build_optimizer(opt, j_lr),
                    lr_schedule=j_lr,
                    mesh=build_mesh({}, devices=devices8[:1]))
    j_eng.max_steps = n
    j_eng.prepare(batches[0])
    init = jax.device_get(meta.unbox(j_eng.state.params))
    j_losses = j_eng.fit(batches)
    t_lr = TLR.build_lr_scheduler(opt["lr"])
    t_eng = EagerEngine(cfg, GPTModule(cfg),
                        optimizer=TOPT.build_optimizer(opt, t_lr),
                        lr_schedule=t_lr, device="cpu")
    t_eng.params = params_from_jax(init, t_eng.module.model_cfg)
    t_losses = t_eng.fit(batches)
    assert len(t_losses) == len(j_losses) == n
    np.testing.assert_allclose(t_losses, j_losses, rtol=0, atol=1e-5)


def _numpy_weights(cfg: M.GPTConfig, seed: int = 1) -> dict:
    """Kernels std 0.1 (so greedy continuations vary), biases 0.05,
    LayerNorm scales 1 ± 0.1, in the JAX layout."""
    rng = np.random.RandomState(seed)

    def build(node, path):
        if isinstance(node, dict):
            return {k: build(v, path + (k,)) for k, v in node.items()}
        if path[-1] == "scale":
            return (1 + 0.1 * rng.randn(*node)).astype(np.float32)
        std = 0.05 if "bias" in path[-1] else 0.1
        return (std * rng.randn(*node)).astype(np.float32)

    return build(M.param_shapes(cfg), ())


def test_greedy_generation_is_token_identical():
    d = dict(PLAIN, vocab_size=97, hidden_size=64, num_attention_heads=4,
             max_position_embeddings=64, moe_capacity_factor=1.25)
    tcfg = M.config_from_dict(d)
    tree = _numpy_weights(tcfg)
    prompts = [[5, 9, 23, 41, 7], [3, 4], [60, 61, 62, 63, 64, 65, 66, 2],
               [88]]
    tokens, mask = G.left_pad(prompts, 0)
    kw = dict(max_new_tokens=9, do_sample=False, eos_token_id=96,
              pad_token_id=0)
    want = np.asarray(jax.jit(JG.generate, static_argnums=(0, 2))(
        GPTForPretraining(j_config(d)),
        jax.tree_util.tree_map(jnp.asarray, tree),
        JG.GenerationConfig(**kw), jnp.asarray(tokens), jnp.asarray(mask),
        jax.random.PRNGKey(1)))
    tt, tm = G.to_tensors(tokens, mask, "cpu")
    got = G.generate(tcfg, params_from_jax(tree, tcfg),
                     G.GenerationConfig(**kw), tt, tm)
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(np.unique(want)) > 4
    # each decode step routes 4 tokens over 4 experts: 3 slots an expert
    assert MOE.capacity(tcfg, len(prompts)) == 3


def test_decay_mask_matches_jax_leaf_for_leaf(weights):
    jparams, tparams = weights
    j_mask = jax.tree_util.tree_leaves(JOPT.decay_mask(jparams))
    t_mask = [m for _, m in tree_leaves_with_path(TOPT.decay_mask(tparams))]
    j_paths = [tuple(k.key for k in path) for path, _ in
               jax.tree_util.tree_flatten_with_path(jparams)[0]]
    t_paths = [p for p, _ in tree_leaves_with_path(tparams)]
    assert sorted(zip(j_paths, j_mask)) == sorted(zip(t_paths, t_mask))
    mlp = {p[-1]: m for p, m in zip(t_paths, t_mask) if "mlp" in p}
    assert mlp == {"router_kernel": True, "wi_kernel": True,
                   "wo_kernel": True, "wi_bias": False, "wo_bias": False}


def test_tree_checks_and_the_module_surface(weights):
    jparams, tparams = weights
    tcfg = M.config_from_dict(dict(MODEL))
    check_tree(jax.device_get(jparams), tcfg)
    shapes = M.param_shapes(tcfg)["gpt"]["layers"]["mlp"]
    assert shapes == {"router_kernel": (2, 128, E),
                      "wi_kernel": (2, E, 128, 512), "wi_bias": (2, E, 512),
                      "wo_kernel": (2, E, 512, 128), "wo_bias": (2, E, 128)}
    bad = jax.device_get(jparams)
    bad["gpt"]["layers"]["mlp"] = dict(bad["gpt"]["layers"]["mlp"],
                                       wi_bias=np.zeros((2, 512)))
    with pytest.raises(ValueError, match="wi_bias"):
        check_tree(bad, tcfg)
    seeded = M.init_params(M.config_from_dict(dict(MODEL,
                                                   param_dtype="bfloat16")))
    assert seeded["gpt"]["layers"]["mlp"]["router_kernel"].dtype == \
        torch.float32
    assert GPTModule({"Model": dict(MODEL)}).spec_family == "gpt_moe"
    assert GPTModule({"Model": dict(MODEL, moe_num_experts=0)}) \
        .spec_family == "gpt"
    # the recipe with its pipeline left on: the loader refuses it
    from fleetx_tpu_torch.tools import train as T

    with pytest.raises(NotImplementedError, match="item 12"):
        T.load_config(MOE_YAML, ["Distributed.dp_degree=1",
                                 "Distributed.mp_degree=1",
                                 "Distributed.pp_degree=2"])
    from fleetx_tpu_torch.serving.engine import ServingEngine
    with pytest.raises(NotImplementedError, match="no MoE decode stack"):
        ServingEngine(tcfg, tparams, device="cpu")


def test_recipe_trains_saves_evaluates_and_generates(tmp_path):
    """``pretrain_gpt_moe_8expert_mp4.yaml`` through ``tools.train`` at a
    tiny width (mp 4 and dp 2 cut to 1), its checkpoint through
    ``tools.eval``'s ``Data.Eval`` path and ``tasks.gpt.generation``."""
    from fleetx_tpu_torch.data import build_dataloader
    from fleetx_tpu_torch.tasks.gpt import generation as GEN
    from fleetx_tpu_torch.tools import eval as EV
    from fleetx_tpu_torch.tools import train as T

    yaml = MOE_YAML
    tiny = ["Distributed.dp_degree=1", "Distributed.mp_degree=1",
            "Model.num_layers=2", "Model.hidden_size=64",
            "Model.num_attention_heads=2", f"Model.vocab_size={VOCAB}",
            "Model.max_position_embeddings=128", "Global.max_seq_len=128",
            "Model.dtype=float32", "Global.global_batch_size=4",
            "Global.local_batch_size=4", "Global.micro_batch_size=2",
            "Data.Train.dataset.name=SyntheticGPTDataset",
            "Data.Train.dataset.num_samples=16",
            "Data.Eval.dataset.name=SyntheticGPTDataset",
            "Data.Eval.dataset.num_samples=8", "Engine.eval_iters=2",
            "Engine.eval_freq=0", "Engine.max_steps=2",
            "Engine.logging_freq=1", "Engine.save_load.save_steps=2",
            f"Engine.save_load.output_dir={tmp_path}"]
    cfg = T.load_config(yaml, tiny)
    engine, losses = T.run(cfg, device="cpu")
    mc = engine.module.model_cfg
    assert (mc.moe_num_experts, mc.moe_top_k, mc.moe_capacity_factor,
            mc.moe_aux_weight) == (8, 2, 1.25, 0.01)
    assert engine.accumulate_steps == 2 and len(losses) == 2
    assert all(np.isfinite(losses))
    loss = EV.data_eval(EV.load_config(yaml, tiny + [
        f"Engine.save_load.ckpt_dir={tmp_path}"]), device="cpu")
    assert np.isfinite(loss)
    with torch.no_grad():
        want = float(np.mean([
            float(engine.module.validation_loss(engine.params, {
                k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in b.items()})[0])
            for b, _ in zip(build_dataloader(cfg["Data"], "Eval",
                                             seq_length=128,
                                             vocab_size=VOCAB),
                            range(2))]))
    assert loss == pytest.approx(want, rel=1e-6)
    gen_cfg = GEN.load_config(yaml, tiny + [
        f"Engine.save_load.ckpt_dir={tmp_path}",
        "Generation.max_dec_len=5", "Generation.decode_strategy="
        "greedy_search", "Generation.input_text=5 9 23",
        "Model.module=GPTGenerationModule"])
    lines = GEN.run(gen_cfg, device="cpu")
    assert len(lines) == 1 and len(lines[0].split()) == 5
