"""Port parity: the GPT pretraining slice as a whole (``fleetx_tpu_torch``
model forward, ``GPTModule`` losses, AdamW, the LR schedule,
``EagerEngine.fit`` and ``tools/train.py``; the data path is
``tests/test_torch_data.py``).

The JAX parameters come from the JAX ``GPTModule`` / ``EagerEngine`` at a
tiny config (hidden 128, 2 layers, 2 heads of 64, seq 128, vocab 256, f32,
dropout 0) and pass through ``convert.params_from_jax``, so both sides run
the same weights on the same numpy batches. With ``use_flash_attention``
and ``fused_residual_norm`` on, the JAX side runs the Pallas kernels 1, 4,
5 and 6 in interpret mode and the port runs their plain versions on CPU
tensors.

Tolerances (f32): logits atol 1e-4 (two 2-layer stacks summed in another
order by another library); loss atol 1e-5 and every grad leaf atol 1e-5
with rtol 1e-4 (the grads are sums over 256 tokens of values that agree
to ~1e-7); optimizer and LR against optax / the JAX schedules rtol 1e-6
with atol 1e-4 x and 1e-6 x the peak lr (the port evaluates the schedule
and Adam's bias corrections in double; JAX forms them in f32, where
``1 - 0.999**t`` cancels to ~1e-5 relative and ``cos`` near pi loses
the schedule's tail); the 3-step ``fit`` loss curve rtol 5e-3, the bound
``tests/test_zz_flashbwd.py`` holds the JAX engine's own curves to.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from flax.core import meta

from fleetx_tpu.core.module import GPTModule as JGPTModule
from fleetx_tpu.models.gpt.model import GPTForPretraining
from fleetx_tpu.optims import lr_scheduler as JLR
from fleetx_tpu.optims import optimizer as JOPT
from fleetx_tpu_torch.convert import params_from_jax
from fleetx_tpu_torch.core.module import GPTModule
from fleetx_tpu_torch.models.gpt import model as M
from fleetx_tpu_torch.optims import lr_scheduler as TLR
from fleetx_tpu_torch.optims import optimizer as TOPT
from fleetx_tpu_torch.optims.optimizer import tree_leaves_with_path
from fleetx_tpu_torch.tools import train as T

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
SYNTH_YAML = os.path.join(REPO, "fleetx_tpu", "configs", "nlp", "gpt",
                          "pretrain_gpt_345M_synthetic.yaml")
VOCAB, SEQ, BATCH = 256, 128, 2
MODEL = dict(vocab_size=VOCAB, hidden_size=128, num_layers=2,
             num_attention_heads=2, max_position_embeddings=SEQ,
             hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
             use_flash_attention=True, flash_fused_bwd=True,
             fused_residual_norm=True, use_recompute=False,
             dtype="float32", param_dtype="float32")
#: the same model with the kernel knobs off: the JAX side uses it where
#: the point is not the kernels (init, validation, the fit curve), since
#: its Pallas kernels in interpret mode cost seconds a call on the CPU
PLAIN = dict(MODEL, use_flash_attention=False, fused_residual_norm=False)
#: the shrunk synthetic recipe the CLI tests run
TINY = ["Engine.max_steps=2", "Engine.logging_freq=1",
        "Model.num_layers=2", "Model.hidden_size=128",
        "Model.num_attention_heads=2", f"Model.vocab_size={VOCAB}",
        f"Model.max_position_embeddings={SEQ}", f"Global.max_seq_len={SEQ}",
        "Model.dtype=float32", "Global.global_batch_size=2",
        "Global.local_batch_size=2", "Global.micro_batch_size=2",
        "Data.Train.dataset.num_samples=16"]


def _batches(n: int, seed: int = 0, batch: int = BATCH) -> list:
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        out.append({
            "tokens": rng.randint(0, VOCAB, (batch, SEQ)).astype(np.int32),
            "position_ids": np.broadcast_to(
                np.arange(SEQ, dtype=np.int32), (batch, SEQ)).copy(),
            "labels": rng.randint(0, VOCAB, (batch, SEQ)).astype(np.int32),
            "loss_mask": (rng.rand(batch, SEQ) > 0.1).astype(np.float32)})
    return out


def _tb(batch: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def weights():
    """(jax module, unboxed jax params, port module, port params); the
    JAX module runs the kernels, the params come from its plain twin."""
    jmod = JGPTModule({"Model": dict(MODEL)})
    jparams = meta.unbox(JGPTModule({"Model": dict(PLAIN)}).init_variables(
        jax.random.PRNGKey(0), _batches(1)[0]))
    tmod = GPTModule({"Model": dict(MODEL)})
    tparams = params_from_jax(jax.device_get(jparams), tmod.model_cfg)
    return jmod, jparams, tmod, tparams


def _rebuild(tree, leaves):
    """``tree``'s nesting with ``leaves`` (insertion order) as its leaves."""
    it = iter(leaves)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return next(it)

    return walk(tree)


@pytest.mark.parametrize("kernels", [True, False])
def test_forward_logits_match_jax(weights, kernels):
    _, jparams, _, tparams = weights
    knobs = dict(use_flash_attention=kernels, fused_residual_norm=kernels)
    jcfg = JGPTModule({"Model": dict(MODEL, **knobs)}).model_cfg
    tcfg = M.config_from_dict(dict(MODEL, **knobs))
    batch = _batches(1, seed=1)[0]
    j_logits = GPTForPretraining(jcfg).apply(
        {"params": jparams}, jnp.asarray(batch["tokens"]),
        jnp.asarray(batch["position_ids"]), deterministic=True)
    tb = _tb(batch)
    with torch.no_grad():
        t_logits = M.gpt_for_pretraining(tparams, tcfg, tb["tokens"],
                                         tb["position_ids"])
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                               rtol=0, atol=1e-4)


def test_loss_and_grads_match_jax_with_the_kernels_on(weights):
    jmod, jparams, tmod, tparams = weights
    batch = _batches(1, seed=2)[0]
    j_loss, j_grads = jax.value_and_grad(
        lambda p: jmod.training_loss(p, batch, jax.random.PRNGKey(3),
                                     jnp.int32(0))[0])(jparams)
    leaves = [p.clone().requires_grad_(True)
              for _, p in tree_leaves_with_path(tparams)]
    params = _rebuild(tparams, leaves)
    loss, metrics = tmod.training_loss(params, _tb(batch), seed=3, step=0)
    grads = torch.autograd.grad(loss, leaves)
    assert abs(float(loss) - float(j_loss)) <= 1e-5
    assert float(metrics["loss"]) == float(loss)
    want = params_from_jax(jax.device_get(j_grads), tmod.model_cfg)
    for (path, w), g in zip(tree_leaves_with_path(want), grads):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg="/".join(path))


def test_validation_loss_and_evaluate_match_jax(weights):
    """Dropout-off validation loss against the JAX ``GPTModule``, and the
    engine's ``evaluate`` as the mean over at most ``eval_iters``
    batches."""
    _, jparams, tmod, tparams = weights
    jmod = JGPTModule({"Model": dict(PLAIN)})
    batches = _batches(3, seed=6)
    want = [float(jmod.validation_loss(jparams, b)[0]) for b in batches]
    with torch.no_grad():
        got = [float(tmod.validation_loss(tparams, _tb(b))[0])
               for b in batches]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    eng = _engine(_engine_cfg(1, eval_iters=2))
    eng.params = _rebuild(tparams, [p.clone() for _, p in
                                    tree_leaves_with_path(tparams)])
    assert eng.evaluate(batches) == pytest.approx(np.mean(got[:2]),
                                                  rel=1e-6)


def test_decay_mask_matches_jax_leaf_for_leaf(weights):
    _, jparams, _, tparams = weights
    j_mask = jax.tree_util.tree_leaves(JOPT.decay_mask(jparams))
    t_mask = [m for _, m in tree_leaves_with_path(TOPT.decay_mask(tparams))]
    # jax flattens dicts in sorted key order, the port in insertion order
    j_paths = [tuple(k.key for k in path) for path, _ in
               jax.tree_util.tree_flatten_with_path(jparams)[0]]
    t_paths = [p for p, _ in tree_leaves_with_path(tparams)]
    assert sorted(zip(j_paths, j_mask)) == sorted(zip(t_paths, t_mask))
    assert sum(t_mask) == 6 and len(t_mask) == 16


LR_CONFIGS = [
    {"name": "CosineAnnealingWithWarmupDecay", "decay_steps": 100,
     "warmup_rate": 0.05, "max_lr": 5e-5, "min_lr": 1e-5},
    {"max_lr": 1e-3, "warmup_steps": 2, "decay_steps": 100},
    {"name": "cosine", "max_lr": 3e-4, "decay_steps": 10},
    {"name": "constant", "learning_rate": 2e-4},
]


@pytest.mark.parametrize("cfg", LR_CONFIGS)
def test_lr_schedule_matches_jax(cfg):
    j_sched, t_sched = JLR.build_lr_scheduler(cfg), TLR.build_lr_scheduler(cfg)
    peak = float(cfg.get("max_lr", cfg.get("learning_rate", 0.0)))
    for step in (0, 1, 2, 3, 5, 9, 10, 50, 99, 100, 150):
        assert t_sched(step) == pytest.approx(float(j_sched(step)),
                                              rel=1e-6, abs=1e-6 * peak), step


def test_adamw_matches_optax_chain_over_steps():
    """Decay mask, clipping (the first step's norm exceeds the cap, later
    ones do not) and the bias-corrected moments, against the JAX
    package's optax chain, on a small tree with the model's leaf names."""
    rng = np.random.RandomState(0)
    shapes = {"gpt": {"embeddings": {"word_embeddings": (16, 8)},
                      "layers": {"ln1": {"scale": (2, 8), "bias": (2, 8)},
                                 "attn": {"qkv_kernel": (2, 8, 3, 2, 4),
                                          "qkv_bias": (2, 3, 2, 4)}},
                      "ln_f": {"scale": (8,), "bias": (8,)}}}

    def tree(fn, node=shapes):
        if isinstance(node, dict):
            return {k: tree(fn, v) for k, v in node.items()}
        return fn(node)

    init = tree(lambda shape: rng.randn(*shape).astype(np.float32))
    jparams = jax.tree_util.tree_map(jnp.asarray, init)
    t_leaves = [torch.tensor(a) for _, a in tree_leaves_with_path(init)]
    sched = {"max_lr": 1e-2, "warmup_steps": 1, "decay_steps": 10}
    opt_cfg = {"name": "AdamW", "grad_clip": {"clip_norm": 1.0}}
    j_tx = JOPT.build_optimizer(opt_cfg, JLR.build_lr_scheduler(sched))
    t_opt = TOPT.build_optimizer(opt_cfg, TLR.build_lr_scheduler(sched))
    j_state, j_update = j_tx.init(jparams), jax.jit(j_tx.update)
    t_state = t_opt.init(_rebuild(init, t_leaves))
    assert t_state["decay"] == [True, False, False, True, False, False,
                                False]
    for scale in (50.0, 0.01, 0.02):
        grads = tree(lambda shape: (scale * rng.randn(*shape)).astype(
            np.float32))
        j_grads = jax.tree_util.tree_map(jnp.asarray, grads)
        updates, j_state = j_update(j_grads, j_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        norm = t_opt.update(t_leaves, [torch.tensor(g) for _, g in
                                       tree_leaves_with_path(grads)],
                            t_state)
        assert float(norm) == pytest.approx(
            float(optax.global_norm(j_grads)), rel=1e-6)
    want = jax.device_get(jparams)
    for path, got in tree_leaves_with_path(_rebuild(init, t_leaves)):
        w = want
        for key in path:  # jax returns dicts in sorted key order
            w = w[key]
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-4 * sched["max_lr"],
                                   err_msg="/".join(path))


def _engine_cfg(n: int, **engine) -> dict:
    return {"Model": dict(MODEL),
            "Engine": dict({"max_steps": n, "logging_freq": 1,
                            "eval_freq": 0}, **engine),
            "Global": {"seed": 7},
            "Optimizer": {"name": "AdamW", "grad_clip": {"clip_norm": 1.0},
                          "lr": {"max_lr": 1e-3, "warmup_steps": 2,
                                 "decay_steps": 100}}}


def _engine(cfg: dict):
    """A port engine on the CPU with the config's optimizer and LR."""
    from fleetx_tpu_torch.core.engine import EagerEngine

    lr = TLR.build_lr_scheduler(cfg["Optimizer"]["lr"])
    return EagerEngine(cfg, GPTModule(cfg),
                       optimizer=TOPT.build_optimizer(cfg["Optimizer"], lr),
                       lr_schedule=lr, device="cpu")


def test_fit_loss_curve_matches_jax_engine(devices8):
    """The port's engine with the kernels on against the JAX engine's
    3-step curve on the same batches and initial weights."""
    from fleetx_tpu.core.engine import EagerEngine as JEngine
    from fleetx_tpu.parallel.mesh import build_mesh

    n = 3
    cfg = _engine_cfg(n)
    j_cfg = dict(cfg, Model=dict(PLAIN))
    batches = _batches(n, seed=4)
    j_lr = JLR.build_lr_scheduler(cfg["Optimizer"]["lr"])
    j_eng = JEngine(j_cfg, JGPTModule(j_cfg),
                    optimizer=JOPT.build_optimizer(cfg["Optimizer"], j_lr),
                    lr_schedule=j_lr,
                    mesh=build_mesh({}, devices=devices8[:1]))
    j_eng.max_steps = n
    j_eng.prepare(batches[0])
    init = jax.device_get(meta.unbox(j_eng.state.params))
    j_losses = j_eng.fit(batches)

    t_eng = _engine(cfg)
    t_eng.params = params_from_jax(init, t_eng.module.model_cfg)
    t_losses = t_eng.fit(batches)
    assert len(j_losses) == len(t_losses) == n
    np.testing.assert_allclose(t_losses, j_losses, rtol=5e-3, atol=5e-3)
    assert [r["global_step"] for r in t_eng.history] == [1, 2, 3]
    assert all(np.isfinite(r["grad_norm"]) for r in t_eng.history)
    assert [r["lr"] for r in t_eng.history] == pytest.approx(
        [float(j_lr(s)) for s in range(n)], rel=1e-6)


def test_accumulated_microbatches_equal_one_full_batch():
    """accumulate_steps 2 over two halves (f32 carry) takes the same
    update as one step on the whole batch (equal halves, dropout off)."""
    batch = _batches(1, seed=5, batch=4)[0]
    batch["loss_mask"][:] = 1.0
    params = []
    for accum in (1, 2):
        eng = _engine(_engine_cfg(1, accumulate_steps=accum))
        assert eng.accumulate_steps == accum
        eng.fit([batch])
        params.append([p.detach() for _, p in
                       tree_leaves_with_path(eng.params)])
    for a, b in zip(*params):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-6)


# ---------------------------------------------------------------- the CLI
def test_train_cli_on_cpu_runs_and_logs():
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "fleetx_tpu_torch.tools.train", "-c",
           SYNTH_YAML, "--device", "cpu"]
    for o in TINY:
        cmd += ["-o", o]
    out = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = [l for l in out.stderr.splitlines() if "[train] global step" in l]
    assert len(lines) == 2 and "global step 2," in lines[-1], out.stderr
    loss = float(lines[0].split("loss: ")[1].split(",")[0])
    assert abs(loss - np.log(VOCAB)) < 0.1


UNCOVERED = {
    # dots, QAT and MoE are ported: they build and take a step
    "recompute_dots": (["Model.use_recompute=True",
                        "Model.recompute_granularity=dots",
                        "Model.remat_save_dtype=bfloat16"], None),
    # telemetry and the profiler window are ported; gang mode is not
    "observability": (["Observability.enable=True"], None),
    "observability_gang": (["Observability.gang=True"], "item 12"),
    "seq_degree": (["Distributed.seq_degree=2",
                    "Model.use_ring_attention=True",
                    "Model.attention_probs_dropout_prob=0.0"], "item 12"),
    # MoE is ported: it builds and takes a step
    "moe": (["Model.moe_num_experts=4"], None),
    "qat": (["Quantization.enable=True", "Quantization.weight_bits=4"],
            None),
    # fp16, Resilience.enable and the SDC sentinel are ported; the gang
    # watchdog is not
    "resilience": (["Resilience.enable=True",
                    "Resilience.integrity.sentinel_every=5"], None),
    "gang_watchdog": (["Resilience.enable=True",
                       "Resilience.watchdog.enable=True",
                       "Resilience.watchdog.gang_sync_steps=2"], "item 12"),
    # checkpoints and asynchronous saves are ported; their multi-rank
    # options are not
    "save_steps": (["Engine.save_load.save_steps=10",
                    "Engine.save_load.per_rank_dirs=True"], "item 12"),
    "ckpt_dir": (["Engine.save_load.ckpt_dir=/nonexistent",
                  "Engine.save_load.async_save=True"], None),
    # a degree above 1 is a gang's: in a world of one rank it is JAX's
    # world mismatch (tools.supervise --num-procs 2 runs it)
    "dp_degree": (["Distributed.dp_degree=2",
                   "Global.global_batch_size=4"], "world"),
    # sequence parallelism is ported; at mp 1 it changes nothing
    "sequence_parallel": (["Distributed.sequence_parallel=True"], None),
    "profiler": (["Profiler.enable=True"], None),
}


@pytest.mark.parametrize("what", sorted(UNCOVERED))
def test_uncovered_config_values_raise(what, tmp_path):
    overrides, item = UNCOVERED[what]
    if item is None:  # ported: the trainer builds and takes a step
        # telemetry and profiler files land in the test's directory
        overrides = overrides + [
            f"Observability.output_dir={tmp_path / 'telemetry'}",
            f"Profiler.profiler_log={tmp_path / 'profiler_log'}"]
        engine, train_dl, _ = T.build_trainer(
            T.load_config(SYNTH_YAML, TINY + overrides), device="cpu")
        mc = engine.module.model_cfg
        if what == "observability":
            assert engine.obs.enabled and engine.obs.sinks
        elif what == "profiler":
            assert engine.profiler.enabled and \
                engine.profiler.start_step == 3
        elif what == "qat":
            assert mc.use_qat and mc.qat_bits == 4 and mc.qat_act_bits == 8
        elif what == "moe":
            assert mc.moe_num_experts == 4 and \
                engine.module.spec_family == "gpt_moe"
        elif what == "resilience":
            assert engine.resilience.sentinel_every == 5
        elif what == "ckpt_dir":
            # no checkpoint there: a warning, then training from step 0
            assert engine.async_save
        elif what == "sequence_parallel":
            assert engine.mesh is None and \
                engine.cfg["Distributed"]["sequence_parallel"]
        else:
            assert mc.recompute_granularity == "dots" and \
                mc.remat_save_dtype == torch.bfloat16
        engine.max_steps = 1
        losses = engine.fit(train_dl)
        assert len(losses) == 1 and np.isfinite(losses[0])
        return
    if item == "world":
        with pytest.raises(ValueError, match=r"dp\(2\) .* != device count "
                                             r"\(1\)"):
            T.load_config(SYNTH_YAML, TINY + overrides)
        return
    with pytest.raises(NotImplementedError, match=item):
        T.build_trainer(T.load_config(SYNTH_YAML, TINY + overrides),
                        device="cpu")
