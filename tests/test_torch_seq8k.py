"""Port parity: the long-context recipe
``pretrain_gpt_1.3B_seq8k_ring.yaml`` as a whole: its structure at a tiny
size (ring + full recompute + vocab_chunk + 4 micro-batches) trained
against the JAX engine, accumulation over micro-batches, the recipe at
full size through the config loader, the data path and the converter
(shapes and counts only: its weights would take gigabytes), and the CLI.

The same numpy batches and converted weights go through the JAX
``EagerEngine`` (a one-device ``seq`` mesh; the Pallas kernels in
interpret mode) and the port's on CPU tensors.

Tolerance: the 3-step ``fit`` curve rtol 5e-3, the bound
``tests/test_zz_flashbwd.py`` holds the JAX engine's own curves to.
"""

import os
import subprocess
import sys
import weakref

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.core import meta

from fleetx_tpu.core.module import GPTModule as JGPTModule
from fleetx_tpu.models.gpt import model as JM
from fleetx_tpu.optims import lr_scheduler as JLR
from fleetx_tpu.optims import optimizer as JOPT
from fleetx_tpu_torch import convert
from fleetx_tpu_torch.core.module import GPTModule
from fleetx_tpu_torch.models.gpt import model as M
from fleetx_tpu_torch.optims import lr_scheduler as TLR
from fleetx_tpu_torch.optims import optimizer as TOPT
from fleetx_tpu_torch.optims.optimizer import tree_leaves_with_path
from fleetx_tpu_torch.ops import flash_attention as FA
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
SEQ8K_YAML = os.path.join(REPO, "fleetx_tpu", "configs", "nlp", "gpt",
                          "pretrain_gpt_1.3B_seq8k_ring.yaml")
#: the overrides that put the recipe on one device with synthetic data
ONE_DEVICE = ["Distributed.dp_degree=1", "Distributed.seq_degree=1",
              "Data.Train.dataset.name=SyntheticGPTDataset",
              "Data.Train.dataset.seq_length=8192",
              "Data.Train.dataset.vocab_size=50304", "Engine.max_steps=3",
              "Engine.eval_freq=0", "Engine.save_load.save_steps=0"]
VOCAB = 256


def _batch(seed: int, batch: int, seq: int) -> dict:
    rng = np.random.RandomState(seed)
    return {"tokens": rng.randint(0, VOCAB, (batch, seq)).astype(np.int32),
            "position_ids": np.broadcast_to(np.arange(seq, dtype=np.int32),
                                            (batch, seq)).copy(),
            "labels": rng.randint(0, VOCAB, (batch, seq)).astype(np.int32),
            "loss_mask": (rng.rand(batch, seq) > 0.1).astype(np.float32)}


#: the recipe's structure at a tiny size: ring + full recompute +
#: vocab_chunk + 4 micro-batches of 2, 2 layers, hidden 128, 2 heads of 64,
#: seq 256 (the ring's local block takes the flash route)
TINY_SEQ8K = dict(vocab_size=VOCAB, hidden_size=128, num_layers=2,
                  num_attention_heads=2, max_position_embeddings=256,
                  hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
                  use_ring_attention=True, ring_kv_chunk=64,
                  vocab_chunk=96, use_recompute=True,
                  recompute_granularity="full", dtype="float32",
                  param_dtype="float32")


def _tiny_cfg(n: int) -> dict:
    return {"Model": dict(TINY_SEQ8K),
            "Engine": {"max_steps": n, "logging_freq": 1, "eval_freq": 0,
                       "accumulate_steps": 4},
            "Global": {"seed": 7},
            "Optimizer": {"name": "AdamW", "grad_clip": {"clip_norm": 1.0},
                          "lr": {"max_lr": 1e-3, "warmup_steps": 2,
                                 "decay_steps": 100}}}


def _port_engine(cfg: dict):
    from fleetx_tpu_torch.core.engine import EagerEngine

    lr = TLR.build_lr_scheduler(cfg["Optimizer"]["lr"])
    return EagerEngine(cfg, GPTModule(cfg),
                       optimizer=TOPT.build_optimizer(cfg["Optimizer"], lr),
                       lr_schedule=lr, device="cpu")


def test_tiny_seq8k_fit_matches_jax_engine(devices8, monkeypatch):
    """Ring + full recompute + vocab_chunk + accumulate 4: the port's
    3-step curve against the JAX engine's on the same batches and
    weights; the split kernels' plain versions run in every layer of
    every micro-batch, the fused backward never."""
    from fleetx_tpu.core.engine import EagerEngine as JEngine
    from fleetx_tpu.parallel.mesh import build_mesh

    n = 3
    cfg = _tiny_cfg(n)
    batches = [_batch(10 + i, batch=8, seq=256) for i in range(n)]
    j_lr = JLR.build_lr_scheduler(cfg["Optimizer"]["lr"])
    j_eng = JEngine(cfg, JGPTModule(cfg),
                    optimizer=JOPT.build_optimizer(cfg["Optimizer"], j_lr),
                    lr_schedule=j_lr,
                    mesh=build_mesh({"seq_degree": 1},
                                    devices=devices8[:1]))
    j_eng.max_steps = n
    j_eng.prepare(batches[0])
    init = jax.device_get(meta.unbox(j_eng.state.params))
    j_losses = j_eng.fit(batches)

    calls = {"bwd_plain": 0, "bwd_dq_plain": 0, "bwd_dkv_plain": 0}
    for name in calls:
        fn = getattr(FA, name)

        def counted(*a, _fn=fn, _n=name):
            calls[_n] += 1
            return _fn(*a)

        monkeypatch.setattr(FA, name, counted)
    t_eng = _port_engine(cfg)
    assert t_eng.accumulate_steps == 4
    t_eng.params = convert.params_from_jax(init, t_eng.module.model_cfg)
    t_losses = t_eng.fit(batches)
    np.testing.assert_allclose(t_losses, j_losses, rtol=5e-3, atol=5e-3)
    per_step = TINY_SEQ8K["num_layers"] * 4
    assert calls == {"bwd_plain": 0, "bwd_dq_plain": n * per_step,
                     "bwd_dkv_plain": n * per_step}


def test_micro_batches_share_the_step_key_and_free_their_graphs():
    """Every micro-batch of a step draws the step's dropout randomness
    (``dropout_rng(seed, step)``, as JAX's ``grads_and_metrics(...,
    state.step)``), and no metric keeps a micro-batch's graph alive into
    the next one."""
    cfg = _tiny_cfg(2)
    cfg["Model"] = dict(cfg["Model"], hidden_dropout_prob=0.1)
    eng = _port_engine(cfg)
    seen, last = [], []
    real = eng.module.training_loss

    def spy(params, batch, seed, step):
        if last:
            assert last[-1]() is None, "the previous micro-batch's loss " \
                "(and its graph) is still alive"
        loss, metrics = real(params, batch, seed, step)
        seen.append((seed, step))
        last.append(weakref.ref(loss))
        return loss, metrics

    eng.module.training_loss = spy
    batches = [_batch(20 + i, batch=8, seq=256) for i in range(2)]
    eng.fit(batches)
    assert seen == [(7, 0)] * 4 + [(7, 1)] * 4
    assert all(np.isfinite(r["loss"]) for r in eng.history)


def test_seq8k_recipe_loads_on_one_device():
    """The recipe with the two Distributed overrides: 4 micro-batches of
    2 (global 8, local 8), seq 8192 through to the dataset and the MFU
    count, the ring / recompute / chunked-head knobs as the YAML sets
    them, and 8 vocab chunks of 6288 with no pad."""
    cfg = T.load_config(SEQ8K_YAML, ONE_DEVICE)
    glb = cfg["Global"]
    assert (glb["global_batch_size"], glb["local_batch_size"],
            glb["micro_batch_size"], glb["max_seq_len"]) == (8, 8, 2, 8192)
    assert cfg["Engine"]["accumulate_steps"] == 4
    assert all(cfg["Distributed"][k] == 1 for k in
               ("dp_degree", "seq_degree", "mp_degree", "pp_degree"))
    module = GPTModule(cfg)
    mc = module.model_cfg
    assert (mc.num_layers, mc.hidden_size, mc.num_attention_heads,
            mc.head_dim, mc.vocab_size) == (24, 2048, 16, 128, 50304)
    assert mc.max_position_embeddings == 8192
    assert mc.use_ring_attention and mc.ring_kv_chunk == 512
    assert mc.use_recompute and mc.recompute_granularity == "full"
    assert mc.vocab_chunk == 6288 and mc.attention_probs_dropout_prob == 0.0
    assert M.chunk_geometry(mc.vocab_size, mc.vocab_chunk) == (6288, 8, 0)
    assert module.tokens_per_sample == 8192
    n_params = 24 * 12 * 2048 ** 2 + 50304 * 2048
    assert module.flops_per_token() == 6.0 * n_params + 12.0 * 24 * 2048 * 8192
    engine, train_dl, valid_dl = T.build_trainer(cfg, device="cpu")
    assert engine.accumulate_steps == 4 and valid_dl is None
    batch = next(iter(train_dl))
    assert batch["tokens"].shape == (8, 8192)
    assert batch["tokens"].dtype == np.int32
    assert batch["tokens"].max() < 50304
    np.testing.assert_array_equal(batch["tokens"][:, 1:],
                                  batch["labels"][:, :-1])
    np.testing.assert_array_equal(batch["position_ids"][3],
                                  np.arange(8192))
    assert (batch["loss_mask"] == 1.0).all()


def test_converter_checks_the_seq8k_parameter_tree():
    """The JAX parameter tree of the 1.3B recipe (shapes only, from
    ``jax.eval_shape``) is the port's: the slice adds no parameter."""
    cfg = T.load_config(SEQ8K_YAML, ONE_DEVICE)
    model = dict(cfg["Model"], use_ring_attention=False, use_recompute=False)
    jcfg = JM.config_from_dict(model)
    shapes = jax.eval_shape(lambda: JM.GPTForPretraining(jcfg).init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 8), jnp.int32),
        None, deterministic=True)["params"])
    tree = meta.unbox(shapes)
    tcfg = M.config_from_dict(dict(cfg["Model"]))
    convert.check_tree(tree, tcfg)
    n = sum(int(np.prod(s)) for _, s in
            tree_leaves_with_path(M.param_shapes(tcfg)))
    assert 1.3e9 < n < 1.4e9
    bad = dict(tree, gpt=dict(tree["gpt"], ln_f={"scale": tree["gpt"][
        "ln_f"]["scale"]}))
    with pytest.raises(ValueError, match="missing leaves"):
        convert.check_tree(bad, tcfg)


def test_seq8k_train_cli_scaled_down_on_cpu():
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    shrink = ["Model.num_layers=2", "Model.hidden_size=128",
              "Model.num_attention_heads=2", f"Model.vocab_size={VOCAB}",
              "Model.max_position_embeddings=256", "Global.max_seq_len=256",
              "Model.vocab_chunk=96", "Model.dtype=float32",
              "Data.Train.dataset.seq_length=256",
              f"Data.Train.dataset.vocab_size={VOCAB}",
              "Engine.max_steps=2"]
    cmd = [sys.executable, "-m", "fleetx_tpu_torch.tools.train", "-c",
           SEQ8K_YAML, "--device", "cpu"]
    for o in ONE_DEVICE + shrink:
        cmd += ["-o", o]
    out = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = [l for l in out.stderr.splitlines() if "[train] global step" in l]
    assert len(lines) == 2 and "global step 2," in lines[-1], out.stderr
    loss = float(lines[0].split("loss: ")[1].split(",")[0])
    assert abs(loss - np.log(VOCAB)) < 0.1
