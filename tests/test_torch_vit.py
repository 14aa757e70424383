"""Port parity: the ViT family (``fleetx_tpu_torch/models/vision/``,
``convert.vit_params_from_jax``, ``vit_lr``, ``Momentum``, the epoch run
mode, and ViT through ``EagerEngine.fit`` / ``evaluate`` and
``tools/train.py``; the datasets, transforms and collate helpers are
``tests/test_torch_vision_data.py``).

The JAX parameters come from the JAX ``GeneralClsModule`` at a tiny config
(image 32, patch 8, 16 patches, hidden 64, 2 blocks, 4 heads, 10 classes,
f32, dropout and DropPath 0) and pass through ``vit_params_from_jax``. The
JAX head is zeros at init, so every logit ties; the tests that read
logits or top-k put a seeded random head into the JAX tree first (both
sides then rank tie-free logits: ``lax.top_k`` and ``torch.topk`` order
ties differently). Neither side reaches a Pallas or hand-written kernel.

Tolerances: f32 logits, losses and metrics within 1e-5 (atol); every
grad leaf within 1e-5 of its largest magnitude where that exceeds 1 (the
random head makes the ``cls_token`` and ``pos_embed`` grads O(30), sums
over the batch whose f32 rounding is ~1e-6 relative); ``vit_lr`` within 1e-6 relative plus 1e-6 x the peak (the port
evaluates the schedule in double, JAX in f32); the SGD updates within
1e-6 (one f32 rounding of the learning rate apart); the 3-step and the
8-step epoch-mode ``fit`` losses within 1e-5. bf16 drift: the port's bf16
logits against JAX's bf16 logits on the same weights within 2**-5 of the
largest f32 logit, and against its own f32 within 2**-4 (the reasons of
``tests/test_torch_ernie.py``).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from flax.core import meta

from fleetx_tpu.core.engine import EagerEngine as JEngine
from fleetx_tpu.models.vision import loss as JL
from fleetx_tpu.models.vision.module import GeneralClsModule as JClsModule
from fleetx_tpu.optims import lr_scheduler as JLR
from fleetx_tpu.optims import optimizer as JOPT
from fleetx_tpu_torch.convert import check_vit_tree, vit_params_from_jax
from fleetx_tpu_torch.core import checkpoint as ckpt_lib
from fleetx_tpu_torch.core.engine import EagerEngine
from fleetx_tpu_torch.models.vision import loss as L
from fleetx_tpu_torch.models.vision import vit as V
from fleetx_tpu_torch.models.vision.module import GeneralClsModule
from fleetx_tpu_torch.optims import lr_scheduler as TLR
from fleetx_tpu_torch.optims import optimizer as TOPT
from fleetx_tpu_torch.optims.optimizer import tree_leaves_with_path
from fleetx_tpu_torch.tools import train as T

pytestmark = pytest.mark.torch_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VIT_YAML = os.path.join(REPO, "fleetx_tpu", "configs", "vis", "vit",
                        "ViT_base_patch16_224_pretrain.yaml")
CLASSES, IMAGE, BATCH = 10, 32, 4
MODEL = {"module": "GeneralClsModule", "name": "ViT_tiny_patch16_224",
         "num_classes": CLASSES, "image_size": IMAGE, "patch_size": 8,
         "num_layers": 2, "hidden_size": 64, "num_attention_heads": 4,
         "drop_path_rate": 0.0, "dtype": "float32",
         "param_dtype": "float32", "loss": {"name": "ViTCELoss",
                                            "epsilon": 0.0001},
         "metric": {"name": "TopkAcc", "topk": [1, 5]}}
TINY = ["Global.global_batch_size=4", "Global.local_batch_size=4",
        "Global.micro_batch_size=4", "Engine.max_steps=2",
        "Engine.logging_freq=1", "Engine.eval_freq=2", "Engine.eval_iters=2",
        "Engine.save_load.save_steps=0", f"Model.num_classes={CLASSES}",
        f"Model.image_size={IMAGE}", "Model.patch_size=8",
        "Model.num_layers=2", "Model.hidden_size=64",
        "Model.num_attention_heads=4", "Model.dtype=float32"] + [
    f"Data.{mode}.dataset.{k}={v}" for mode in ("Train", "Eval")
    for k, v in (("name", "SyntheticVisionDataset"), ("num_samples", 16),
                 ("image_size", IMAGE), ("num_classes", CLASSES))]


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """This file's tensors are tiny: torch runs them on one intra-op
    thread (its default pool, on cores the other test workers share,
    costs far more than the work). The count is restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batches(n: int, seed: int = 0, batch: int = BATCH) -> list:
    rng = np.random.RandomState(seed)
    return [{"images": rng.randn(batch, IMAGE, IMAGE, 3).astype(np.float32),
             "labels": rng.randint(0, CLASSES, batch).astype(np.int32)}
            for _ in range(n)]


def _tb(batch: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def weights():
    """(jax module, unboxed jax params with a seeded random head, port
    module, port params)."""
    jmod = JClsModule({"Model": dict(MODEL)})
    jparams = meta.unbox(jmod.init_variables(jax.random.PRNGKey(0),
                                             _batches(1)[0]))
    rng = np.random.RandomState(11)
    jparams = dict(jparams,
                   head_kernel=jnp.asarray(rng.randn(64, CLASSES) * 0.5,
                                           jnp.float32),
                   head_bias=jnp.asarray(rng.randn(CLASSES) * 0.1,
                                         jnp.float32))
    tmod = GeneralClsModule({"Model": dict(MODEL)})
    tparams = vit_params_from_jax(jax.device_get(jparams), tmod.vit_cfg)
    return jmod, jparams, tmod, tparams


@pytest.fixture(scope="module")
def jax_logits(weights):
    jmod, jparams, _, _ = weights
    batch = _batches(1, seed=1)[0]
    return batch, np.asarray(jax.jit(lambda p, x: jmod.model.apply(
        {"params": p}, x))(jparams, batch["images"]))


def test_forward_logits_match_jax(weights, jax_logits):
    """The patch matmul against JAX's HWIO convolution, the cls token,
    the blocks and the head: the same logits."""
    _, _, tmod, tparams = weights
    batch, want = jax_logits
    with torch.no_grad():
        got = V.vit(tparams, tmod.vit_cfg, torch.from_numpy(batch["images"]))
    assert got.shape == (BATCH, CLASSES)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_validation_metrics_match_jax(weights, jax_logits):
    jmod, jparams, tmod, tparams = weights
    batch, logits = jax_logits
    assert len({tuple(np.argsort(-r)[:5]) for r in logits}) == BATCH
    _, want = jmod.validation_loss(jparams, batch)
    with torch.no_grad():
        loss, got = tmod.validation_loss(tparams, _tb(batch))
    assert sorted(got) == sorted(want) == ["loss", "top1", "top5"]
    for k in want:
        assert abs(float(got[k]) - float(want[k])) <= 1e-5, k
    assert float(loss) == float(got["loss"])


def _rebuild(tree, leaves):
    it = iter(leaves)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return next(it)

    return walk(tree)


def test_loss_and_every_grad_leaf_match_jax(weights):
    jmod, jparams, tmod, tparams = weights
    batch = _batches(1, seed=2)[0]
    assert tmod.label_smoothing == jmod.label_smoothing == 0.0001
    j_loss, j_grads = jax.jit(jax.value_and_grad(
        lambda p: jmod.training_loss(p, batch, jax.random.PRNGKey(3),
                                     jnp.int32(0))[0]))(jparams)
    leaves = [p.clone().requires_grad_(True)
              for _, p in tree_leaves_with_path(tparams)]
    params = _rebuild(tparams, leaves)
    loss, _ = tmod.training_loss(params, _tb(batch), seed=3, step=0)
    grads = torch.autograd.grad(loss, leaves)
    assert abs(float(loss.detach()) - float(j_loss)) <= 1e-5
    want = vit_params_from_jax(jax.device_get(j_grads), tmod.vit_cfg)
    for (path, w), g in zip(tree_leaves_with_path(want), grads):
        scale = max(1.0, float(w.abs().max()))
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=1e-5 * scale, err_msg="/".join(path))


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("soft", [False, True])
def test_cross_entropy_matches_jax(smoothing, soft):
    rng = np.random.RandomState(5)
    logits = rng.randn(8, CLASSES).astype(np.float32) * 3
    labels = rng.randint(0, CLASSES, 8).astype(np.int32)
    if soft:
        labels = rng.dirichlet(np.ones(CLASSES), 8).astype(np.float32)
    want = JL.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                            smoothing)
    got = L.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                          smoothing)
    assert abs(float(got) - float(want)) <= 1e-5
    assert float(L.vit_cross_entropy(torch.from_numpy(logits),
                                     torch.from_numpy(labels))) == \
        pytest.approx(float(JL.vit_cross_entropy(jnp.asarray(logits),
                                                 jnp.asarray(labels))),
                      abs=1e-5)


@pytest.mark.parametrize("topk", [(1, 5), (1, 3, 20)])
def test_topk_accuracy_matches_jax_on_tie_free_logits(topk):
    rng = np.random.RandomState(6)
    logits = rng.permutation(64 * CLASSES).reshape(64, CLASSES).astype(
        np.float32)
    labels = rng.randint(0, CLASSES, 64).astype(np.int32)
    want = JL.topk_accuracy(jnp.asarray(logits), jnp.asarray(labels), topk)
    got = L.topk_accuracy(torch.from_numpy(logits), torch.from_numpy(labels),
                          topk)
    assert sorted(got) == sorted(want)
    for k in want:
        assert float(got[k]) == float(want[k]), k
    one_hot = np.eye(CLASSES, dtype=np.float32)[labels]
    soft = L.topk_accuracy(torch.from_numpy(logits),
                           torch.from_numpy(one_hot), topk)
    assert {k: float(v) for k, v in soft.items()} == \
        {k: float(v) for k, v in got.items()}


@pytest.mark.parametrize("decay_type", ["cosine", "linear"])
def test_vit_lr_matches_jax_over_20_steps(decay_type):
    cfg = {"name": "ViTLRScheduler", "learning_rate": 0.003,
           "decay_type": decay_type, "warmup_steps": 5, "total_steps": 18,
           "min_lr": 1e-5}
    j_sched, t_sched = JLR.build_lr_scheduler(cfg), \
        TLR.build_lr_scheduler(cfg)
    for step in range(20):
        assert t_sched(step) == pytest.approx(float(j_sched(step)), rel=1e-6,
                                              abs=1e-6 * 0.003), step
    assert t_sched(19) == pytest.approx(1e-5)


@pytest.mark.parametrize("clip", [None, 0.5])
def test_sgd_updates_match_optax(clip):
    """``Momentum`` against the JAX ``sgd`` chain: three updates, the
    clip triggered on every one at 0.5 and never without it."""
    rng = np.random.RandomState(7)
    tree = {"w": rng.randn(4, 3).astype(np.float32),
            "b": {"bias": rng.randn(3).astype(np.float32)}}
    sched = JLR.build_lr_scheduler({"name": "cosine", "max_lr": 0.1,
                                    "warmup_steps": 1, "decay_steps": 10})
    cfg = {"name": "Momentum", "momentum": 0.9, "grad_clip": clip}
    tx = JOPT.build_optimizer(cfg, sched)
    opt = TOPT.build_optimizer(cfg, TLR.build_lr_scheduler(
        {"name": "cosine", "max_lr": 0.1, "warmup_steps": 1,
         "decay_steps": 10}))
    assert isinstance(opt, TOPT.Momentum)
    jparams = jax.tree.map(jnp.asarray, tree)
    state = tx.init(jparams)
    tparams = {"w": torch.from_numpy(tree["w"].copy()),
               "b": {"bias": torch.from_numpy(tree["b"]["bias"].copy())}}
    tstate = opt.init(tparams)
    leaves = [p for _, p in tree_leaves_with_path(tparams)]
    for _ in range(3):
        grads = {"w": rng.randn(4, 3).astype(np.float32),
                 "b": {"bias": rng.randn(3).astype(np.float32)}}
        updates, state = tx.update(jax.tree.map(jnp.asarray, grads), state,
                                   jparams)
        jparams = optax.apply_updates(jparams, updates)
        g_norm = opt.update(leaves, [torch.from_numpy(grads["w"]),
                                     torch.from_numpy(grads["b"]["bias"])],
                            tstate)
        assert clip is None or float(g_norm) > clip
    np.testing.assert_allclose(tparams["w"].numpy(), np.asarray(jparams["w"]),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(tparams["b"]["bias"].numpy(),
                               np.asarray(jparams["b"]["bias"]), rtol=0,
                               atol=1e-6)
    flat = opt.flat_state(tstate, tparams)
    fresh = opt.init(tparams)
    opt.load_flat_state(fresh, flat, tparams)
    assert fresh["count"] == 3 and all(
        torch.equal(a, b) for a, b in zip(fresh["trace"], tstate["trace"]))


def test_decay_mask_matches_jax_leaf_for_leaf(weights):
    """``pos_embed``, ``cls_token`` and ``patch_kernel`` decay in JAX (no
    substring or exact name exempts them), and do here."""
    _, jparams, _, tparams = weights
    j_mask = jax.tree_util.tree_leaves(JOPT.decay_mask(jparams))
    j_paths = [tuple(k.key for k in path) for path, _ in
               jax.tree_util.tree_flatten_with_path(jparams)[0]]
    t_mask = dict(tree_leaves_with_path(TOPT.decay_mask(tparams)))
    assert dict(zip(j_paths, j_mask)) == t_mask
    for name in ("pos_embed", "cls_token", "patch_kernel", "head_kernel"):
        assert t_mask[(name,)], name
    assert not t_mask[("blocks", "ln1", "scale")]
    assert not t_mask[("ln_f", "scale")]
    assert not t_mask[("blocks", "attn", "qkv_bias")]


def test_seeded_init_has_the_jax_layout_and_distributions():
    cfg = GeneralClsModule({"Model": dict(MODEL)}).vit_cfg
    params = V.init_params(cfg, seed=0)
    check_vit_tree(params, cfg)
    limit = np.sqrt(3.0 / ((3 * 64 + 64 * 64) / 2))  # HWIO fan_avg
    kernel = params["patch_kernel"]
    assert float(kernel.abs().max()) <= limit and \
        float(kernel.abs().max()) > 0.9 * limit
    qkv = params["blocks"]["attn"]["qkv_kernel"]
    assert float(qkv.abs().max()) <= 0.04 and abs(float(qkv.std()) - 0.0176) \
        < 2e-3  # N(0, 0.02) cut at 2 std: std 0.02 * 0.880
    assert float(params["cls_token"].abs().max()) == 0.0
    with torch.no_grad():
        logits = V.vit(params, cfg, torch.randn(2, IMAGE, IMAGE, 3))
    assert float(logits.abs().max()) == 0.0  # the zero head: all tie


def test_convert_checks_the_tree(weights):
    _, jparams, tmod, _ = weights
    tree = jax.device_get(jparams)
    check_vit_tree(tree, tmod.vit_cfg)
    with pytest.raises(ValueError, match="head_kernel: shape"):
        vit_params_from_jax(dict(tree, head_kernel=np.zeros((64, 3))),
                            tmod.vit_cfg)
    with pytest.raises(ValueError, match="missing leaves"):
        check_vit_tree({k: v for k, v in tree.items() if k != "pos_embed"},
                       tmod.vit_cfg)


def test_bf16_drift_is_bounded(weights):
    _, jparams, _, tparams = weights
    batch = _batches(1, seed=8)[0]
    cfg16 = dict(MODEL, dtype="bfloat16")
    j16 = np.asarray(jax.jit(lambda p, x: JClsModule(
        {"Model": cfg16}).model.apply({"params": p}, x))(
            jparams, batch["images"]).astype(jnp.float32))
    images = torch.from_numpy(batch["images"])
    with torch.no_grad():
        t16 = V.vit(tparams, GeneralClsModule({"Model": cfg16}).vit_cfg,
                    images)
        t32 = V.vit(tparams, GeneralClsModule({"Model": MODEL}).vit_cfg,
                    images)
    peak = float(t32.abs().max())
    assert t16.dtype == torch.bfloat16
    assert np.abs(t16.float().numpy() - j16).max() <= 2 ** -5 * peak
    assert float((t16.float() - t32).abs().max()) <= 2 ** -4 * peak


def test_drop_path_and_recompute():
    """DropPath keeps or zeroes whole samples (kept ones scaled by
    1 / keep); with DropPath and dropout on, recomputed blocks replay the
    forward's draws: loss and grads equal the run without recompute."""
    from fleetx_tpu_torch.models.gpt.model import dropout_rng

    x = torch.ones(64, 3, 5)
    out = V.drop_path(x, 0.25, False, dropout_rng(0, 0, 1, "cpu"))
    rows = out.reshape(64, -1)
    kept = (rows == 1 / 0.75).all(1)
    assert bool((kept | (rows == 0).all(1)).all()) and 0 < int(kept.sum()) < 64
    assert V.drop_path(x, 0.25, True, None) is x
    cfg = dict(MODEL, drop_path_rate=0.1)
    batch = _tb(_batches(1, seed=9)[0])
    out = []
    for remat in (False, True):
        mod = GeneralClsModule({"Model": dict(cfg, use_recompute=remat)})
        mod.vit_cfg.drop_rate = mod.vit_cfg.attn_drop_rate = 0.1
        params = mod.init_params(0, "cpu")
        leaves = [p.requires_grad_(True) for _, p in
                  tree_leaves_with_path(params)]
        loss, _ = mod.training_loss(params, batch, seed=1, step=2)
        out.append((loss, torch.autograd.grad(loss, leaves)))
    assert float(out[0][0].detach()) == float(out[1][0].detach())
    for a, b in zip(out[0][1], out[1][1]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-6)


# ------------------------------------------------------ fit and epochs
OPTIMIZER = {"name": "AdamW", "weight_decay": 0.3,
             "grad_clip": {"clip_norm": 1.0},
             "lr": {"name": "ViTLRScheduler", "learning_rate": 0.003,
                    "decay_type": "cosine", "warmup_steps": 2,
                    "total_steps": 20}}


def _cfg(**engine) -> dict:
    return {"Model": dict(MODEL),
            "Engine": dict({"max_steps": 100, "logging_freq": 1,
                            "eval_freq": 0}, **engine),
            "Global": {"seed": 7}, "Optimizer": OPTIMIZER}


def _port_engine(cfg: dict, init) -> EagerEngine:
    lr = TLR.build_lr_scheduler(OPTIMIZER["lr"])
    eng = EagerEngine(cfg, GeneralClsModule(cfg),
                      optimizer=TOPT.build_optimizer(OPTIMIZER, lr),
                      lr_schedule=lr, device="cpu")
    if init is not None:
        eng.params = vit_params_from_jax(init, eng.module.vit_cfg)
    return eng


@pytest.fixture(scope="module")
def jax_epochs(devices8):
    """The JAX engine in the epoch run mode, epoch_num 2 over 4 batches:
    its initial params and its 8 losses."""
    from fleetx_tpu.parallel.mesh import build_mesh

    cfg = _cfg(run_mode="epoch")
    batches = _batches(4, seed=10)
    lr = JLR.build_lr_scheduler(OPTIMIZER["lr"])
    eng = JEngine(cfg, JClsModule(cfg),
                  optimizer=JOPT.build_optimizer(OPTIMIZER, lr),
                  lr_schedule=lr, mesh=build_mesh({}, devices=devices8[:1]))
    eng.prepare(batches[0])
    init = jax.device_get(meta.unbox(eng.state.params))
    losses = eng.fit(batches, epoch_num=2)
    return batches, init, losses


def test_fit_matches_jax_engine(jax_epochs):
    """3 steps of the port's engine (step mode) against the first 3 of
    the JAX engine's, on the same batches and initial weights."""
    batches, init, j_losses = jax_epochs
    eng = _port_engine(_cfg(max_steps=3), init)
    t_losses = eng.fit(batches)
    assert len(t_losses) == 3
    np.testing.assert_allclose(t_losses, j_losses[:3], rtol=0, atol=1e-5)
    assert abs(j_losses[0] - np.log(CLASSES)) < 1e-5  # the zero head


def test_epoch_run_mode_counts_steps_and_resumes_the_epoch(jax_epochs,
                                                           tmp_path):
    """``run_mode: epoch`` with epoch_num 2 over 4 batches: 8 steps with
    JAX's losses, epochs 0 then 1 in the log, epoch 2 in the saved meta;
    an engine resumed from that checkpoint takes no step."""
    batches, init, j_losses = jax_epochs
    cfg = _cfg(run_mode="epoch", save_load={"output_dir": str(tmp_path)})
    eng = _port_engine(cfg, init)
    losses = eng.fit(batches, epoch_num=2)
    assert len(losses) == len(j_losses) == 8 and eng.step == 8
    np.testing.assert_allclose(losses, j_losses, rtol=0, atol=1e-5)
    assert [r["epoch"] for r in eng.history] == [0] * 4 + [1] * 4
    assert eng.epoch == 2
    eng.save()
    assert ckpt_lib.peek_meta(str(tmp_path))["epoch"] == 2
    resumed = _port_engine(dict(cfg, Engine=dict(cfg["Engine"], save_load={
        "output_dir": str(tmp_path), "ckpt_dir": str(tmp_path)})), None)
    assert resumed.fit(batches, epoch_num=2) == [] and resumed.step == 8
    assert resumed.epoch == 2
    more = _port_engine(dict(cfg, Engine=dict(cfg["Engine"], max_steps=9,
                                              save_load={
        "ckpt_dir": str(tmp_path)})), None)
    assert len(more.fit(batches, epoch_num=3)) == 1
    assert more.history[0]["epoch"] == 2


def test_train_cli_path_with_eval(tmp_path):
    """``tools.train``'s builder on the ViT-B/16 recipe shrunk (synthetic
    images): the zero head's first loss ln(classes), ``evaluate`` over
    the eval loader; the recipe's dp-16 global batch raises on one
    device."""
    cfg = T.load_config(VIT_YAML, TINY)
    engine, train_dl, valid_dl = T.build_trainer(cfg, device="cpu")
    assert isinstance(engine.module, GeneralClsModule)
    assert valid_dl is not None
    losses = engine.fit(train_dl, valid_dl)
    assert len(losses) == 2 and abs(losses[0] - np.log(CLASSES)) < 1e-5
    loss = engine.evaluate(valid_dl)
    assert np.isfinite(loss) and abs(loss - np.log(CLASSES)) < 0.1
    with pytest.raises(ValueError, match="global_batch_size 4096"):
        T.load_config(VIT_YAML)
