"""Port parity: the ERNIE family (``fleetx_tpu_torch/models/ernie/``,
``data/dataset/ernie_dataset.py``, ``convert.ernie_params_from_jax`` and
ERNIE through ``EagerEngine.fit`` and ``tools/train.py``).

The JAX parameters come from the JAX ``ErnieModule`` at a tiny config
(hidden 64, 2 layers, 4 heads of 16, seq 16, vocab 128, f32, dropout 0)
and pass through ``convert.ernie_params_from_jax``, so both sides run the
same weights on the same seeded numpy batches. Neither side reaches a
Pallas or hand-written kernel: ERNIE's attention and LayerNorms are plain
in both packages.

Tolerances: f32 logits, losses and every grad leaf within 1e-5 (atol; the
two sides sum the same f32 products in another order); the 3-step ``fit``
losses within 1e-5; the datasets bit for bit. bf16 drift: the port's bf16
logits against JAX's bf16 logits on the same weights within 2**-5 of the
largest f32 logit (both round at the same cast points, but a bf16 value
that lands on the other side of a rounding boundary moves by one bf16 ulp,
2**-8 relative, and two encoder layers and the tied head add a few such
steps), and the port's bf16 against its own f32 within 2**-4.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.core import meta

from fleetx_tpu.core.engine import EagerEngine as JEngine
from fleetx_tpu.data.dataset import ernie_dataset as JD
from fleetx_tpu.data.dataset.gpt_dataset import write_corpus
from fleetx_tpu.models.ernie import model as JE
from fleetx_tpu.models.ernie.module import ErnieModule as JErnieModule
from fleetx_tpu.optims import lr_scheduler as JLR
from fleetx_tpu.optims import optimizer as JOPT
from fleetx_tpu_torch.convert import check_ernie_tree, ernie_params_from_jax
from fleetx_tpu_torch.core.engine import EagerEngine
from fleetx_tpu_torch.data.dataset import ernie_dataset as TD
from fleetx_tpu_torch.models.ernie import model as E
from fleetx_tpu_torch.models.ernie.module import ErnieModule
from fleetx_tpu_torch.optims import lr_scheduler as TLR
from fleetx_tpu_torch.optims import optimizer as TOPT
from fleetx_tpu_torch.optims.optimizer import tree_leaves_with_path
from fleetx_tpu_torch.tools import train as T

pytestmark = pytest.mark.torch_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ERNIE_YAML = os.path.join(REPO, "fleetx_tpu", "configs", "nlp", "ernie",
                          "pretrain_ernie_345M.yaml")
VOCAB, SEQ, BATCH = 128, 16, 2
MODEL = dict(vocab_size=VOCAB, hidden_size=64, num_layers=2,
             num_attention_heads=4, max_position_embeddings=32,
             type_vocab_size=2, hidden_dropout_prob=0.0,
             attention_probs_dropout_prob=0.0, dtype="float32",
             param_dtype="float32")
TINY = ["Data.Train.dataset.name=SyntheticErnieDataset",
        "Data.Train.dataset.num_samples=64", "Engine.max_steps=2",
        "Engine.logging_freq=1", "Engine.save_load.save_steps=0",
        "Model.num_layers=2", "Model.hidden_size=64",
        "Model.num_attention_heads=4", f"Model.vocab_size={VOCAB}",
        f"Global.max_seq_len={SEQ}", "Model.max_position_embeddings=32",
        "Model.dtype=float32", "Global.local_batch_size=2",
        "Global.micro_batch_size=2"]


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
    """Seeded batches: random ids, two segments, ~30 % of positions
    labelled, and a padding mask with a ragged tail on row 0."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        labels = rng.randint(0, VOCAB, (batch, SEQ)).astype(np.int32)
        labels[rng.rand(batch, SEQ) > 0.3] = E.IGNORE_INDEX
        mask = np.ones((batch, SEQ), np.int32)
        mask[0, SEQ - 5:] = 0
        out.append({
            "input_ids": rng.randint(0, VOCAB, (batch, SEQ)).astype(np.int32),
            "token_type_ids": (np.arange(SEQ) >= SEQ // 2).astype(
                np.int32)[None].repeat(batch, 0),
            "attention_mask": mask,
            "mlm_labels": labels,
            "next_sentence_labels": rng.randint(0, 2, batch).astype(np.int32),
        })
    return out


def _tb(batch: dict) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


@pytest.fixture(scope="module")
def weights():
    """(jax module, unboxed jax params, port module, port params)."""
    jmod = JErnieModule({"Model": dict(MODEL)})
    jparams = meta.unbox(jmod.init_variables(jax.random.PRNGKey(0),
                                             _batches(1)[0]))
    tmod = ErnieModule({"Model": dict(MODEL)})
    tparams = ernie_params_from_jax(jax.device_get(jparams), tmod.model_cfg)
    return jmod, jparams, tmod, tparams


@pytest.fixture(scope="module")
def jax_forward(weights):
    """JAX logits for the forward cases, jitted once: ``mask`` with the
    padding mask of ``_batches`` plus a row whose keys are all masked;
    ``none`` without a mask."""
    jmod, jparams, _, _ = weights
    fwd = jax.jit(lambda p, ids, tt, am: jmod.model.apply(
        {"params": p}, ids, tt, None, am, deterministic=True))
    fwd_nomask = jax.jit(lambda p, ids, tt: jmod.model.apply(
        {"params": p}, ids, tt, deterministic=True))
    out = {}
    for case, batch in _forward_cases().items():
        if case == "none":
            got = fwd_nomask(jparams, batch["input_ids"],
                             batch["token_type_ids"])
        else:
            got = fwd(jparams, batch["input_ids"], batch["token_type_ids"],
                      batch["attention_mask"])
        out[case] = [np.asarray(x) for x in got]
    return out


def _forward_cases() -> dict:
    batch = _batches(1, seed=1, batch=3)[0]
    batch["attention_mask"][2] = 0  # every key of row 2 masked
    return {"mask": batch, "none": dict(batch, attention_mask=None)}


@pytest.mark.parametrize("case", ["mask", "none"])
def test_forward_logits_match_jax(weights, jax_forward, case):
    _, _, tmod, tparams = weights
    batch = _forward_cases()[case]
    mask = batch["attention_mask"]
    with torch.no_grad():
        mlm, nsp = E.ernie_for_pretraining(
            tparams, tmod.model_cfg, torch.from_numpy(batch["input_ids"]),
            torch.from_numpy(batch["token_type_ids"]), None,
            None if mask is None else torch.from_numpy(mask))
    want_mlm, want_nsp = jax_forward[case]
    np.testing.assert_allclose(mlm.numpy(), want_mlm, rtol=0, atol=1e-5)
    np.testing.assert_allclose(nsp.numpy(), want_nsp, rtol=0, atol=1e-5)


def test_a_row_with_every_key_masked_attends_uniformly(weights):
    """A row whose keys are all masked scores ``finfo.min`` everywhere: the
    f32 softmax comes out uniform, so the row's output is the mean of the
    values, as in JAX."""
    _, _, tmod, tparams = weights
    cfg = tmod.model_cfg
    x = torch.from_numpy(np.random.RandomState(3).randn(1, SEQ, 64).astype(
        np.float32))
    p = {k: v[0] for k, v in tparams["ernie"]["layers"]["attn"].items()}
    with torch.no_grad():
        out = E.self_attention(p, x, cfg, torch.zeros(1, SEQ),
                               deterministic=True, rng=None)
        v = (x @ p["qkv_kernel"].reshape(64, -1)).reshape(1, SEQ, 3, 4, 16)[
            :, :, 2] + p["qkv_bias"][2]
        want = v.mean(1, keepdim=True).reshape(1, 1, 64) @ \
            p["out_kernel"].reshape(64, 64) + p["out_bias"]
    np.testing.assert_allclose(out.numpy(), want.expand(1, SEQ, 64).numpy(),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("binary_head", [True, False])
def test_pretraining_criterion_matches_jax(binary_head):
    rng = np.random.RandomState(4)
    mlm = rng.randn(BATCH, SEQ, VOCAB).astype(np.float32)
    nsp = rng.randn(BATCH, 2).astype(np.float32)
    labels = _batches(1, seed=5)[0]["mlm_labels"]
    nsp_labels = np.array([1, 0], np.int32) if binary_head else None
    want = JE.pretraining_criterion(
        jnp.asarray(mlm), jnp.asarray(nsp), jnp.asarray(labels),
        None if nsp_labels is None else jnp.asarray(nsp_labels))
    got = E.pretraining_criterion(
        torch.from_numpy(mlm), torch.from_numpy(nsp),
        torch.from_numpy(labels),
        None if nsp_labels is None else torch.from_numpy(nsp_labels))
    for g, w in zip(got, want):
        assert abs(float(g) - float(w)) <= 1e-5
    if not binary_head:
        assert float(got[2]) == 0.0 and float(got[0]) == float(got[1])
    assert TD.IGNORE_INDEX == E.IGNORE_INDEX == JE.IGNORE_INDEX


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
    j_loss, j_grads = jax.jit(jax.value_and_grad(
        lambda p: jmod.training_loss(p, batch, jax.random.PRNGKey(3),
                                     jnp.int32(0))[0]))(jparams)
    leaves = [p.clone().requires_grad_(True)
              for _, p in tree_leaves_with_path(tparams)]
    params = _rebuild(tparams, leaves)
    loss, metrics = tmod.training_loss(params, _tb(batch), seed=3, step=0)
    grads = torch.autograd.grad(loss, leaves)
    assert abs(float(loss.detach()) - float(j_loss)) <= 1e-5
    assert set(metrics) == {"loss", "mlm_loss", "nsp_loss"}
    want = ernie_params_from_jax(jax.device_get(j_grads), tmod.model_cfg)
    for (path, w), g in zip(tree_leaves_with_path(want), grads):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-5,
                                   err_msg="/".join(path))


def test_decay_mask_matches_jax_leaf_for_leaf(weights):
    """The mask is a function of the path, so the trees must carry the
    same names: ``embed_ln/scale`` and ``mlm_ln/scale`` decay in JAX (no
    substring or exact name exempts them), and do here."""
    _, jparams, _, tparams = weights
    j_mask = jax.tree_util.tree_leaves(JOPT.decay_mask(jparams))
    j_paths = [tuple(k.key for k in path) for path, _ in
               jax.tree_util.tree_flatten_with_path(jparams)[0]]
    t_mask = dict(tree_leaves_with_path(TOPT.decay_mask(tparams)))
    assert dict(zip(j_paths, j_mask)) == t_mask
    assert t_mask[("ernie", "embed_ln", "scale")]
    assert t_mask[("mlm_ln", "scale")]
    assert not t_mask[("ernie", "layers", "ln1", "scale")]
    assert not t_mask[("mlm_bias",)]


def test_convert_checks_the_tree(weights):
    _, jparams, tmod, _ = weights
    tree = jax.device_get(jparams)
    check_ernie_tree(tree, tmod.model_cfg)
    bad = dict(tree, nsp_kernel=np.zeros((64, 3), np.float32))
    with pytest.raises(ValueError, match="nsp_kernel: shape"):
        ernie_params_from_jax(bad, tmod.model_cfg)
    extra = dict(tree, pooler=np.zeros(3))
    with pytest.raises(ValueError, match="unexpected leaves"):
        check_ernie_tree(extra, tmod.model_cfg)


def test_seeded_init_has_the_jax_layout_and_distribution():
    cfg = E.config_from_dict(MODEL)
    params = E.init_params(cfg, seed=0)
    check_ernie_tree(params, cfg)
    wte = params["ernie"]["word_embeddings"]
    assert abs(float(wte.std()) - 0.02) < 2e-3
    assert float(params["ernie"]["layers"]["ln1"]["scale"].min()) == 1.0
    assert float(params["mlm_bias"].abs().max()) == 0.0


def test_bf16_drift_is_bounded(weights):
    """The port's bf16 forward against JAX's bf16 forward and against its
    own f32 forward on the same weights (bounds in the module
    docstring)."""
    _, jparams, _, tparams = weights
    batch = _batches(1, seed=6)[0]
    bf16 = dict(MODEL, dtype="bfloat16")
    jmodel = JE.ErnieForPretraining(JE.config_from_dict(bf16))
    j_mlm, _ = jax.jit(lambda p: jmodel.apply(
        {"params": p}, batch["input_ids"], batch["token_type_ids"], None,
        batch["attention_mask"]))(jparams)
    tb = _tb(batch)
    with torch.no_grad():
        args = (tb["input_ids"], tb["token_type_ids"], None,
                tb["attention_mask"])
        t16, _ = E.ernie_for_pretraining(tparams, E.config_from_dict(bf16),
                                         *args)
        t32, _ = E.ernie_for_pretraining(tparams, E.config_from_dict(MODEL),
                                         *args)
    peak = float(t32.abs().max())
    assert t16.dtype == torch.bfloat16
    j16 = np.asarray(j_mlm.astype(jnp.float32))
    assert np.abs(t16.float().numpy() - j16).max() <= 2 ** -5 * peak
    assert float((t16.float() - t32).abs().max()) <= 2 ** -4 * peak


def test_recompute_replays_the_dropout_masks():
    """With dropout on, a recomputed layer draws the forward's masks:
    loss and grads equal the run without recompute."""
    cfg = dict(MODEL, hidden_dropout_prob=0.1,
               attention_probs_dropout_prob=0.1)
    batch = _tb(_batches(1, seed=7)[0])
    out = []
    for remat in (False, True):
        mod = ErnieModule({"Model": dict(cfg, use_recompute=remat)})
        params = mod.init_params(0, "cpu")
        leaves = [p.requires_grad_(True) for _, p in
                  tree_leaves_with_path(params)]
        loss, _ = mod.training_loss(params, batch, seed=1, step=2)
        out.append((loss, torch.autograd.grad(loss, leaves)))
    assert float(out[0][0].detach()) == float(out[1][0].detach())
    for a, b in zip(out[0][1], out[1][1]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-6)


# ------------------------------------------------------------ datasets
def test_mlm_mask_and_datasets_bit_for_bit(tmp_path):
    rng = np.random.RandomState(0)
    tokens = rng.randint(4, 1000, size=(4, 64)).astype(np.int64)
    for special in ((), (1, 2)):
        got = TD.apply_mlm_mask(tokens, np.random.RandomState(1),
                                vocab_size=1000, mask_id=3,
                                special_ids=special)
        want = JD.apply_mlm_mask(tokens, np.random.RandomState(1),
                                 vocab_size=1000, mask_id=3,
                                 special_ids=special)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    docs = [list(rng.randint(4, 500, size=rng.randint(10, 80)))
            for _ in range(6)]
    prefix = str(tmp_path / "corpus")
    write_corpus(prefix, docs)
    pairs = [(TD.ErnieDataset(prefix, num_samples=16, seq_length=32,
                              vocab_size=500, seed=9),
              JD.ErnieDataset(prefix, num_samples=16, seq_length=32,
                              vocab_size=500, seed=9)),
             (TD.SyntheticErnieDataset(num_samples=16, seq_length=32,
                                       vocab_size=500),
              JD.SyntheticErnieDataset(num_samples=16, seq_length=32,
                                       vocab_size=500))]
    for t_ds, j_ds in pairs:
        assert len(t_ds) == len(j_ds) == 16
        for i in range(16):
            got, want = t_ds[i], j_ds[i]
            assert sorted(got) == sorted(want)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
                assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype
    labels = [pairs[0][0][i]["next_sentence_labels"] for i in range(16)]
    assert 0 < sum(labels) < 16  # both NSP classes drawn


# --------------------------------------------------------------- the fit
OPTIMIZER = {"name": "FusedAdamW", "weight_decay": 0.01,
             "grad_clip": {"clip_norm": 1.0},
             "lr": {"name": "CosineAnnealingWithWarmupDecay",
                    "max_lr": 1e-3, "min_lr": 1e-4, "warmup_steps": 1,
                    "decay_steps": 100}}


def test_fit_matches_jax_engine(devices8):
    """3 steps of the port's engine against the JAX engine on the same
    batches and initial weights (dropout 0)."""
    from fleetx_tpu.parallel.mesh import build_mesh

    n = 3
    cfg = {"Model": dict(MODEL, module="ErnieModule"),
           "Engine": {"max_steps": n, "logging_freq": 1, "eval_freq": 0},
           "Global": {"seed": 7}, "Optimizer": OPTIMIZER}
    batches = _batches(n, seed=8)
    j_lr = JLR.build_lr_scheduler(OPTIMIZER["lr"])
    j_eng = JEngine(cfg, JErnieModule(cfg),
                    optimizer=JOPT.build_optimizer(OPTIMIZER, j_lr),
                    lr_schedule=j_lr,
                    mesh=build_mesh({}, devices=devices8[:1]))
    j_eng.prepare(batches[0])
    init = jax.device_get(meta.unbox(j_eng.state.params))
    j_losses = j_eng.fit(batches)

    lr = TLR.build_lr_scheduler(OPTIMIZER["lr"])
    t_eng = EagerEngine(cfg, ErnieModule(cfg),
                        optimizer=TOPT.build_optimizer(OPTIMIZER, lr),
                        lr_schedule=lr, device="cpu")
    t_eng.params = ernie_params_from_jax(init, t_eng.module.model_cfg)
    t_losses = t_eng.fit(batches)
    assert len(j_losses) == len(t_losses) == n
    np.testing.assert_allclose(t_losses, j_losses, rtol=0, atol=1e-5)
    assert [r["global_step"] for r in t_eng.history] == [1, 2, 3]


def test_train_cli_path_and_eval_engine(tmp_path):
    """``tools.train``'s builder on the ERNIE 345M recipe shrunk (synthetic
    data): the first loss near ln(vocab) + ln 2, a checkpoint the eval
    engine loads through the module's own tree check; the dp 8 recipe
    raises naming its item."""
    cfg = T.load_config(ERNIE_YAML, TINY + [
        "Engine.save_load.save_steps=2",
        f"Engine.save_load.output_dir={tmp_path}"])
    engine, train_dl, valid_dl = T.build_trainer(cfg, device="cpu")
    assert isinstance(engine.module, ErnieModule) and valid_dl is None
    losses = engine.fit(train_dl)
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert abs(losses[0] - (np.log(VOCAB) + np.log(2))) < 0.1
    ev = EagerEngine(dict(cfg, Engine=dict(cfg["Engine"], save_load={
        "ckpt_dir": str(tmp_path)})), ErnieModule(cfg), mode="eval",
        device="cpu")
    params = ev.prepare()
    for (_, a), (_, b) in zip(tree_leaves_with_path(params),
                              tree_leaves_with_path(engine.params)):
        assert torch.equal(a, b.detach())
    # the dp8 recipe is a gang's: eight ranks load it, one rank does not
    dp8 = ERNIE_YAML.replace("345M.yaml", "345M_dp8.yaml")
    assert T.load_config(dp8, world_size=8)["Distributed"]["dp_degree"] == 8
    with pytest.raises(ValueError, match="device count"):
        T.load_config(dp8)
