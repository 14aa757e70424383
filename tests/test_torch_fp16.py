"""Port parity: fp16 training under the dynamic loss scaler
(``utils/config.loss_scaler``, ``EagerEngine.train_step``'s scaler and
non-finite skip, ``AdamW``'s folded unscale, the scaler's checkpoint
leaves).

The engines train the tiny GPT of ``tests/test_engine.py`` (hidden 64, 2
layers, 4 heads, seq 32, vocab 128, batch 8, dropout 0) with
``Model.dtype: float16`` and ``use_pure_fp16`` from the same initial
weights (the JAX engine's, converted) on the same numpy batches.

Tolerances: the scale trajectory, the finite flags and the step counts
are equal. fp16 losses agree with the JAX engine's within 2e-4 absolute:
the logits are fp16, and a logit of magnitude ~0.5 rounds to within
2**-11 x 0.5 = 2.4e-4 of its value, so a token's loss can move by ~5e-4
when the two libraries round a sum differently; the loss is the f32 mean
over 256 tokens, whose rounding errors are independent, which leaves
~3e-5 (measured: at most 2.6e-5 over three seeds). The
overflow drill is ``tests/test_engine.py``'s, exactly: the step frozen
at 0, the scale halved once a batch, the params bit for bit the initial
ones.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
from flax.core import meta

from fleetx_tpu.parallel.mesh import build_mesh
from fleetx_tpu_torch.convert import params_from_jax
from fleetx_tpu_torch.core import checkpoint as C
from fleetx_tpu_torch.core.engine import EagerEngine
from fleetx_tpu_torch.core.engine import eager_engine as E
from fleetx_tpu_torch.core.module import GPTModule
from fleetx_tpu_torch.ops import flash_attention as FA
from fleetx_tpu_torch.ops import fused_norm as FN
from fleetx_tpu_torch.optims import lr_scheduler as TLR
from fleetx_tpu_torch.optims import optimizer as TOPT
from fleetx_tpu_torch.optims.optimizer import tree_leaves_with_path
from fleetx_tpu_torch.utils.config import loss_scaler

from test_engine import build_engine, make_batches, tiny_cfg

pytestmark = pytest.mark.torch_port


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """This file's tensors are tiny: torch runs them on one intra-op
    thread, and its default pool (one thread a core, on cores the other
    test workers share) costs ~50x on a ``[256, 64] @ [64, 192]`` matmul.
    The count is restored for the files after it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = {"name": "cosine", "max_lr": 1e-3, "min_lr": 1e-4, "warmup_steps": 2,
      "decay_steps": 100}
OPT = {"name": "AdamW", "weight_decay": 0.01,
       "grad_clip": {"clip_norm": 1.0}}
FP16_LOSS_ATOL = 2e-4


def _fp16_cfg(scale: float, max_steps: int = 5) -> dict:
    cfg = tiny_cfg(dtype="float16")
    cfg["Engine"]["max_steps"] = max_steps
    cfg["Engine"]["mix_precision"] = {"use_pure_fp16": True,
                                      "scale_loss": scale}
    return cfg


def _port_engine(cfg, params=None):
    lr = TLR.build_lr_scheduler(LR)
    eng = EagerEngine(cfg, GPTModule(cfg),
                      optimizer=TOPT.build_optimizer(OPT, lr),
                      lr_schedule=lr, device="cpu")
    if params is not None:
        eng.params = params_from_jax(params, eng.module.model_cfg)
    return eng


def _params(eng) -> list:
    return [p.detach().clone() for _, p in tree_leaves_with_path(eng.params)]


@pytest.mark.parametrize("mix, dtype, want", [
    ({"use_pure_fp16": True, "scale_loss": 1024.0}, "float16", 1024.0),
    ({"use_pure_fp16": True}, "float16", 32768.0),
    ({"use_pure_fp16": False}, "float16", None),
    ({"use_pure_fp16": True}, "bfloat16", None),
    ({}, "float32", None)])
def test_the_scaler_switch_follows_the_jax_engine(mix, dtype, want):
    """On only with ``use_pure_fp16`` AND ``Model.dtype: float16``
    (``fleetx_tpu/core/engine/eager_engine.py:211-214``); fp16 without it
    trains with no scaler and no per-step check."""
    cfg = {"Engine": {"mix_precision": mix}, "Model": {"dtype": dtype}}
    assert loss_scaler(cfg) == want
    eng_cfg = tiny_cfg(dtype=dtype)
    eng_cfg["Engine"]["mix_precision"] = mix
    eng = _port_engine(eng_cfg)
    assert (eng.scaler is not None) == (want is not None)
    assert eng.check_finite == (want is not None)
    if want is not None:
        assert eng.scaler["loss_scale"].dtype == np.float32
        assert float(eng.scaler["loss_scale"]) == want
        assert eng.scaler["growth_tracker"].dtype == np.int32


def test_scale_growth_and_backoff_rule():
    """x2 after ``GROWTH_INTERVAL`` finite steps in a row (the tracker
    back to 0), x0.5 and the tracker reset on a non-finite step, in f32
    (2**127 doubles to inf, as the JAX ``jnp.where`` update does)."""
    eng = _port_engine(_fp16_cfg(1024.0))
    eng.scaler["growth_tracker"] = np.int32(E.GROWTH_INTERVAL - 2)
    eng._update_scaler(True)
    assert (eng.scaler["loss_scale"], eng.scaler["growth_tracker"]) == \
        (1024.0, E.GROWTH_INTERVAL - 1)
    eng._update_scaler(True)
    assert (eng.scaler["loss_scale"], eng.scaler["growth_tracker"]) == \
        (2048.0, 0)
    eng.scaler["growth_tracker"] = np.int32(17)
    eng._update_scaler(False)
    assert (eng.scaler["loss_scale"], eng.scaler["growth_tracker"]) == \
        (1024.0, 0)
    eng.scaler = {"loss_scale": np.float32(2.0 ** 127),
                  "growth_tracker": np.int32(E.GROWTH_INTERVAL - 1)}
    with np.errstate(over="ignore"):
        eng._update_scaler(True)
    assert np.isinf(eng.scaler["loss_scale"])
    assert eng.scaler["loss_scale"].dtype == np.float32


def test_the_unscale_folded_into_adamw_equals_unscaled_grads():
    """Grads of a loss scaled by 2**15, unscaled in AdamW's leaf loop,
    update the params bit for bit as the unscaled grads do, and the norm
    is the unscaled grads' norm."""
    gen = torch.Generator().manual_seed(0)
    shapes = [(16, 8), (8,), (4, 4, 2)]
    results = []
    for scale in (1.0, 2.0 ** 15):
        params = [torch.randn(s, generator=torch.Generator().manual_seed(i))
                  for i, s in enumerate(shapes)]
        opt = TOPT.build_optimizer(OPT, TLR.build_lr_scheduler(LR))
        state = opt.init({f"w{i}": p for i, p in enumerate(params)})
        norms = []
        for step in range(3):
            grads = [torch.randn(s, generator=gen) * (50.0 if step == 0
                                                      else 0.1)
                     for s in shapes]
            norms.append(float(opt.grad_norm(grads)))
            scaled = [g * scale for g in grads]
            got = opt.update(params, scaled, state, grad_scale=1.0 / scale)
            assert float(got) == norms[-1]
        results.append(params)
        gen.manual_seed(0)
    for a, b in zip(*results):
        assert torch.equal(a, b)


def test_fp16_model_reaches_the_tensor_core_kernels_and_the_half_norm(
        monkeypatch):
    """At head_dim 64 and hidden 128 the fp16 model hands the flash and
    fused-norm wrappers fp16 operands (the tensor-core route and the
    ``__half`` norm on the card), never a cast to f32."""
    seen = []
    for mod, name in ((FA, "fwd_call"), (FA, "bwd_call"), (FN, "fwd_call"),
                      (FN, "bwd_call")):
        fn = getattr(mod, name)

        def spy(*args, _fn=fn, _name=f"{mod.__name__}.{name}", **kw):
            seen.append((_name, args[0].dtype))
            return _fn(*args, **kw)

        monkeypatch.setattr(mod, name, spy)
    cfg = {"Model": dict(vocab_size=256, hidden_size=128, num_layers=2,
                         num_attention_heads=2, max_position_embeddings=128,
                         hidden_dropout_prob=0.1,
                         attention_probs_dropout_prob=0.1, dtype="float16"),
           "Engine": {"max_steps": 1, "logging_freq": 1,
                      "mix_precision": {"use_pure_fp16": True}},
           "Global": {"seed": 3}}
    eng = _port_engine(cfg)
    rng = np.random.RandomState(0)
    batch = {"tokens": rng.randint(0, 256, (2, 128)).astype(np.int64),
             "position_ids": np.tile(np.arange(128), (2, 1)),
             "labels": rng.randint(0, 256, (2, 128)).astype(np.int64),
             "loss_mask": np.ones((2, 128), np.float32)}
    losses = eng.fit([batch])
    assert np.isfinite(losses).all() and eng.step == 1
    assert FA.tc_route(torch.float16, 64)
    counts = {}
    for name, dtype in seen:
        assert dtype == torch.float16, (name, dtype)
        counts[name] = counts.get(name, 0) + 1
    fa, fn = FA.__name__, FN.__name__
    # 2 layers: a forward and a fused backward each; 2 x 2 + 1 norms
    assert counts == {f"{fa}.fwd_call": 2, f"{fa}.bwd_call": 2,
                      f"{fn}.fwd_call": 5, f"{fn}.bwd_call": 5}


def test_fp16_losses_and_loss_scale_match_the_jax_engine(devices8):
    """5 fp16 steps at ``scale_loss`` 32768: the same scale, finite flag
    and step after every batch, and losses within ``FP16_LOSS_ATOL``."""
    batches = make_batches(5, seed=11)
    j_eng = build_engine(_fp16_cfg(32768.0),
                         build_mesh({}, devices=devices8[:1]))
    j_eng.prepare(batches[0])
    init = jax.device_get(meta.unbox(j_eng.state.params))
    want = []
    for b in batches:
        j_eng.state, m = j_eng._train_step(j_eng.state,
                                            j_eng.shard_batch(b))
        m = jax.device_get(m)
        want.append((float(m["loss"]), float(m["loss_scale"]),
                     bool(m["finite"]), int(m["opt_step"])))
    eng = _port_engine(_fp16_cfg(32768.0), init)
    eng.fit(iter(batches))
    got = [(h["loss"], h["loss_scale"], h["global_step"])
           for h in eng.history]
    assert [g[1:] for g in got] == [(w[1], w[3]) for w in want]
    assert all(w[2] for w in want) and eng.step == 5
    np.testing.assert_allclose([g[0] for g in got], [w[0] for w in want],
                               rtol=0, atol=FP16_LOSS_ATOL)


def test_fp16_overflow_skips_steps_and_backs_off_the_scale():
    """``tests/test_engine.py``'s drill: an absurd initial scale overflows
    every scaled backward of a one-shot pass: the step stays 0, the scale
    halves once a batch and the params are bit for bit the initial ones;
    a second engine over a re-iterable loader reaches ``max_steps``
    optimizer steps as the scale falls into range."""
    eng = _port_engine(_fp16_cfg(2.0 ** 125, max_steps=10))
    batches = make_batches(10)
    eng.prepare()
    init = _params(eng)
    assert float(eng.scaler["loss_scale"]) == 2.0 ** 125
    eng.fit(iter(batches))
    assert eng.step == 0 and eng.opt_state["count"] == 0
    assert float(eng.scaler["loss_scale"]) == 2.0 ** 115
    assert all(torch.equal(a, b) for a, b in zip(init, _params(eng)))
    assert all(h["global_step"] == 0 for h in eng.history)
    assert len(eng.history) == 10

    eng2 = _port_engine(_fp16_cfg(2.0 ** 125, max_steps=5))
    eng2.fit(batches)
    assert eng2.step == 5
    assert float(eng2.scaler["loss_scale"]) < 2.0 ** 125
    assert all(torch.isfinite(p).all() for p in _params(eng2))


def test_fp16_checkpoint_round_trip_keeps_the_scaler_leaves(tmp_path):
    """The scaler's two leaves are saved as ``scaler/loss_scale`` (f32)
    and ``scaler/growth_tracker`` (i32) and restored bit for bit; the
    resumed run equals the uninterrupted one; the JAX package's auditor
    reads the checkpoint. The initial scale 2**20 overflows the first
    backward(s), so the saved scale and tracker are not the initial
    ones."""
    batches = make_batches(20, seed=2)
    full = _port_engine(_fp16_cfg(2.0 ** 20, max_steps=6))
    full_losses = full.fit(list(batches))
    out = str(tmp_path / "ckpt")
    cfg = _fp16_cfg(2.0 ** 20, max_steps=3)
    cfg["Engine"]["save_load"] = {"output_dir": out, "save_steps": 3}
    first = _port_engine(cfg)
    first.fit(list(batches))
    taken = len(first.history)  # batches consumed, skipped ones included
    saved = dict(first.scaler)
    assert float(saved["loss_scale"]) < 2.0 ** 20 and taken > 3
    assert int(saved["growth_tracker"]) == 3
    assert C.latest_step(out) == 3
    state, _ = C.load_checkpoint(out, 3)
    assert state["scaler/loss_scale"].dtype == torch.float32
    assert state["scaler/growth_tracker"].dtype == torch.int32
    assert state["scaler/loss_scale"].shape == ()
    cfg2 = _fp16_cfg(2.0 ** 20, max_steps=6)
    cfg2["Engine"]["save_load"] = {"ckpt_dir": out}
    resumed = _port_engine(cfg2)
    resumed.prepare()
    assert resumed.scaler == saved and resumed.step == 3
    rest = resumed.fit(list(batches[taken:]))
    assert rest == full_losses[taken:]
    assert resumed.scaler == full.scaler and resumed.step == full.step == 6
    assert all(torch.equal(a, b)
               for a, b in zip(_params(resumed), _params(full)))
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    audit = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "verify_ckpt.py"), out,
         "--json", "-"], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=120)
    assert audit.returncode == 0, audit.stderr[-2000:]
    report = json.loads(audit.stdout)
    assert {s["status"] for s in report["steps"]} == {"ok"}
