"""Port parity: quantization-aware training (``Quantization.enable`` with
``weight_bits`` / ``activation_bits``): the four fake-quant sites of the
GPT forward and the block's mapping onto ``qat_bits`` / ``qat_act_bits``.

The same numpy batches and converted weights go through the JAX package
(``GPTModule`` with a ``Quantization`` block; the Pallas kernels off,
since interpret mode costs seconds a call on the CPU) and the port on
CPU tensors (the kernels' plain versions).

Fake-quant is a step function. The two libraries' pre-quant activations
differ by float32 ulps (LayerNorm, softmax and the matmuls sum in another
order), and an element that lies within an ulp of a rounding boundary
moves by a whole quantization step on one side only; about one element a
site does at these shapes, and the step then spreads through the layers
above it. So the checks are split:

- each site, on the activations and weights the JAX forward feeds it,
  gives bit for bit what eager JAX's ``fake_quant`` gives at the same
  site (the same order, bits and scales: the port reduces a kernel over
  axis 0 after its reshape to 2-D, JAX over the leading axes before it);
- the whole model, with the port's activation sites fed JAX's quantized
  activations (``_forced``; the port's own pre-quant input checked
  against JAX's within 1e-5 first, and the weights quantized by the port
  itself; in the ``fit`` curve the weight sites are fed JAX's too, since
  after an update the two sides' weights differ by ulps and a weight
  near a boundary flips like an activation): loss atol 1e-5, every grad
  leaf atol 1e-5 with rtol 1e-4
  (``tests/test_torch_train.py``'s bounds), the cached forward's logits
  atol 1e-5 (``tests/test_torch_generation.py``'s), the 3-step ``fit``
  curve against the JAX engine atol 1e-5 (``tests/test_torch_corpus.py``'s).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.core import meta

import fleetx_tpu.ops.quantization as JQ
from fleetx_tpu.core.module import GPTModule as JGPTModule
from fleetx_tpu.models.gpt.model import GPTForPretraining
from fleetx_tpu.models.gpt.model import init_cache as j_init_cache
from fleetx_tpu_torch.convert import params_from_jax
from fleetx_tpu_torch.core.module import GPTModule
from fleetx_tpu_torch.models.gpt import model as M
from fleetx_tpu_torch.optims.optimizer import tree_leaves_with_path

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

VOCAB, SEQ, BATCH = 256, 128, 2
MODEL = dict(vocab_size=VOCAB, hidden_size=128, num_layers=2,
             num_attention_heads=2, max_position_embeddings=SEQ,
             hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
             use_flash_attention=True, flash_fused_bwd=True,
             fused_residual_norm=True, dtype="float32",
             param_dtype="float32")
PLAIN = dict(MODEL, use_flash_attention=False, fused_residual_norm=False)
#: (weight_bits, activation_bits): the recipe's widths, and weights at 4
#: bits, which shows that each width is mapped on its own
BITS = {"w8a8": (8, 8), "w4a8": (4, 8)}
#: fake-quant calls per forward: 8 sites in each of 2 layers
SITES = 16


def _quant(bits) -> dict:
    return {"enable": True, "weight_bits": bits[0],
            "activation_bits": bits[1]}


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


def _record_jax(monkeypatch) -> list:
    """Every JAX ``fake_quant`` call from now on appends ``(x, q, bits,
    axis)`` in program order (an ordered debug callback, so jitted and
    scanned code records too). The JAX model imports ``fake_quant`` at
    trace time, so the patch reaches it."""
    calls, orig = [], JQ.fake_quant

    def recording(x, bits=8, axis=None):
        q = orig(x, bits, axis)
        jax.debug.callback(lambda a, b: calls.append(
            (np.asarray(a), np.asarray(b), bits, axis)), x, q, ordered=True)
        return q

    monkeypatch.setattr(JQ, "fake_quant", recording)
    return calls


def _forced(monkeypatch, jax_calls: list, weights: bool = False) -> None:
    """The port's activation sites (``axis`` None), and with ``weights``
    its weight sites too, return in order what JAX's sites made, after
    checking that the port's own pre-quant input is JAX's within 1e-5 (the
    straight-through form ``x + (q - x).detach()`` keeps the gradient);
    the other sites quantize as they do."""
    calls = iter([c for c in jax_calls if weights or c[3] is None])
    orig = M.fake_quant

    def forced(x, bits=8, axis=None):
        if axis is not None and not weights:
            return orig(x, bits, axis)
        jx, jq, jbits, jaxis = next(calls)
        assert jbits == bits and (jaxis is None) == (axis is None)
        np.testing.assert_allclose(x.detach().numpy(), jx.reshape(x.shape),
                                   rtol=0, atol=1e-5)
        q = torch.from_numpy(jq.reshape(x.shape).copy())
        return x + (q - x).detach()

    monkeypatch.setattr(M, "fake_quant", forced)


@pytest.fixture(scope="module")
def weights():
    """(unboxed JAX params, the same as the port's tree)."""
    jparams = meta.unbox(JGPTModule({"Model": dict(PLAIN)}).init_variables(
        jax.random.PRNGKey(0), _batches(1)[0]))
    return jparams, params_from_jax(jax.device_get(jparams),
                                    M.config_from_dict(dict(MODEL)))


@pytest.fixture(scope="module", params=sorted(BITS))
def jax_run(request, weights):
    """One JAX loss+grad per width: ``(bits, loss, grads, the fake-quant
    calls of its forward)``."""
    jparams, _ = weights
    mp = pytest.MonkeyPatch()
    calls = _record_jax(mp)
    jmod = JGPTModule({"Model": dict(PLAIN),
                       "Quantization": _quant(BITS[request.param])})
    batch = _batches(1, seed=2)[0]
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jmod.training_loss(p, batch, jax.random.PRNGKey(3),
                                     jnp.int32(0))[0]))(jparams)
    jax.effects_barrier()
    mp.undo()
    assert len(calls) == SITES
    return request.param, float(loss), grads, calls


def _port_loss_and_grads(tparams, quant: dict):
    tmod = GPTModule({"Model": dict(MODEL), "Quantization": quant})
    assert tmod.model_cfg.use_qat
    leaves = [p.clone().requires_grad_(True)
              for _, p in tree_leaves_with_path(tparams)]
    loss, _ = tmod.training_loss(_rebuild(tparams, leaves),
                                 _tb(_batches(1, seed=2)[0]), seed=3, step=0)
    return loss, torch.autograd.grad(loss, leaves), tmod.model_cfg


def test_the_block_maps_each_width_only_where_it_is_set():
    """``Quantization`` → ``use_qat``, ``qat_bits``, ``qat_act_bits``, as
    the JAX module maps it; an unset width keeps the default."""
    for quant in ({"enable": True}, _quant((4, 8)), _quant((8, 4)),
                  {"enable": True, "activation_bits": 6}, {"enable": False,
                                                           "weight_bits": 4}):
        cfg = {"Model": dict(MODEL), "Quantization": quant}
        got, want = GPTModule(cfg).model_cfg, JGPTModule(cfg).model_cfg
        assert (got.use_qat, got.qat_bits, got.qat_act_bits) == (
            want.use_qat, want.qat_bits, want.qat_act_bits), quant


def test_each_site_is_jax_fake_quant_bit_for_bit(jax_run, weights,
                                                 monkeypatch):
    """The port's forward calls ``fake_quant`` at JAX's sites, in JAX's
    order, with its bits; fed the input JAX's site got, each gives what
    eager JAX's ``fake_quant`` gives there, bit for bit."""
    bits, _, _, jcalls = jax_run
    _, tparams = weights
    tcalls, orig = [], M.fake_quant

    def recording(x, nbits=8, axis=None):
        tcalls.append((tuple(x.shape), nbits, axis))
        return orig(x, nbits, axis)

    monkeypatch.setattr(M, "fake_quant", recording)
    _port_loss_and_grads(tparams, _quant(BITS[bits]))
    assert len(tcalls) == len(jcalls) == SITES
    for i, ((shape, nbits, axis), (jx, _, jbits, jaxis)) in enumerate(
            zip(tcalls, jcalls)):
        assert nbits == jbits and (axis is None) == (jaxis is None), i
        got = orig(torch.from_numpy(jx.reshape(shape).copy()), nbits, axis)
        want = np.asarray(JQ.fake_quant(jnp.asarray(jx), jbits, jaxis))
        np.testing.assert_array_equal(got.numpy(), want.reshape(shape),
                                      err_msg=f"site {i}")


def test_loss_and_grads_match_jax(jax_run, weights, monkeypatch):
    bits, j_loss, j_grads, jcalls = jax_run
    _, tparams = weights
    with torch.no_grad():
        plain = GPTModule({"Model": dict(MODEL)}).training_loss(
            tparams, _tb(_batches(1, seed=2)[0]), seed=3, step=0)[0]
    _forced(monkeypatch, jcalls)
    loss, grads, tcfg = _port_loss_and_grads(tparams, _quant(BITS[bits]))
    assert abs(float(loss.detach()) - j_loss) <= 1e-5
    # QAT moves the loss: the fake-quant sites are on the path
    assert abs(float(plain) - float(loss.detach())) > 1e-5
    want = params_from_jax(jax.device_get(j_grads), tcfg)
    for (path, w), g in zip(tree_leaves_with_path(want), grads):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg="/".join(path))


def test_cached_forward_matches_jax(weights, monkeypatch):
    """QAT applies to the cached (generation) forward too, as the JAX
    sites have no guard on the cache: a prefill and two decode steps."""
    jparams, tparams = weights
    quant = _quant(BITS["w4a8"])
    jcfg = JGPTModule({"Model": dict(PLAIN), "Quantization": quant}).model_cfg
    tcfg = GPTModule({"Model": dict(MODEL), "Quantization": quant}).model_cfg
    jmodel = GPTForPretraining(jcfg)
    rng = np.random.RandomState(5)
    b, plen = 2, 12
    calls = [rng.randint(0, VOCAB, (b, plen)).astype(np.int32)] + [
        rng.randint(0, VOCAB, (b, 1)).astype(np.int32) for _ in range(2)]
    jcache = j_init_cache(jcfg, b, plen + 2)
    tcache = M.init_cache(tcfg, b, plen + 2)
    for step, tokens in enumerate(calls):
        jq = _record_jax(monkeypatch)
        apply = jax.jit(jmodel.apply, static_argnames=("deterministic",))
        j_logits, jcache = apply({"params": jparams}, jnp.asarray(tokens),
                                 None, cache=jcache, deterministic=True)
        jax.effects_barrier()
        assert len(jq) == SITES
        _forced(monkeypatch, jq)
        with torch.no_grad():
            t_logits, tcache = M.gpt_for_pretraining(
                tparams, tcfg, torch.from_numpy(tokens).long(), cache=tcache)
        monkeypatch.undo()
        np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                                   rtol=0, atol=1e-5, err_msg=f"call {step}")
    np.testing.assert_allclose(tcache.key.numpy(), np.asarray(jcache.key),
                               rtol=0, atol=1e-5)


def test_fit_loss_curve_matches_jax_engine(devices8, monkeypatch):
    """Three QAT steps of the port's engine against the JAX engine's on
    the same batches and initial weights."""
    from fleetx_tpu.core.engine import EagerEngine as JEngine
    from fleetx_tpu.optims import lr_scheduler as JLR
    from fleetx_tpu.optims import optimizer as JOPT
    from fleetx_tpu.parallel.mesh import build_mesh
    from fleetx_tpu_torch.core.engine import EagerEngine
    from fleetx_tpu_torch.optims import lr_scheduler as TLR
    from fleetx_tpu_torch.optims import optimizer as TOPT

    n = 3
    cfg = {"Model": dict(MODEL), "Quantization": _quant(BITS["w8a8"]),
           "Engine": {"max_steps": n, "logging_freq": 1, "eval_freq": 0},
           "Global": {"seed": 7},
           "Optimizer": {"name": "AdamW", "grad_clip": {"clip_norm": 1.0},
                         "lr": {"max_lr": 1e-3, "warmup_steps": 2,
                                "decay_steps": 100}}}
    j_cfg = dict(cfg, Model=dict(PLAIN))
    batches = _batches(n, seed=4)
    j_lr = JLR.build_lr_scheduler(cfg["Optimizer"]["lr"])
    jq = _record_jax(monkeypatch)
    j_eng = JEngine(j_cfg, JGPTModule(j_cfg),
                    optimizer=JOPT.build_optimizer(cfg["Optimizer"], j_lr),
                    lr_schedule=j_lr,
                    mesh=build_mesh({}, devices=devices8[:1]))
    j_eng.max_steps = n
    j_eng.prepare(batches[0])
    init = jax.device_get(meta.unbox(j_eng.state.params))
    jax.effects_barrier()
    del jq[:]  # the init's forward
    j_losses = j_eng.fit(batches)
    jax.effects_barrier()
    assert len(jq) == n * SITES

    _forced(monkeypatch, jq, weights=True)
    lr = TLR.build_lr_scheduler(cfg["Optimizer"]["lr"])
    t_eng = EagerEngine(cfg, GPTModule(cfg),
                        optimizer=TOPT.build_optimizer(cfg["Optimizer"], lr),
                        lr_schedule=lr, device="cpu")
    assert t_eng.module.model_cfg.use_qat
    t_eng.params = params_from_jax(init, t_eng.module.model_cfg)
    t_losses = t_eng.fit(batches)
    assert len(t_losses) == len(j_losses) == n
    np.testing.assert_allclose(t_losses, j_losses, rtol=0, atol=1e-5)
