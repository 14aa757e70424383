"""Port parity: recompute and the chunked LM head, the two model knobs
of the long-context recipe (``pretrain_gpt_1.3B_seq8k_ring.yaml``) beside
its ring path (``tests/test_torch_ring_attention.py``); the recipe as a
whole is ``tests/test_torch_seq8k.py``.

The same numpy inputs and converted weights go through the JAX package
(``GPTModule``, ``chunked_cross_entropy_per_token``) and the port on CPU
tensors (the kernels' plain versions).

Tolerances (f32): recompute on against off (``full``, ``full_attn``,
``core_attn`` and ``dots``), with hidden and attention dropout 0.1, loss
and every grad leaf within 1e-6 (the same ops on the
same masks; only the recomputation differs). Against JAX: loss atol 1e-5,
grads atol 1e-5 / rtol 1e-4 (``tests/test_torch_train.py``'s bounds);
the chunked head's per-token losses and grads atol 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.core import meta

from fleetx_tpu.core.module import GPTModule as JGPTModule
from fleetx_tpu.models.gpt import model as JM
from fleetx_tpu_torch import convert
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

VOCAB, SEQ = 256, 128
MODEL = dict(vocab_size=VOCAB, hidden_size=128, num_layers=2,
             num_attention_heads=2, max_position_embeddings=SEQ,
             hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
             use_flash_attention=True, flash_fused_bwd=True,
             fused_residual_norm=True, dtype="float32",
             param_dtype="float32")
PLAIN = dict(MODEL, use_flash_attention=False, fused_residual_norm=False)
GRANULARITIES = ("full", "full_attn", "core_attn", "dots")


def _batch(seed: int, batch: int = 2, seq: int = SEQ,
           vocab: int = VOCAB) -> dict:
    rng = np.random.RandomState(seed)
    return {"tokens": rng.randint(0, vocab, (batch, seq)).astype(np.int32),
            "position_ids": np.broadcast_to(np.arange(seq, dtype=np.int32),
                                            (batch, seq)).copy(),
            "labels": rng.randint(0, vocab, (batch, seq)).astype(np.int32),
            "loss_mask": (rng.rand(batch, seq) > 0.1).astype(np.float32)}


def _tb(batch: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _rebuild(tree, leaves):
    it = iter(leaves)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return next(it)

    return walk(tree)


@pytest.fixture(scope="module")
def weights():
    """(unboxed JAX params, the same as the port's tree) at ``MODEL``."""
    jparams = meta.unbox(JGPTModule({"Model": dict(PLAIN)}).init_variables(
        jax.random.PRNGKey(0), _batch(0)))
    tparams = convert.params_from_jax(jax.device_get(jparams),
                                      M.config_from_dict(dict(MODEL)))
    return jparams, tparams


def _port_loss_and_grads(model: dict, tparams: dict, batch: dict,
                         seed: int = 3, step: int = 0):
    module = GPTModule({"Model": model})
    leaves = [p.clone().requires_grad_(True)
              for _, p in tree_leaves_with_path(tparams)]
    loss, _ = module.training_loss(_rebuild(tparams, leaves), _tb(batch),
                                   seed=seed, step=step)
    return loss, torch.autograd.grad(loss, leaves)


# -------------------------------------------------------------- recompute
def _dropout_model(flash: bool) -> dict:
    return dict(MODEL, hidden_dropout_prob=0.1,
                attention_probs_dropout_prob=0.1, use_flash_attention=flash)


@pytest.fixture(scope="module")
def dropout_off(weights):
    """Per ``use_flash_attention``: the loss and grads without recompute
    at step 0, and the loss at step 1, shared by every granularity."""
    _, tparams = weights
    out = {}
    for flash in (True, False):
        model = _dropout_model(flash)
        loss, grads = _port_loss_and_grads(model, tparams, _batch(1))
        other, _ = _port_loss_and_grads(model, tparams, _batch(1), step=1)
        out[flash] = (loss, grads, other)
    return out


@pytest.mark.parametrize("flash", [True, False])
@pytest.mark.parametrize("granularity", GRANULARITIES)
def test_recompute_on_equals_off_with_dropout(weights, dropout_off,
                                              granularity, flash):
    """Hidden and attention dropout 0.1: the recomputed spans must draw
    the forward's masks again. Hidden dropout (and, with flash off,
    attention dropout) draws from the step's explicit generator, which
    checkpointing does not restore by itself."""
    _, tparams = weights
    off_loss, off_grads, other = dropout_off[flash]
    on_loss, on_grads = _port_loss_and_grads(
        dict(_dropout_model(flash), use_recompute=True,
             recompute_granularity=granularity), tparams, _batch(1))
    assert abs(float(on_loss.detach()) - float(off_loss.detach())) <= 1e-6
    for (path, _), a, b in zip(tree_leaves_with_path(tparams), on_grads,
                               off_grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-6,
                                   err_msg="/".join(path))
    # dropout is on: another step draws other masks
    assert abs(float(other.detach()) - float(off_loss.detach())) > 1e-4


def test_recompute_leaves_the_generator_where_the_forward_left_it():
    """After the backward, the step's generator is where the plain forward
    leaves it: the recomputation replays draws without consuming new
    ones, under ``full`` and under ``dots``."""
    cfg = M.config_from_dict(dict(MODEL, hidden_dropout_prob=0.1))
    params = M.init_params(cfg, seed=1)
    tokens = torch.from_numpy(_batch(2)["tokens"])
    states = []
    for recompute, granularity in ((False, "full"), (True, "full"),
                                   (True, "dots")):
        cfg.use_recompute = recompute
        cfg.recompute_granularity = granularity
        rng = M.dropout_rng(5, 0, cfg.num_layers, "cpu")
        leaves = [p.requires_grad_(True) for _, p in
                  tree_leaves_with_path(params)]
        out = M.gpt_model(params, cfg, tokens, deterministic=False, rng=rng)
        torch.autograd.grad(out.sum(), leaves)
        states.append(rng.gen.get_state())
    assert torch.equal(states[0], states[1])
    assert torch.equal(states[0], states[2])


@pytest.mark.parametrize("granularity", GRANULARITIES)
def test_recompute_matches_jax_remat(weights, granularity):
    """Dropout off: the port with recompute (kernels' plain versions)
    against the JAX module with the same remat granularity."""
    jparams, tparams = weights
    batch = _batch(4)
    knobs = dict(use_recompute=True, recompute_granularity=granularity)
    jmod = JGPTModule({"Model": dict(PLAIN, **knobs)})
    j_loss, j_grads = jax.value_and_grad(
        lambda p: jmod.training_loss(p, batch, jax.random.PRNGKey(3),
                                     jnp.int32(0))[0])(jparams)
    loss, grads = _port_loss_and_grads(dict(MODEL, **knobs), tparams, batch)
    assert abs(float(loss.detach()) - float(j_loss)) <= 1e-5
    want = convert.params_from_jax(jax.device_get(j_grads),
                                   M.config_from_dict(dict(MODEL)))
    for (path, w), g in zip(tree_leaves_with_path(want), grads):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg="/".join(path))


# -------------------------------------------------------- chunked LM head
#: (vocab, vocab_chunk) -> (chunk, n_chunks, pad) after the snap
CHUNKS = {"unrolled": ((1024, 256), (256, 4, 0)),
          "padded": ((1000, 300), (256, 4, 24)),
          "fold": ((4000, 100), (100, 40, 0)),
          "fold_padded": ((3990, 100), (100, 40, 10))}


@pytest.mark.parametrize("case", sorted(CHUNKS))
def test_chunked_head_matches_jax(case):
    (vocab, vocab_chunk), geometry = CHUNKS[case]
    assert M.chunk_geometry(vocab, vocab_chunk) == geometry
    rng = np.random.RandomState(vocab)
    x = rng.randn(2, 16, 32).astype(np.float32)
    wte = (0.5 * rng.randn(vocab, 32)).astype(np.float32)
    labels = rng.randint(0, vocab, (2, 16)).astype(np.int32)
    labels[0, :2] = (0, vocab - 1)  # the first and the last id
    weight = rng.rand(2, 16).astype(np.float32)

    def j_fn(x, wte):
        losses = JM.chunked_cross_entropy_per_token(
            x, wte, jnp.asarray(labels), vocab_chunk)
        return (losses * weight).sum(), losses

    (_, j_losses), j_grads = jax.value_and_grad(
        j_fn, argnums=(0, 1), has_aux=True)(jnp.asarray(x), jnp.asarray(wte))
    tx, tw = (torch.tensor(a, requires_grad=True) for a in (x, wte))
    losses = M.chunked_cross_entropy_per_token(tx, tw,
                                               torch.from_numpy(labels),
                                               vocab_chunk)
    (losses * torch.from_numpy(weight)).sum().backward()
    np.testing.assert_allclose(losses.detach().numpy(), np.asarray(j_losses),
                               rtol=0, atol=1e-5)
    full = M.cross_entropy_per_token(torch.einsum("bsh,vh->bsv", tx, tw),
                                     torch.from_numpy(labels))
    np.testing.assert_allclose(losses.detach().numpy(),
                               full.detach().numpy(), rtol=0, atol=1e-5)
    for got, want in zip((tx.grad, tw.grad), j_grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5)


def test_chunked_loss_through_the_module_matches_jax(weights):
    """``vocab_chunk`` set: the module passes labels to the head and the
    loss is the masked mean, as the JAX module's."""
    jparams, tparams = weights
    batch = _batch(6)
    knobs = dict(vocab_chunk=96)
    jmod = JGPTModule({"Model": dict(PLAIN, **knobs)})
    j_loss, j_grads = jax.value_and_grad(
        lambda p: jmod.training_loss(p, batch, jax.random.PRNGKey(3),
                                     jnp.int32(0))[0])(jparams)
    loss, grads = _port_loss_and_grads(dict(MODEL, **knobs), tparams, batch)
    assert abs(float(loss.detach()) - float(j_loss)) <= 1e-5
    want = convert.params_from_jax(jax.device_get(j_grads),
                                   M.config_from_dict(dict(MODEL)))
    for (path, w), g in zip(tree_leaves_with_path(want), grads):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg="/".join(path))
    with torch.no_grad():
        val = GPTModule({"Model": dict(MODEL, **knobs)}).validation_loss(
            tparams, _tb(batch))[0]
    assert abs(float(val) - float(jmod.validation_loss(jparams, batch)[0])) \
        <= 1e-5
