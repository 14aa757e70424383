"""Port parity: the ``dots`` recompute granularity (recompute that keeps
the matmul and kernel outputs at their save points,
``models/gpt/model.dots_policy``, ``ops/save_points.py``) with
``remat_save_dtype`` and ``remat_consumed_layout``.

The same numpy batch and converted weights go through the JAX package
(``GPTModule`` with ``use_recompute`` and ``recompute_granularity: dots``,
jitted, its Pallas kernels off since interpret mode costs seconds a call
on the CPU) and the port on CPU tensors (the kernels' plain versions,
which a CPU tensor routes to; their calls are counted here as the
kernels' launches are on the card).

Tolerances (f32, dropout off): loss atol 1e-5 and every grad leaf atol
1e-5 with rtol 1e-4 against JAX (``tests/test_torch_train.py``'s bounds);
the port's ``remat_consumed_layout`` on against off, and ``dots`` against
no recompute, bit for bit (the same ops on the same values; only what is
kept for the backward differs).

With ``remat_save_dtype: bfloat16`` both sides round the four named
residuals to bf16 in the forward. Rounding is a step: the two libraries'
f32 values differ by ulps, and an element within an ulp of a bf16
rounding boundary rounds to neighbouring bf16 values on the two sides.
So in those cases the port's rounded residuals are replaced by the ones
JAX made (``_jax_residuals``: each matched to the port's by shape and
value, the port's own within one bf16 ulp of it plus 1e-5, and at most
1 % of the elements apart), and the loss is held to the bound above. The
backward rounds the residuals' cotangents to bf16 as well (the transpose
of the cast, on both sides), where the same flips happen and cannot be
replaced, so there each grad leaf is held within one bf16 ulp (2**-7) of
each element plus 2**-7 of the leaf's largest magnitude.
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
from fleetx_tpu_torch.ops import flash_attention as FA
from fleetx_tpu_torch.ops import fused_norm as FN
from fleetx_tpu_torch.ops import save_points as SP
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

VOCAB, SEQ, LAYERS = 256, 128, 2
MODEL = dict(vocab_size=VOCAB, hidden_size=128, num_layers=LAYERS,
             num_attention_heads=2, max_position_embeddings=SEQ,
             hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
             use_flash_attention=True, flash_fused_bwd=True,
             fused_residual_norm=True, dtype="float32",
             param_dtype="float32")
PLAIN = dict(MODEL, use_flash_attention=False, fused_residual_norm=False)
DOTS = dict(use_recompute=True, recompute_granularity="dots")
#: one bf16 ulp relative to the value: the grads' bound where the residuals
#: are cast (rtol, and atol as a share of each leaf's largest magnitude):
#: the backward rounds their cotangents to bf16 too (the cast's transpose,
#: on both sides), and a cotangent that flips carries one bf16 ulp of its
#: terms into the sums that make a grad element, whatever that element's
#: own size
BF16_ULP = 2.0 ** -7
#: (remat_save_dtype, remat_consumed_layout) → the case's id
CASES = {"native_layout": (None, True), "native_dots": (None, False),
         "bf16_layout": ("bfloat16", True), "bf16_dots": ("bfloat16", False)}


def _batch(seed: int = 4) -> dict:
    rng = np.random.RandomState(seed)
    return {"tokens": rng.randint(0, VOCAB, (2, SEQ)).astype(np.int32),
            "position_ids": np.broadcast_to(np.arange(SEQ, dtype=np.int32),
                                            (2, SEQ)).copy(),
            "labels": rng.randint(0, VOCAB, (2, SEQ)).astype(np.int32),
            "loss_mask": (rng.rand(2, SEQ) > 0.1).astype(np.float32)}


def _knobs(case: str) -> dict:
    save, layout = CASES[case]
    return dict(DOTS, remat_save_dtype=save, remat_consumed_layout=layout)


def _rebuild(tree, leaves):
    it = iter(leaves)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return next(it)

    return walk(tree)


@pytest.fixture(scope="module")
def weights():
    """(unboxed JAX params, the same as the port's tree)."""
    jparams = meta.unbox(JGPTModule({"Model": dict(PLAIN)}).init_variables(
        jax.random.PRNGKey(0), _batch()))
    return jparams, convert.params_from_jax(jax.device_get(jparams),
                                            M.config_from_dict(dict(MODEL)))


def _port(model: dict, tparams: dict, seed: int = 3):
    """``(loss, grads)`` of one port loss+grad evaluation."""
    module = GPTModule({"Model": model})
    leaves = [p.clone().requires_grad_(True)
              for _, p in tree_leaves_with_path(tparams)]
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    loss, _ = module.training_loss(_rebuild(tparams, leaves), batch,
                                   seed=seed, step=0)
    return loss.detach(), torch.autograd.grad(loss, leaves)


def _record_residuals(monkeypatch) -> list:
    """Every value JAX tags with ``checkpoint_name`` from now on, in the
    port's layout (``res_qkv`` back from its consumed layout, then from
    JAX's ``[b, 3, s, n, d]`` to the port's ``[b, s, 3, n, d]``), appended
    through an ordered debug callback."""
    calls, orig = [], JM.checkpoint_name

    def recording(y, name):
        shown = y
        perm = JM.RESIDUAL_CONSUMED_PERMS.get(name)
        if perm is not None and y.ndim == len(perm):
            if y.shape[0] == 3:  # the consumed layout [3, b, s, n, d]
                shown = jnp.transpose(shown, np.argsort(perm))
            shown = jnp.transpose(shown, (0, 2, 1, 3, 4))
        jax.debug.callback(lambda a: calls.append(
            np.asarray(a.astype(jnp.float32))), shown, ordered=True)
        return orig(y, name)

    monkeypatch.setattr(JM, "checkpoint_name", recording)
    return calls


def _jax_residuals(monkeypatch, records: list) -> None:
    """The port's cast residuals (the ``"residual"`` save points, made in
    bf16) become the JAX record of the same shape nearest to them, which
    must be within one bf16 ulp (2**-7 of the value) plus 1e-5 everywhere
    and equal in 99 % of the elements. The save point keeps what it
    returns, so the recomputation takes the same values back."""
    orig = SP.kept

    def nearest(compute):
        got = compute()
        ref = got.float()
        cands = [torch.from_numpy(r.copy()) for r in records
                 if r.shape == tuple(ref.shape)]
        want = min(cands, key=lambda r: float((r - ref).abs().max()))
        # one bf16 ulp is at most 2**-7 of the value; near zero the f32
        # values themselves differ by the 1e-5 the f32 checks allow
        assert bool(((want - ref).abs()
                     <= 2.0 ** -7 * torch.maximum(want.abs(), ref.abs())
                     + 1e-5).all())
        assert float((want != ref).float().mean()) <= 0.01
        return want.to(got.dtype)

    def forced(kind, compute):
        if kind != "residual":
            return orig(kind, compute)
        return orig(kind, lambda: nearest(compute))

    monkeypatch.setattr(SP, "kept", forced)


@pytest.mark.parametrize("case", sorted(CASES))
def test_dots_matches_jax(weights, case, monkeypatch):
    jparams, tparams = weights
    records = _record_residuals(monkeypatch)
    jmod = JGPTModule({"Model": dict(PLAIN, **_knobs(case))})
    j_loss, j_grads = jax.jit(jax.value_and_grad(
        lambda p: jmod.training_loss(p, _batch(), jax.random.PRNGKey(3),
                                     jnp.int32(0))[0]))(jparams)
    jax.effects_barrier()
    monkeypatch.undo()
    if CASES[case][0] is not None:
        # the forward's four a layer, and again where JAX's backward
        # replays the span that tags them
        assert records and len(records) % (4 * LAYERS) == 0
        _jax_residuals(monkeypatch, records)
    loss, grads = _port(dict(MODEL, **_knobs(case)), tparams)
    assert abs(float(loss) - float(j_loss)) <= 1e-5
    want = convert.params_from_jax(jax.device_get(j_grads),
                                   M.config_from_dict(dict(MODEL)))
    cast = CASES[case][0] is not None
    for (path, w), g in zip(tree_leaves_with_path(want), grads):
        w = w.numpy()
        np.testing.assert_allclose(
            g.numpy(), w, rtol=BF16_ULP if cast else 1e-4,
            atol=BF16_ULP * float(np.abs(w).max()) if cast else 1e-5,
            err_msg="/".join(path))


@pytest.mark.parametrize("save", [None, "bfloat16"])
def test_consumed_layout_on_equals_off(weights, save):
    """``remat_consumed_layout`` picks the names policy or the dots
    policy and nothing else: losses and grads are equal bit for bit; with
    no cast, both equal the run without recompute."""
    _, tparams = weights
    runs = [_port(dict(MODEL, **DOTS, remat_save_dtype=save,
                       remat_consumed_layout=layout), tparams)
            for layout in (True, False)]
    if save is None:
        runs.append(_port(dict(MODEL), tparams))
    else:  # the cast moves the forward: the round trip is on the path
        assert not torch.equal(runs[0][0], _port(dict(MODEL), tparams)[0])
    for loss, grads in runs[1:]:
        assert torch.equal(loss, runs[0][0])
        for a, b in zip(grads, runs[0][1]):
            assert torch.equal(a, b)


@pytest.fixture
def counted(monkeypatch):
    """Calls of the flash and fused-norm forwards' plain versions (what a
    CPU tensor runs in place of the kernel)."""
    calls = {"flash": 0, "norm": 0}
    flash, norm = FA.fwd_plain, FN.fwd_plain

    def count(key, fn):
        def wrapper(*args, **kwargs):
            calls[key] += 1
            return fn(*args, **kwargs)
        return wrapper

    monkeypatch.setattr(FA, "fwd_plain", count("flash", flash))
    monkeypatch.setattr(FN, "fwd_plain", count("norm", norm))
    return calls


@pytest.mark.parametrize("granularity", ["dots", "full"])
def test_flash_and_norm_forwards_run_once_per_layer_under_dots(
        weights, counted, granularity):
    """Under ``dots`` the backward reruns neither the flash forward nor a
    norm forward: one each per layer (and ``ln_f``) a loss+grad. Under
    ``full`` the layers' run twice."""
    _, tparams = weights
    _port(dict(MODEL, use_recompute=True,
               recompute_granularity=granularity), tparams)
    runs = 1 if granularity == "dots" else 2
    assert counted == {"flash": runs * LAYERS,
                       "norm": runs * 2 * LAYERS + 1}


def test_flash_off_reruns_the_norm_under_dots(weights, counted):
    """With ``use_flash_attention`` off, JAX's policy is the bare dots
    policy, which does not keep the norm kernel's outputs: the norm
    forwards rerun in the backward, as in JAX."""
    _, tparams = weights
    _port(dict(MODEL, **DOTS, use_flash_attention=False), tparams)
    assert counted == {"flash": 0, "norm": 2 * 2 * LAYERS + 1}


def test_the_policy_keeps_what_jax_saves():
    """The save-point kinds each configuration keeps from the forward."""
    for knobs, kinds in (
            (dict(remat_consumed_layout=True), {"residual", "kernel"}),
            (dict(remat_consumed_layout=False), {"dot", "kernel"}),
            (dict(remat_consumed_layout=False, remat_save_dtype="bfloat16"),
             {"residual", "kernel"}),
            (dict(remat_consumed_layout=False, use_flash_attention=False),
             {"dot"})):
        cfg = M.config_from_dict(dict(MODEL, **DOTS, **knobs))
        assert M.dots_policy(cfg) == kinds, knobs


def test_a_save_point_is_taken_back_not_made_again():
    """A span keeps the outputs of the kinds it keeps and its rerun takes
    them back in order (a kernel launched once); other kinds, and calls
    outside a span, compute."""
    made = []

    def make(tag):
        def compute():
            made.append(tag)
            return torch.tensor(float(len(made)))
        return compute

    points = SP.SavePoints({"kernel"})
    with SP.recording(points):
        first = [SP.kept("kernel", make("a")), SP.kept("dot", make("b")),
                 SP.kept("kernel", make("c"))]
    with SP.replaying(points):
        again = [SP.kept("kernel", make("x")), SP.kept("dot", make("y")),
                 SP.kept("kernel", make("z"))]
        with pytest.raises(RuntimeError, match="another path"):
            SP.kept("kernel", make("w"))
    assert made == ["a", "b", "c", "y"]
    assert again[0] is first[0] and again[2] is first[2]
    assert points.outputs == [None, None]   # the span lets go of them
    assert SP.kept("kernel", make("outside")) == 5.0
