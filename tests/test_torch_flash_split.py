"""Port parity: the split flash backward (``bwd_dq_call`` /
``bwd_dkv_call`` in ``fleetx_tpu_torch/ops/flash_attention.py``).

The same numpy inputs, made from a seed, go through the JAX package's
Pallas ``_bwd_dq`` / ``_bwd_dkv`` (interpret mode on the CPU, as
``tests/test_zz_flashbwd.py`` runs them) and through the port's plain
versions, which the wrappers run for CPU tensors and which
``chip_smoke.py`` holds the CUDA kernels to on the card. The lse fed to
both is NOT the rows' own logsumexp (the rows' own plus a random offset):
the ring path feeds the kernels the global one, and any lse must work.

Tolerances: f32 rtol/atol 1e-5 (both sides compute every product in f32
from the same operands; only the summation order differs); bf16 outputs
within one bf16 ulp (rtol 2**-7, atol 1e-5: values that agree to ~1e-6
in f32 can round to neighbouring bf16 values).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fleetx_tpu.ops import flash_attention as JFA
from fleetx_tpu_torch.ops import flash_attention as FA

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

F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=2.0 ** -7, atol=1e-5)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _case(seed: int, sq: int, sk: int, d: int, causal: bool, bh: int = 1):
    """numpy ``(q, k, v, do, lse, delta)``: lse = the rows' own logsumexp
    plus a per-row offset in [0, 1), delta = sum(out · do)."""
    rng = np.random.RandomState(seed)
    q, do = (rng.randn(bh, sq, d).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(bh, sk, d).astype(np.float32) for _ in range(2))
    out, lse = FA.fwd_plain(*(torch.from_numpy(a) for a in (q, k, v)), 0,
                            d ** -0.5, causal)
    lse = lse.numpy() + rng.rand(bh, sq).astype(np.float32)
    delta = (out.numpy() * do).sum(-1).astype(np.float32)
    return q, k, v, do, lse, delta


def _jax_split(arrays, jdt, causal, rate=0.0):
    q, k, v, do, lse, delta = arrays
    d = q.shape[-1]
    kw = dict(scale=d ** -0.5, causal=causal,
              block_q=JFA.pick_block(q.shape[1], d),
              block_k=JFA.pick_block(k.shape[1], d), dropout_rate=rate)
    ops = [jnp.asarray(a).astype(jdt) for a in (q, k, v, do)]
    stats = [jnp.asarray(lse)[..., None], jnp.asarray(delta)[..., None]]
    seed = jnp.zeros((1,), jnp.int32)
    dq = JFA._bwd_dq(*ops, *stats, seed, **kw)
    dk, dv = JFA._bwd_dkv(*ops, *stats, seed, **kw)
    return dq, dk, dv


def _port_split(arrays, tdt, causal, seed=0, rate=0.0):
    q, k, v, do, lse, delta = (torch.from_numpy(a) for a in arrays)
    ops = [t.to(tdt) for t in (q, k, v, do)]
    args = (*ops, lse, delta, seed, q.shape[-1] ** -0.5, causal, rate)
    dq = FA.bwd_dq_call(*args)
    dk, dv = FA.bwd_dkv_call(*args)
    return dq, dk, dv


#: (sq, sk, causal): causal self-attention, and non-causal with sq == sk
#: and sq != sk both ways
GEOMETRIES = {"causal": lambda s: (s, s, True),
              "full": lambda s: (s, s, False),
              "sq_gt_sk": lambda s: (s + 128, s, False),
              "sq_lt_sk": lambda s: (s, s + 128, False)}


@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("seq", [128, 384])
@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_split_plain_matches_pallas_kernels_f32(geometry, seq, d):
    sq, sk, causal = GEOMETRIES[geometry](seq)
    arrays = _case(seq + d, sq, sk, d, causal)
    want = _jax_split(arrays, jnp.float32, causal)
    got = _port_split(arrays, torch.float32, causal)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(_np(g), _np(w), err_msg=name, **F32)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_split_plain_matches_pallas_kernels_bf16(causal, d):
    """dq comes back in the operand dtype (``_bwd_dq``'s out_shape), dk/dv
    in the k/v dtype."""
    arrays = _case(7 + d, 256, 256, d, causal)
    want = _jax_split(arrays, jnp.bfloat16, causal)
    got = _port_split(arrays, torch.bfloat16, causal)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert g.dtype == torch.bfloat16 and w.dtype == jnp.bfloat16
        np.testing.assert_allclose(_np(g), _np(w), err_msg=name, **BF16)


@pytest.mark.parametrize("shape,fused_bwd", [((1, 128, 2, 64), False),
                                             ((2, 256, 1, 128), False),
                                             ((1, 128, 1, 256), True)])
def test_grads_match_jax_where_both_take_the_split_pair(shape, fused_bwd):
    """``flash_attention`` grads against ``jax.grad`` of the JAX one:
    ``fused_bwd`` off, and head_dim 256 (which the fused kernel rejects
    whatever the knob says) — both sides run the split pair."""
    b, s, n, d = shape
    rng = np.random.RandomState(11)
    q, k, v, g = (rng.randn(b, s, n, d).astype(np.float32) for _ in range(4))
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    assert not (fused_bwd and JFA.fused_backward_supported(jq, jk))

    def j_loss(q, k, v):
        return (JFA.flash_attention(q, k, v, causal=True,
                                    fused_bwd=fused_bwd) * g).sum()

    j_grads = jax.grad(j_loss, argnums=(0, 1, 2))(jq, jk, jv)
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = FA.flash_attention(tq, tk, tv, causal=True, fused_bwd=fused_bwd)
    (out * torch.from_numpy(g)).sum().backward()
    for got, want in zip((tq.grad, tk.grad, tv.grad), j_grads):
        np.testing.assert_allclose(_np(got), _np(want), **F32)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_split_plain_equals_fused_plain_with_dropout(causal, d):
    """Dropout 0.1: the split pair and the fused backward draw the same
    hash masks, so dq, dk and dv agree (the split's dq divides kept dP by
    ``1 - rate`` where the fused multiplies by its inverse: one f32 ulp)."""
    arrays = _case(23 + d, 256, 256, d, causal)
    q, k, v, do, lse, delta = (torch.from_numpy(a) for a in arrays)
    args = (q, k, v, do, lse, delta, 4242, d ** -0.5, causal, 0.1)
    fused = FA.bwd_plain(*args)
    split = (FA.bwd_dq_plain(*args), *FA.bwd_dkv_plain(*args))
    for g, w in zip(split, fused):
        np.testing.assert_allclose(_np(g), _np(w), **F32)
    # the masks matter: without dropout the grads differ
    no_drop = FA.bwd_dq_plain(*args[:-1], 0.0)
    assert float((no_drop - split[0]).abs().max()) > 1e-2


@pytest.mark.parametrize("fused_bwd,d,path", [(True, 64, "fused"),
                                              (True, 128, "fused"),
                                              (False, 64, "split"),
                                              (False, 128, "split"),
                                              (True, 256, "split")])
def test_backward_dispatch_follows_the_fused_predicate(monkeypatch,
                                                       fused_bwd, d, path):
    """``_Flash3.backward`` takes the fused kernel where ``fused_bwd`` is
    on and ``fused_backward_supported`` admits the shape, the split pair
    otherwise, as the JAX ``_bwd`` does."""
    calls = []
    for name in ("bwd_plain", "bwd_dq_plain", "bwd_dkv_plain"):
        fn = getattr(FA, name)
        monkeypatch.setattr(FA, name, lambda *a, _fn=fn, _n=name: (
            calls.append(_n), _fn(*a))[1])
    rng = np.random.RandomState(d)
    q, k, v = (torch.tensor(rng.randn(1, 128, 1, d).astype(np.float32),
                            requires_grad=True) for _ in range(3))
    FA.flash_attention(q, k, v, fused_bwd=fused_bwd).sum().backward()
    want = ["bwd_plain"] if path == "fused" else ["bwd_dq_plain",
                                                  "bwd_dkv_plain"]
    assert calls == want
    assert q.grad.dtype == torch.float32 and q.grad.shape == q.shape


def test_kept_predicate_difference_at_seq_8192():
    """The port's fused predicate omits JAX's 4 MiB dq-window rule (a TPU
    VMEM budget): at seq 8192 head_dim 128 JAX takes the split pair and
    the port the fused kernel; at seq 4096 both take the fused one."""
    for seq, jax_fused in ((8192, False), (4096, True)):
        jq = jax.ShapeDtypeStruct((1, seq, 16, 128), jnp.bfloat16)
        tq = torch.empty((1, seq, 16, 128), device="meta")
        assert JFA.fused_backward_supported(jq, jq) is jax_fused
        assert FA.fused_backward_supported(tq, tq)


def test_cpu_split_backward_counts_no_launch():
    from fleetx_tpu_torch.kernels import build

    FA.bwd_dq_call.launches = FA.bwd_dkv_call.launches = 0
    FA.bwd_call.launches = 0
    rng = np.random.RandomState(5)
    q, k, v = (torch.tensor(rng.randn(1, 128, 2, 64).astype(np.float32),
                            requires_grad=True) for _ in range(3))
    out = FA.flash_attention(q, k, v, fused_bwd=False, dropout_rate=0.1,
                             dropout_seed=9)
    out.sum().backward()
    assert FA.bwd_dq_call.launches == FA.bwd_dkv_call.launches == 0
    assert FA.bwd_call.launches == 0
    assert "flash_attention" not in build.loaded()


def test_split_wrappers_raise_on_a_device_without_kernel():
    q3 = torch.empty((2, 128, 64), device="meta")
    lse = torch.empty((2, 128), device="meta")
    for fn in (FA.bwd_dq_call, FA.bwd_dkv_call):
        with pytest.raises(ValueError, match="no kernel for device"):
            fn(q3, q3, q3, q3, lse, lse, 0, 0.125)
