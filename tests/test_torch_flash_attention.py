"""Port parity: causal flash attention (``fleetx_tpu_torch/ops/
flash_attention.py``).

The same numpy inputs, made from a seed, go through the JAX package's
Pallas forward ``_fwd`` and ``jax.grad`` of ``flash_attention(fused_bwd=
True)`` (the single-pass fused backward; interpret mode on the CPU, as
its own tests run them) and through the port's ``fwd_call`` and autograd
wrapper on CPU tensors, which run the kernels' plain PyTorch versions.
The CUDA kernels are held to those plain versions on the card by
``chip_smoke.py``.

Dropout cannot be compared with the TPU's hardware PRNG bits (interpret
mode has none either). Instead the port's hash mask is exported
(``dropout_keep``) and a dense reference built from it must give the
plain forward and backward; the keep rate is checked on ~2M elements and
the hash itself against an independent pure-Python evaluation.

Tolerances: f32 atol 1e-5 (rtol 1e-5) for ``out``, ``lse`` and
dq/dk/dv: both sides compute every product in f32 after casting, so only
the summation order differs. bf16 operands: ``lse`` and the f32 dq keep
that tolerance; ``out`` (cast to bf16) may land one bf16 ulp apart
(rtol 2**-7).
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

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _qkv(seed: int, b: int = 1, s: int = 128, n: int = 2, d: int = 64):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(b, s, n, d).astype(np.float32) for _ in range(4))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _to3(a: np.ndarray) -> np.ndarray:
    b, s, n, d = a.shape
    return np.ascontiguousarray(a.transpose(0, 2, 1, 3).reshape(b * n, s, d))


@pytest.mark.parametrize("seq", [128, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_plain_matches_pallas_kernel(dtype, seq):
    jdt, tdt = DTYPES[dtype]
    q, k, v, _ = _qkv(1, s=seq)
    q3, k3, v3 = (_to3(a) for a in (q, k, v))
    scale = 64 ** -0.5
    block = JFA.pick_block(seq, 64)
    j_out, j_lse = JFA._fwd(*(jnp.asarray(a).astype(jdt) for a in
                              (q3, k3, v3)), jnp.zeros((1,), jnp.int32),
                            scale=scale, causal=True, block_q=block,
                            block_k=block, dropout_rate=0.0)
    t_out, t_lse = FA.fwd_call(*(torch.from_numpy(a).to(tdt) for a in
                                 (q3, k3, v3)), 0, scale, True, 0.0)
    assert t_out.dtype == tdt and t_lse.dtype == torch.float32
    np.testing.assert_allclose(_np(t_lse), _np(j_lse), rtol=1e-5, atol=1e-5)
    tol = (dict(rtol=1e-5, atol=1e-5) if dtype == "float32"
           else dict(rtol=2.0 ** -7, atol=1e-5))
    np.testing.assert_allclose(_np(t_out), _np(j_out), **tol)


@pytest.mark.parametrize("shape", [(1, 128, 2, 64), (2, 256, 1, 64),
                                   (1, 128, 1, 128)])
def test_grads_match_jax_fused_backward(shape):
    """dq/dk/dv through the port's autograd wrapper against ``jax.grad``
    of ``flash_attention(fused_bwd=True)`` (f32)."""
    b, s, n, d = shape
    q, k, v, g = _qkv(2, b, s, n, d)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    assert JFA.fused_backward_supported(jq, jk)

    def j_loss(q, k, v):
        return (JFA.flash_attention(q, k, v, causal=True, fused_bwd=True)
                * g).sum()

    j_grads = jax.grad(j_loss, argnums=(0, 1, 2))(jq, jk, jv)
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = FA.flash_attention(tq, tk, tv, causal=True, fused_bwd=True)
    (out * torch.from_numpy(g)).sum().backward()
    for got, want in zip((tq.grad, tk.grad, tv.grad), j_grads):
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5,
                                   atol=1e-5)


def test_fused_backward_plain_matches_pallas_kernel_with_f32_dq():
    """``bwd_call`` (plain) against ``_bwd_fused`` on the same lse/delta;
    the port returns dq in f32, the JAX entry casts it to the operand
    dtype, so compare in f32 operands."""
    q, k, v, g = (_to3(a) for a in _qkv(3))
    scale = 64 ** -0.5
    jq, jk, jv, jg = (jnp.asarray(a) for a in (q, k, v, g))
    seed = jnp.zeros((1,), jnp.int32)
    j_out, j_lse = JFA._fwd(jq, jk, jv, seed, scale=scale, causal=True,
                            block_q=128, block_k=128, dropout_rate=0.0)
    delta = (j_out * jg).sum(-1)
    j_dq, j_dk, j_dv = JFA._bwd_fused(jq, jk, jv, jg, j_lse[..., None],
                                      delta[..., None], seed, scale=scale,
                                      causal=True, block_q=128, block_k=128)
    t = [torch.from_numpy(np.array(a)) for a in (q, k, v, g, j_lse, delta)]
    dq, dk, dv = FA.bwd_call(*t, 0, scale, True, 0.0)
    assert dq.dtype == torch.float32
    for got, want in zip((dq, dk, dv), (j_dq, j_dk, j_dv)):
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5,
                                   atol=1e-5)


GATE_SEQS = (64, 128, 192, 256, 384, 1024, 4096)
GATE_DIMS = (32, 64, 96, 128, 256)


@pytest.mark.parametrize("causal", [True, False])
def test_gates_answer_as_jax_on_a_grid_of_shapes(causal):
    """``supported`` / ``fused_backward_supported`` agree with the JAX
    predicates wherever the TPU's VMEM budget does not bind (the fused dq
    window of every shape here is under 4 MiB)."""
    checked = 0
    for s in GATE_SEQS:
        for d in GATE_DIMS:
            for sk in (s, 2 * s):
                jq = jax.ShapeDtypeStruct((1, s, 2, d), jnp.float32)
                jk = jax.ShapeDtypeStruct((1, sk, 2, d), jnp.float32)
                tq = torch.empty((1, s, 2, d), device="meta")
                tk = torch.empty((1, sk, 2, d), device="meta")
                assert FA.supported(tq, tk, causal=causal) == \
                    JFA.supported(jq, jk, causal=causal), (s, sk, d)
                assert FA.supported(tq) == JFA.supported(jq), (s, d)
                assert FA.fused_backward_supported(tq, tk, causal=causal) \
                    == JFA.fused_backward_supported(jq, jk, causal=causal), \
                    (s, sk, d)
                checked += 1
    assert checked == len(GATE_SEQS) * len(GATE_DIMS) * 2
    rank3 = torch.empty((4, 128, 64), device="meta")
    assert not FA.supported(rank3)


# ---------------------------------------------------------------- dropout
def _mix32_py(x: int) -> int:
    x &= 0xFFFFFFFF
    x ^= x >> 16
    x = (x * 0x7FEB352D) & 0xFFFFFFFF
    x ^= x >> 15
    x = (x * 0x846CA68B) & 0xFFFFFFFF
    return x ^ (x >> 16)


def test_dropout_hash_matches_a_pure_python_evaluation():
    """The int64 evaluation (masked 32-bit products) equals Python's
    arbitrary-precision integers on the words the kernels compute."""
    seed, bh, sq, sk = 0x7FFFFFF1, 3, 5, 7
    bits = FA.dropout_bits(seed, bh, sq, sk)
    for h in range(bh):
        kh = _mix32_py(seed ^ _mix32_py(h ^ 0x85EBCA6B))
        for r in range(sq):
            rk = _mix32_py(kh ^ r)
            for c in range(sk):
                want = _mix32_py(rk ^ ((c * 0x9E3779B9) & 0xFFFFFFFF))
                assert int(bits[h, r, c]) == want
    assert FA.keep_threshold(0.1) == int(0.1 * 2 ** 32)
    assert FA.keep_threshold(1.0) == 2 ** 32 - 1


def test_dropout_keep_rate_and_seed_dependence():
    keep = FA.dropout_keep(1234, 16, 128, 1024, 0.1)
    assert keep.numel() >= 2_000_000
    rate = float(keep.float().mean())
    assert abs(rate - 0.9) <= 0.01, rate
    other = FA.dropout_keep(1235, 16, 128, 1024, 0.1)
    assert not torch.equal(keep, other)
    assert torch.equal(keep, FA.dropout_keep(1234, 16, 128, 1024, 0.1))
    # rows, columns and heads all draw distinct words
    bits = FA.dropout_bits(7, 4, 128, 128)
    assert bits.unique().numel() > 0.999 * bits.numel()


def _dense_reference(q3, k3, v3, keep, rate, scale):
    """Attention with dropout written out densely from an exported mask:
    softmax of the causal f32 scores, then mask / (1 - rate), then @ v."""
    s = torch.einsum("bqd,bkd->bqk", q3, k3) * scale
    causal = torch.ones(s.shape[1:], dtype=torch.bool).tril()
    s = s.masked_fill(~causal, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", torch.where(keep, p / (1 - rate),
                                                    torch.zeros_like(p)), v3)


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_forward_and_backward_equal_dense_reference(rate):
    q, k, v, g = (torch.from_numpy(_to3(a)) for a in _qkv(4, s=256))
    seed, scale = 987654, 64 ** -0.5
    keep = FA.dropout_keep(seed, q.shape[0], 256, 256, rate)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ref = _dense_reference(*leaves, keep, rate, scale)
    (ref * g).sum().backward()
    ref_grads = [t.grad for t in leaves]

    out, lse = FA.fwd_plain(q, k, v, seed, scale, True, rate)
    np.testing.assert_allclose(_np(out), _np(ref), rtol=1e-5, atol=1e-5)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = FA._Flash3.apply(*leaves, seed, scale, True, rate)
    (out * g).sum().backward()
    for got, want in zip((t.grad for t in leaves), ref_grads):
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5,
                                   atol=1e-5)


# --------------------------------------------------------------- contract
def test_cpu_runs_plain_version_and_counts_no_launch():
    from fleetx_tpu_torch.kernels import build

    FA.fwd_call.launches = FA.bwd_call.launches = 0
    q, k, v, g = (torch.tensor(a, requires_grad=True) for a in _qkv(5))
    out = FA.flash_attention(q, k, v, dropout_rate=0.1, dropout_seed=3)
    (out * g.detach()).sum().backward()
    assert FA.fwd_call.launches == FA.bwd_call.launches == 0
    assert "flash_attention" not in build.loaded()


def test_device_without_kernel_raises_instead_of_falling_back():
    q3 = torch.empty((2, 128, 64), device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        FA.fwd_call(q3, q3, q3, 0, 0.125)
    lse = torch.empty((2, 128), device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        FA.bwd_call(q3, q3, q3, q3, lse, lse, 0, 0.125)
