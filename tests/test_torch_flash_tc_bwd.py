"""Port: the tensor-core route of the split dq kernel and the fused flash
backward (``fleetx_tpu_torch/ops/flash_attention.py``).

bf16 / fp16 operands at head_dim 64 and 128 take the tensor-core dq and
fused backward kernels (wgmma on 16-bit tiles), which round ``ds`` (dq;
fused: dk and dq) and the dropped ``p`` (fused: dv) to the operand dtype
before their products. The plain versions model that with
``round_operands``; ``chip_smoke.py`` holds the kernels to it on the
card. Here, on the CPU:

- the rounded plain versions equal a jnp construction of the JAX
  kernels' math (``_bwd_dq_kernel:285-305``, ``_bwd_fused_kernel:
  470-500``, dense) with ``ds`` (and the fused kernel's dropped ``p``)
  cast to bf16 before the products and the outputs cast at the end, at
  f32 rtol/atol 1e-5. The inputs are those of
  ``tests/test_torch_flash_tc.py``, built so that both sides compute
  every rounded value bit for bit (q and k one-hot rows of 40, so
  ``exp(s - lse)`` is exactly 1 or 0; v and do small integers; delta a
  multiple of 2**-10); ``ds`` still carries more bits than bf16 keeps,
  so the rounding shows (the tests check that it does);
- with the keyword off, both plain versions are bit for bit what they
  were before the keyword existed (the earlier bodies are written out
  below);
- rounded and unrounded agree within the drift bound ``chip_smoke.py``
  holds the kernels to: the largest difference at most 2**-6 times the
  tensor's largest magnitude;
- one route predicate, ``tc_route``, decides the route of all four
  kernels: each wrapper passes it to its entry point (checked with a
  recording stand-in for the library on meta tensors) and counts
  ``tc_launches`` beside ``launches``;
- CPU calls of the fused and dq wrappers count no launch on either
  route.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

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
#: the drift bound of a tensor-core output against the unrounded plain
#: version, as a share of the output's largest magnitude
DRIFT = 2.0 ** -6
RATE = 0.1
#: the softmax scale of the exact-arithmetic cases
EXACT_SCALE = 0.125

#: (sq, sk, causal)
GEOMETRIES = {"causal": (256, 256, True), "full": (256, 256, False),
              "sq_gt_sk": (384, 256, False), "sq_lt_sk": (128, 384, False)}


def _exact_case(seed: int, sq: int, sk: int, d: int, causal: bool,
                bh: int = 2):
    """numpy ``(q, k, v, do, lse, delta)`` on which torch and XLA agree bit
    for bit up to the products' summation order: at scale 1/8 every score
    is 200 (q and k hot on one coordinate) or 0, and lse is the row's max
    score, so ``p`` is exactly 1 or 0."""
    rng = np.random.RandomState(seed)
    eye = np.eye(d, dtype=np.float32)
    q = 40 * eye[rng.randint(0, 8, size=(bh, sq))]
    k = 40 * eye[rng.randint(0, 8, size=(bh, sk))]
    v, do = (rng.randint(-3, 4, size=(bh, n, d)).astype(np.float32)
             for n in (sk, sq))
    s = np.einsum("bqd,bkd->bqk", q, k) * EXACT_SCALE
    if causal:
        s = np.where(np.tril(np.ones((sq, sk), bool)), s, -1e30)
    lse = s.max(-1).astype(np.float32)
    delta = (rng.randint(-4096, 4096, size=(bh, sq)) / 1024).astype(
        np.float32)
    return q, k, v, do, lse, delta


def _random_case(seed: int, sq: int, sk: int, d: int, causal: bool,
                 bh: int = 2):
    """numpy ``(q, k, v, do, lse, delta)``, operands exact in bf16; lse
    the rows' own logsumexp plus a per-row offset in [0, 1) (the ring
    feeds any lse), delta = sum(out · do)."""
    rng = np.random.RandomState(seed)

    def bf16_exact(*shape):
        x = torch.from_numpy(rng.randn(*shape).astype(np.float32))
        return x.to(torch.bfloat16).float().numpy()

    q, do = (bf16_exact(bh, sq, d) for _ in range(2))
    k, v = (bf16_exact(bh, sk, d) for _ in range(2))
    out, lse = FA.fwd_plain(*(torch.from_numpy(a) for a in (q, k, v)), 0,
                            d ** -0.5, causal)
    lse = lse.numpy() + rng.rand(bh, sq).astype(np.float32)
    delta = (out.numpy() * do).sum(-1).astype(np.float32)
    return q, k, v, do, lse, delta


def _keep(seed, q, k, rate):
    """The hash keep mask as numpy (both sides draw the same bits)."""
    if rate == 0.0:
        return None
    return FA.dropout_keep(seed, q.shape[0], q.shape[1], k.shape[1],
                           rate).numpy()


def _bf16(x):
    return x.astype(jnp.bfloat16).astype(jnp.float32)


def _jnp_p_dp(q, k, v, do, lse, scale, causal):
    s = jnp.einsum("bqd,bkd->bqk", jnp.asarray(q), jnp.asarray(k)) * scale
    if causal:
        sq, sk = s.shape[1:]
        s = jnp.where(jnp.arange(sq)[:, None] >= jnp.arange(sk)[None, :], s,
                      -1e30)
    p = jnp.exp(s - jnp.asarray(lse)[..., None])
    dp = jnp.einsum("bqd,bkd->bqk", jnp.asarray(do), jnp.asarray(v))
    return p, dp


def _jnp_dq_rounded(q, k, v, do, lse, delta, keep, scale, causal, rate):
    """``_bwd_dq_kernel``'s function, dense: kept dp divided by the keep
    probability, ds rounded to bf16 before ``dq = ds k``, dq cast to
    bf16."""
    p, dp = _jnp_p_dp(q, k, v, do, lse, scale, causal)
    if keep is not None:
        dp = jnp.where(keep, dp / (1.0 - rate), 0.0)
    ds = p * (dp - jnp.asarray(delta)[..., None]) * scale
    return _bf16(jnp.einsum("bqk,bkd->bqd", _bf16(ds), jnp.asarray(k)))


def _jnp_fused_rounded(q, k, v, do, lse, delta, keep, scale, causal, rate):
    """``_bwd_fused_kernel``'s function, dense: kept p and dp multiplied
    by ``1 / (1 - rate)``, the dropped p rounded to bf16 for dv and ds for
    dk and dq; dq in f32, dk and dv cast to bf16."""
    p, dp = _jnp_p_dp(q, k, v, do, lse, scale, causal)
    pd = p
    if keep is not None:
        inv = 1.0 / (1.0 - rate)
        pd = jnp.where(keep, p * inv, 0.0)
        dp = jnp.where(keep, dp * inv, 0.0)
    dv = jnp.einsum("bqk,bqd->bkd", _bf16(pd), jnp.asarray(do))
    ds = _bf16(p * (dp - jnp.asarray(delta)[..., None]) * scale)
    dk = jnp.einsum("bqk,bqd->bkd", ds, jnp.asarray(q))
    dq = jnp.einsum("bqk,bkd->bqd", ds, jnp.asarray(k))
    return dq, _bf16(dk), _bf16(dv)


def _bf16_ops(arrays):
    """torch tensors: q, k, v, do in bf16, lse and delta in f32."""
    ops = [torch.from_numpy(a) for a in arrays]
    ops[:4] = [t.to(torch.bfloat16) for t in ops[:4]]
    return ops


@pytest.mark.parametrize("rate", [0.0, RATE])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_rounded_dq_plain_matches_jnp_construction(geometry, d, rate):
    sq, sk, causal = GEOMETRIES[geometry]
    arrays = _exact_case(5 * d + sq + sk, sq, sk, d, causal)
    seed = 61
    q, k = arrays[:2]
    want = _jnp_dq_rounded(*arrays, _keep(seed, q, k, rate), EXACT_SCALE,
                           causal, rate)
    ops = _bf16_ops(arrays)
    got = FA.bwd_dq_plain(*ops, seed, EXACT_SCALE, causal, rate,
                          round_operands=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want), **F32)
    # ds carries ~20 bits here, so its rounding moves dq
    unrounded = FA.bwd_dq_plain(*ops, seed, EXACT_SCALE, causal, rate)
    assert float((unrounded.float() - got.float()).abs().max()) > 1e-3


@pytest.mark.parametrize("rate", [0.0, RATE])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_rounded_fused_plain_matches_jnp_construction(geometry, d, rate):
    sq, sk, causal = GEOMETRIES[geometry]
    arrays = _exact_case(7 * d + sq + sk, sq, sk, d, causal)
    seed = 67
    q, k = arrays[:2]
    want = _jnp_fused_rounded(*arrays, _keep(seed, q, k, rate), EXACT_SCALE,
                              causal, rate)
    ops = _bf16_ops(arrays)
    got = FA.bwd_plain(*ops, seed, EXACT_SCALE, causal, rate,
                       round_operands=True)
    assert [t.dtype for t in got] == [torch.float32, torch.bfloat16,
                                      torch.bfloat16]
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w),
                                   err_msg=name, **F32)
    unrounded = FA.bwd_plain(*ops, seed, EXACT_SCALE, causal, rate)
    diff = [float((u.float() - g.float()).abs().max())
            for u, g in zip(unrounded, got)]
    assert diff[0] > 1e-3 and diff[1] > 1e-3  # ds rounded for dq and dk
    if rate > 0.0:  # the kept p = 1/0.9 rounds to bf16 for dv
        assert diff[2] > 1e-3


def _dq_before(q3, k3, v3, do, lse, delta, seed, scale, causal, rate):
    """``bwd_dq_plain`` as it was before ``round_operands``."""
    p, dp, keep = FA._split_p_dp(q3, k3, v3, do, lse, seed, scale, causal,
                                 rate)
    if keep is not None:
        dp = torch.where(keep, dp / (1.0 - rate), torch.zeros_like(dp))
    ds = p * (dp - delta[..., None]) * scale
    return torch.einsum("bqk,bkd->bqd", ds, k3.float()).to(q3.dtype)


def _fused_before(q3, k3, v3, do, lse, delta, seed, scale, causal, rate):
    """``bwd_plain`` as it was before ``round_operands``."""
    p, dp, keep = FA._split_p_dp(q3, k3, v3, do, lse, seed, scale, causal,
                                 rate)
    pd = p
    if keep is not None:
        inv = 1.0 / (1.0 - rate)
        zero = torch.zeros_like(p)
        pd = torch.where(keep, p * inv, zero)
        dp = torch.where(keep, dp * inv, zero)
    dv = torch.einsum("bqk,bqd->bkd", pd, do.float())
    ds = p * (dp - delta[..., None]) * scale
    dk = torch.einsum("bqk,bqd->bkd", ds, q3.float())
    dq = torch.einsum("bqk,bkd->bqd", ds, k3.float())
    return dq, dk.to(k3.dtype), dv.to(v3.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.0, RATE])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_versions_unchanged_with_the_keyword_off(causal, rate, dtype):
    arrays = _random_case(5, 256, 256, 64, causal)
    q, k, v, do, lse, delta = (torch.from_numpy(a) for a in arrays)
    q, k, v, do = (t.to(dtype) for t in (q, k, v, do))
    args = (q, k, v, do, lse, delta, 19, 0.125, causal, rate)
    assert torch.equal(FA.bwd_dq_plain(*args), _dq_before(*args))
    for got, want in zip(FA.bwd_plain(*args), _fused_before(*args)):
        assert torch.equal(got, want)


def _drift(got, want) -> float:
    """Largest difference over the reference's largest magnitude."""
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("rate", [0.0, RATE])
@pytest.mark.parametrize("causal", [True, False])
def test_rounded_and_unrounded_agree_within_the_drift_bound(causal, rate,
                                                            dtype):
    arrays = _random_case(13, 256, 256, 128, causal)
    q, k, v, do, lse, delta = (torch.from_numpy(a) for a in arrays)
    q, k, v, do = (t.to(dtype) for t in (q, k, v, do))
    args = (q, k, v, do, lse, delta, 29, 128 ** -0.5, causal, rate)
    rounded = FA.bwd_dq_plain(*args, round_operands=True)
    unrounded = FA.bwd_dq_plain(*args)
    assert rounded.dtype == dtype
    assert 0.0 < _drift(rounded, unrounded) <= DRIFT
    rounded = FA.bwd_plain(*args, round_operands=True)
    unrounded = FA.bwd_plain(*args)
    assert rounded[0].dtype == torch.float32
    for r, u in zip(rounded, unrounded):
        assert 0.0 < _drift(r, u) <= DRIFT  # rounding moves it, boundedly


class _Entry:
    """Stands in for one C entry point: records the route (the argument
    before the stream) and reports success."""

    def __init__(self):
        self.routes = []

    def __call__(self, *args):
        self.routes.append(args[-2])
        return 0


ROUTE_CASES = [(torch.bfloat16, 64, True), (torch.bfloat16, 128, True),
               (torch.float16, 64, True), (torch.float16, 128, True),
               (torch.bfloat16, 256, False), (torch.float16, 256, False),
               (torch.float32, 64, False), (torch.float32, 128, False),
               (torch.float32, 256, False)]


@pytest.mark.parametrize("dtype,head_dim,tc", ROUTE_CASES)
def test_one_route_predicate_governs_all_four_kernels(monkeypatch, dtype,
                                                      head_dim, tc):
    """Every wrapper passes ``tc_route(dtype, head_dim)`` to its entry
    point and counts the tensor-core launches apart (meta tensors: shapes
    without data, so no kernel runs)."""
    assert FA.tc_route(dtype, head_dim) is tc
    entries = tuple(_Entry() for _ in range(4))
    monkeypatch.setattr(FA, "_fns", lambda: entries)
    monkeypatch.setattr(FA, "_on_card", lambda name, t: None)
    monkeypatch.setattr(FA, "_stream", lambda t: 0)
    wrappers = (FA.fwd_call, FA.bwd_call, FA.bwd_dq_call, FA.bwd_dkv_call)
    for fn in wrappers:
        monkeypatch.setattr(fn, "launches", 0)
        monkeypatch.setattr(fn, "tc_launches", 0)
    q, k, v, do = (torch.empty((2, 256, head_dim), dtype=dtype,
                               device="meta") for _ in range(4))
    lse, delta = (torch.empty((2, 256), device="meta") for _ in range(2))
    FA.fwd_call(q, k, v, 1, 0.125, True, RATE)
    FA.bwd_dq_call(q, k, v, do, lse, delta, 1, 0.125, True, RATE)
    FA.bwd_dkv_call(q, k, v, do, lse, delta, 1, 0.125, True, RATE)
    if head_dim <= 128:
        FA.bwd_call(q, k, v, do, lse, delta, 1, 0.125, True, RATE)
    else:  # the fused kernel takes no head_dim above 128, on any route
        with pytest.raises(ValueError, match="head_dim <= 128"):
            FA.bwd_call(q, k, v, do, lse, delta, 1, 0.125, True, RATE)
    ran = [1, int(head_dim <= 128), 1, 1]
    for fn, entry, n in zip(wrappers, entries, ran):
        assert entry.routes == [int(tc)] * n
        assert fn.launches == n and fn.tc_launches == n * int(tc)


@pytest.mark.parametrize("fused", [True, False])
def test_cpu_calls_count_no_launch_of_either_route(fused):
    from fleetx_tpu_torch.kernels import build

    wrappers = (FA.fwd_call, FA.bwd_call, FA.bwd_dq_call, FA.bwd_dkv_call)
    for fn in wrappers:
        fn.launches = fn.tc_launches = 0
    rng = np.random.RandomState(4)
    q, k, v = (torch.tensor(rng.randn(1, 128, 2, 64).astype(np.float32))
               .to(torch.bfloat16).requires_grad_(True) for _ in range(3))
    out = FA.flash_attention(q, k, v, fused_bwd=fused, dropout_rate=RATE,
                             dropout_seed=3)
    out.float().sum().backward()
    assert all(t.grad is not None for t in (q, k, v))
    for fn in wrappers:
        assert fn.launches == fn.tc_launches == 0
    assert "flash_attention" not in build.loaded()
