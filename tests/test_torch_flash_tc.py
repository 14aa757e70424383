"""Port: the tensor-core route of the flash forward and the split dk/dv
kernel (``fleetx_tpu_torch/ops/flash_attention.py``).

bf16 / fp16 operands at head_dim 64 and 128 take the tensor-core kernels
(wgmma on 16-bit tiles), which round the dropped ``p`` (forward) and
``pᵀ``, ``dsᵀ`` (dk/dv) to the operand dtype before their products. The
plain versions model that with ``round_operands``; ``chip_smoke.py`` holds
the kernels to it on the card. Here, on the CPU:

- the rounded plain versions equal a jnp construction of the JAX kernels'
  math (``_fwd_kernel:193-215``, ``_bwd_dkv_kernel:334-362``, dense) with
  ``p`` / ``ds`` cast to bf16 before the product and the outputs cast to
  bf16 at the end, at f32 rtol/atol 1e-5 (both sides sum the same
  products from the same operands). The inputs are built so that both
  sides compute every rounded value bit for bit: torch's and XLA's f32 ``exp`` differ in the last bit
  on some arguments, and one bit can move a value across a bf16 rounding
  boundary. So q and k are one-hot rows of 40 (scores 200 or 0 at scale
  1/8, hence ``exp(s - m)`` exactly 1 or 0), v and do small integers (dP
  exact), delta multiples of 2**-10 and lse the rows' max score; the
  dropout scale 1/0.9 and dS still carry more bits than bf16 keeps, so
  the rounding shows (the tests check that it does);
- with the keyword off, the plain versions are bit for bit what they
  were before the keyword existed (the earlier bodies are written out
  below);
- rounded and unrounded agree within the drift bound ``chip_smoke.py``
  holds the kernels to: the largest difference at most 2**-6 times the
  tensor's largest magnitude (one bf16 rounding of each P or dS term is a
  relative error of at most 2**-9; summed over a row, with the signs of
  dS mixed, the drift stays a few bf16 ulps of the largest output);
- the route function and the per-route launch counts;
- the kernel library's key follows every ``csrc/*.cuh`` header.
"""

import os
import shutil

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


def _bf16_exact(rng, *shape) -> np.ndarray:
    """Standard-normal f32 values rounded through bf16 (exact in bf16)."""
    x = torch.from_numpy(rng.randn(*shape).astype(np.float32))
    return x.to(torch.bfloat16).float().numpy()


def _case(seed: int, sq: int, sk: int, d: int, causal: bool, bh: int = 2):
    """numpy ``(q, k, v, do, lse, delta)``, operands exact in bf16; lse
    the rows' own logsumexp plus a per-row offset in [0, 1) (the ring
    feeds any lse), delta = sum(out · do)."""
    rng = np.random.RandomState(seed)
    q, do = (_bf16_exact(rng, bh, sq, d) for _ in range(2))
    k, v = (_bf16_exact(rng, bh, sk, d) for _ in range(2))
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


def _jnp_scores(q, k, scale, causal):
    s = jnp.einsum("bqd,bkd->bqk", jnp.asarray(q), jnp.asarray(k)) * scale
    if causal:
        sq, sk = s.shape[1:]
        rows = jnp.arange(sq)[:, None]
        cols = jnp.arange(sk)[None, :]
        s = jnp.where(rows >= cols, s, -1e30)
    return s


def _bf16(x):
    return x.astype(jnp.bfloat16).astype(jnp.float32)


def _jnp_fwd_rounded(q, k, v, keep, scale, causal, rate):
    """``_fwd_kernel``'s function, dense, the dropped p rounded to bf16
    before ``p @ v``; the normaliser sums the unrounded, undropped p."""
    s = _jnp_scores(q, k, scale, causal)
    m = s.max(axis=-1)
    p = jnp.exp(s - m[..., None])
    l = p.sum(axis=-1)
    if keep is not None:
        p = jnp.where(keep, p / (1.0 - rate), 0.0)
    acc = jnp.einsum("bqk,bkd->bqd", _bf16(p), jnp.asarray(v))
    l_safe = jnp.where(l == 0.0, 1.0, l)
    return _bf16(acc / l_safe[..., None]), m + jnp.log(l_safe)


def _jnp_dkv_rounded(q, k, v, do, lse, delta, keep, scale, causal, rate):
    """``_bwd_dkv_kernel``'s function, dense, the dropped pᵀ and dsᵀ
    rounded to bf16 before ``dv += pᵀ do`` and ``dk += dsᵀ q``."""
    p = jnp.exp(_jnp_scores(q, k, scale, causal) - jnp.asarray(lse)[..., None])
    dp = jnp.einsum("bqd,bkd->bqk", jnp.asarray(do), jnp.asarray(v))
    pd = p
    if keep is not None:
        inv = 1.0 / (1.0 - rate)
        pd = jnp.where(keep, p * inv, 0.0)
        dp = jnp.where(keep, dp * inv, 0.0)
    dv = jnp.einsum("bqk,bqd->bkd", _bf16(pd), jnp.asarray(do))
    ds = p * (dp - jnp.asarray(delta)[..., None]) * scale
    dk = jnp.einsum("bqk,bqd->bkd", _bf16(ds), jnp.asarray(q))
    return _bf16(dk), _bf16(dv)


def _exact_case(seed: int, sq: int, sk: int, d: int, causal: bool,
                bh: int = 2):
    """numpy ``(q, k, v, do, lse, delta)`` on which torch and XLA agree bit
    for bit up to the products' summation order (module docstring): at
    scale 1/8 every score is 200 (q and k hot on one coordinate) or 0, lse
    is the row's max score, so ``p`` is exactly 1 or 0."""
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


#: (sq, sk, causal)
GEOMETRIES = {"causal": (256, 256, True), "full": (256, 256, False),
              "sq_gt_sk": (384, 256, False), "sq_lt_sk": (128, 384, False)}


@pytest.mark.parametrize("rate", [0.0, RATE])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("geometry", ["causal", "full", "sq_lt_sk"])
def test_rounded_fwd_plain_matches_jnp_construction(geometry, d, rate):
    sq, sk, causal = GEOMETRIES[geometry]
    q, k, v, *_ = _exact_case(d + sk, sq, sk, d, causal)
    seed, scale = 31, EXACT_SCALE
    want = _jnp_fwd_rounded(q, k, v, _keep(seed, q, k, rate), scale, causal,
                            rate)
    ops = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]
    got = FA.fwd_plain(*ops, seed, scale, causal, rate, round_operands=True)
    assert got[0].dtype == torch.bfloat16 and got[1].dtype == torch.float32
    for g, w, name in zip(got, want, ("out", "lse")):
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w),
                                   err_msg=name, **F32)
    if rate > 0.0:  # the kept p = 1/0.9 rounds to bf16: a visible change
        unrounded = FA.fwd_plain(*ops, seed, scale, causal, rate)[0]
        assert float((unrounded.float() - got[0].float()).abs().max()) > 1e-3


@pytest.mark.parametrize("rate", [0.0, RATE])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_rounded_dkv_plain_matches_jnp_construction(geometry, d, rate):
    sq, sk, causal = GEOMETRIES[geometry]
    arrays = _exact_case(3 * d + sq, sq, sk, d, causal)
    seed, scale = 57, EXACT_SCALE
    q, k = arrays[:2]
    want = _jnp_dkv_rounded(*arrays, _keep(seed, q, k, rate), scale, causal,
                            rate)
    ops = [torch.from_numpy(a) for a in arrays]
    ops[:4] = [t.to(torch.bfloat16) for t in ops[:4]]
    got = FA.bwd_dkv_plain(*ops, seed, scale, causal, rate,
                           round_operands=True)
    for g, w, name in zip(got, want, ("dk", "dv")):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w),
                                   err_msg=name, **F32)
    # dS carries ~20 bits here, so its rounding moves dk; the kept
    # p = 1/0.9 moves dv only under dropout
    unrounded = FA.bwd_dkv_plain(*ops, seed, scale, causal, rate)
    diff = [float((u.float() - g.float()).abs().max())
            for u, g in zip(unrounded, got)]
    assert diff[0] > 1e-3
    if rate > 0.0:
        assert diff[1] > 1e-3


def _fwd_before(q3, k3, v3, seed, scale, causal, rate):
    """``fwd_plain`` as it was before ``round_operands``."""
    s = FA._scores(q3, k3, scale, causal)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    if rate > 0.0:
        keep = FA.dropout_keep(seed, q3.shape[0], q3.shape[1], k3.shape[1],
                               rate, q3.device)
        p = torch.where(keep, p / (1.0 - rate), torch.zeros_like(p))
    acc = torch.einsum("bqk,bkd->bqd", p, v3.float())
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    return (acc / l_safe[..., None]).to(q3.dtype), m + torch.log(l_safe)


def _dkv_before(q3, k3, v3, do, lse, delta, seed, scale, causal, rate):
    """``bwd_dkv_plain`` as it was before ``round_operands``."""
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
    return dk.to(k3.dtype), dv.to(v3.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.0, RATE])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_versions_unchanged_with_the_keyword_off(causal, rate, dtype):
    arrays = _case(5, 256, 256, 64, causal)
    q, k, v, do, lse, delta = (torch.from_numpy(a) for a in arrays)
    q, k, v, do = (t.to(dtype) for t in (q, k, v, do))
    args = (19, 0.125, causal, rate)
    for got, want in zip(FA.fwd_plain(q, k, v, *args),
                         _fwd_before(q, k, v, *args)):
        assert torch.equal(got, want)
    for got, want in zip(FA.bwd_dkv_plain(q, k, v, do, lse, delta, *args),
                         _dkv_before(q, k, v, do, lse, delta, *args)):
        assert torch.equal(got, want)
    # the fused and dq plain versions share the helper: unchanged too
    dq, dk, dv = FA.bwd_plain(q, k, v, do, lse, delta, *args)
    for got, want in zip((dk, dv), _dkv_before(q, k, v, do, lse, delta,
                                               *args)):
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
    arrays = _case(11, 256, 256, 128, causal)
    q, k, v, do, lse, delta = (torch.from_numpy(a) for a in arrays)
    q, k, v, do = (t.to(dtype) for t in (q, k, v, do))
    args = (23, 128 ** -0.5, causal, rate)
    rounded = FA.fwd_plain(q, k, v, *args, round_operands=True)
    unrounded = FA.fwd_plain(q, k, v, *args)
    assert rounded[0].dtype == dtype
    assert _drift(rounded[0], unrounded[0]) <= DRIFT
    assert torch.equal(rounded[1], unrounded[1])  # lse: unrounded p
    rounded = FA.bwd_dkv_plain(q, k, v, do, lse, delta, *args,
                               round_operands=True)
    unrounded = FA.bwd_dkv_plain(q, k, v, do, lse, delta, *args)
    for r, u in zip(rounded, unrounded):
        assert r.dtype == dtype
        assert 0.0 < _drift(r, u) <= DRIFT  # rounding moves it, boundedly


@pytest.mark.parametrize("dtype,head_dim,tc", [
    (torch.bfloat16, 64, True), (torch.bfloat16, 128, True),
    (torch.float16, 64, True), (torch.float16, 128, True),
    (torch.bfloat16, 256, False), (torch.float16, 256, False),
    (torch.float32, 64, False), (torch.float32, 128, False),
    (torch.float32, 256, False)])
def test_route_is_a_dispatch_on_dtype_and_head_dim(dtype, head_dim, tc):
    assert FA.tc_route(dtype, head_dim) is tc


def test_cpu_calls_count_no_launch_of_either_route():
    from fleetx_tpu_torch.kernels import build

    for fn in (FA.fwd_call, FA.bwd_dkv_call):
        fn.launches = fn.tc_launches = 0
    rng = np.random.RandomState(2)
    q, k, v = (torch.tensor(rng.randn(1, 128, 2, 64).astype(np.float32))
               .to(torch.bfloat16).requires_grad_(True) for _ in range(3))
    out = FA.flash_attention(q, k, v, fused_bwd=False, dropout_rate=RATE,
                             dropout_seed=3)
    out.float().sum().backward()
    for fn in (FA.fwd_call, FA.bwd_dkv_call):
        assert fn.launches == fn.tc_launches == 0
    assert "flash_attention" not in build.loaded()


def test_library_key_follows_every_header(tmp_path, monkeypatch):
    """An edited ``csrc/*.cuh`` changes every library's key, so the next
    call rebuilds; an unchanged tree keeps its key."""
    from fleetx_tpu_torch.kernels import build

    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC_DIR, csrc)
    monkeypatch.setattr(build, "CSRC_DIR", str(csrc))
    before = {n: build.library_path(n) for n in build.SOURCES}
    assert before == {n: build.library_path(n) for n in build.SOURCES}
    headers = sorted(n for n in os.listdir(csrc) if n.endswith(".cuh"))
    assert "hopper.cuh" in headers
    with open(csrc / "hopper.cuh", "a") as f:
        f.write("// edited\n")
    after = {n: build.library_path(n) for n in build.SOURCES}
    assert all(after[n] != before[n] for n in build.SOURCES)
    # a new header beside the sources changes the key as well
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert build.library_path("flash_attention") != after["flash_attention"]
