"""Port parity: paged-attention decode (``fleetx_tpu_torch/ops``).

The same numpy inputs, made from a seed, go through the JAX package's
Pallas kernel (interpret mode on the CPU, as its own serving tests run
it) and through the port's ``paged_call`` / ``paged_attention`` on CPU
tensors, which run the kernel's plain PyTorch version. The CUDA kernel
itself is held to that plain version on the card by ``chip_smoke.py``.

Tolerances:

- ``acc`` / ``m`` / ``l`` agree within atol = rtol = 1e-5 in BOTH dtypes:
  both sides cast q and k to f32 before any arithmetic, so bf16 inputs
  leave only f32 summation order between them;
- the normalised bf16 output agrees within one bf16 ulp (rtol 2**-7):
  values that agree to 1e-6 in f32 can round to neighbouring bf16 values;
- the gather path computes scores and products in the compute dtype on
  both sides, with the same operations in the same order; in bf16 it is
  held to one bf16 ulp (rtol 2**-7), the room for one rounding that
  lands on the other side of a tie (on the CPU the two agree exactly).
"""

import ctypes
import importlib
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fleetx_tpu.ops import paged_attention as JPA
from fleetx_tpu.serving import decode as JD
from fleetx_tpu_torch.ops import paged_attention as PA
from fleetx_tpu_torch.serving import decode as TD
from fleetx_tpu_torch.serving.paged_cache import NULL_PAGE

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

B, NH, HD, PS, P, PAGES = 5, 4, 16, 4, 6, 20
#: ragged lens: crosses page boundaries (13), a lone first position (0),
#: an inactive row (-1), the last slot of a page (7), the full table (23)
LENS = [13, 0, -1, 7, P * PS - 1]

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _case(seed: int):
    """q, pools, raw block tables (NULL_PAGE tails) and lens as numpy."""
    rng = np.random.RandomState(seed)
    q = rng.randn(B, NH, HD).astype(np.float32)
    pk = rng.randn(PAGES, PS, NH, HD).astype(np.float32)
    pv = rng.randn(PAGES, PS, NH, HD).astype(np.float32)
    tables = np.full((B, P), NULL_PAGE, np.int32)
    free = list(rng.permutation(np.arange(1, PAGES)))
    for b, n in enumerate(LENS):
        used = -(-(n + 1) // PS) if n >= 0 else 0
        tables[b, :used] = [free.pop() for _ in range(used)]
    # pages shared between rows: row 3 reads row 0's first two pages
    tables[3, :2] = tables[0, :2]
    return q, pk, pv, tables, np.asarray(LENS, np.int32)


def _both(arrs, dtype_name):
    jd, td = DTYPES[dtype_name]
    j = [jnp.asarray(a).astype(jd) if a.dtype == np.float32
         else jnp.asarray(a) for a in arrs]
    t = [torch.from_numpy(a).to(td) if a.dtype == np.float32
         else torch.from_numpy(a) for a in arrs]
    return j, t


def _f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32)) \
        if not isinstance(x, torch.Tensor) else x.float().numpy()


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("seed", [0, 1])
def test_paged_call_matches_pallas_kernel(dtype_name, seed):
    """Raw (acc, m, l) against ``_paged_call`` on localized tables."""
    q, pk, pv, tables, lens = _case(seed)
    local = np.where(tables != NULL_PAGE, tables, -1).astype(np.int32)
    (jq, jk, jv, jt, jl), (tq, tk, tv, tt, tl) = _both(
        [q, pk, pv, local, lens], dtype_name)
    j_acc, j_m, j_l = JPA._paged_call(jq, jk, jv, jt, jl)
    t_acc, t_m, t_l = PA.paged_call(tq, tk, tv, tt, tl)
    for name, j, t in (("acc", j_acc, t_acc), ("m", j_m, t_m),
                       ("l", j_l, t_l)):
        assert t.dtype == torch.float32, name
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    inactive = LENS.index(-1)
    assert (t_acc[inactive] == 0).all() and (t_l[inactive] == 0).all()
    assert (t_m[inactive] == -1e30).all()


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_paged_attention_matches_pallas_wrapper(dtype_name):
    """Normalised output from raw tables with NULL_PAGE tails; lens = -1
    rows are exact zeros on both sides."""
    q, pk, pv, tables, lens = _case(2)
    (jq, jk, jv, jt, jl), (tq, tk, tv, tt, tl) = _both(
        [q, pk, pv, tables, lens], dtype_name)
    j_out = JPA.paged_attention(jq, jk, jv, jt, jl)
    t_out = PA.paged_attention(tq, tk, tv, tt, tl)
    assert t_out.dtype == DTYPES[dtype_name][1]
    rtol = 1e-5 if dtype_name == "float32" else 2.0 ** -7
    np.testing.assert_allclose(_f32(t_out), _f32(j_out), rtol=rtol,
                               atol=1e-5)
    inactive = LENS.index(-1)
    assert (_f32(t_out)[inactive] == 0).all()
    assert (_f32(j_out)[inactive] == 0).all()
    # lens = 0: the row attends to its first position alone
    first = LENS.index(0)
    np.testing.assert_allclose(
        _f32(t_out)[first], _f32(tv[int(tables[first, 0]), 0]), rtol=rtol,
        atol=1e-5)


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_gather_path_matches_jax(dtype_name):
    """``serving/decode.py:_paged_attention`` over the gathered view,
    decode (S=1) and a prefill-like chunk (S=3)."""
    rng = np.random.RandomState(3)
    K = P * PS
    for S in (1, 3):
        q = rng.randn(B, S, NH, HD).astype(np.float32)
        kd = rng.randn(B, K, NH, HD).astype(np.float32)
        vd = rng.randn(B, K, NH, HD).astype(np.float32)
        q_pos = rng.randint(0, K, size=(B, S)).astype(np.int32)
        (jq, jk, jv, jp), (tq, tk, tv, tp) = _both([q, kd, vd, q_pos],
                                                   dtype_name)
        j_out = JD._paged_attention(jq, jk, jv, jp)
        t_out = TD._paged_attention(tq, tk, tv, tp.long())
        rtol = 1e-5 if dtype_name == "float32" else 2.0 ** -7
        np.testing.assert_allclose(_f32(t_out), _f32(j_out), rtol=rtol,
                                   atol=1e-5)


def test_kernel_predicate_admits_345m_geometry():
    geo = dict(num_heads=16, head_dim=64, page_size=16, pages_per_req=64)
    assert PA.paged_attention_supported(**geo, dtype=torch.bfloat16)
    assert PA.paged_attention_supported(**geo, dtype=torch.float32)
    assert not PA.paged_attention_supported(**dict(geo, head_dim=12))
    assert not PA.paged_attention_supported(**dict(geo, head_dim=512))
    assert not PA.paged_attention_supported(**dict(geo, page_size=0))
    assert not PA.paged_attention_supported(**geo, dtype=torch.float16)
    assert PA.NULL_PAGE == NULL_PAGE


def test_import_builds_nothing_and_never_falls_back(monkeypatch):
    """Importing the module and running it on CPU tensors starts no
    compiler (the split plain version and the planner included, and no
    kernel workspace is allocated); a tensor on a device with no kernel
    raises instead of running the plain version; the entry point is
    declared with the split kernel's argument list."""
    from fleetx_tpu_torch.kernels import build

    def no_compiler(*a, **k):
        raise AssertionError("a kernel build started")

    monkeypatch.setattr(build.subprocess, "Popen", no_compiler)
    mod = importlib.reload(PA)
    q, pk, pv, tables, lens = _case(4)
    _, (tq, tk, tv, tt, tl) = _both([q, pk, pv, tables, lens], "float32")
    launches = mod.paged_call.launches
    mod.paged_attention(tq, tk, tv, tt, tl)
    local = mod._localize_tables(tt, tk.shape[0])
    mod.paged_call_plain_split(tq, tk, tv, local, tl, 2)
    assert mod._plan_for(tq, tk, local).route == "plain"
    assert mod.paged_call.launches == launches  # the plain version ran
    assert "paged_attention" not in build.loaded()
    assert mod._workspaces == {}
    with pytest.raises(ValueError, match="no kernel for device"):
        mod.paged_call(tq.to("meta"), tk.to("meta"), tv.to("meta"),
                       tt.to("meta"), tl.to("meta"))
    # ten pointers (q, both pools, tables, lens, acc, m, l, the workspace,
    # the counters), eleven ints (batch, heads, head_dim, pages, page size,
    # pages per request, head block, rows per tile, pages per chunk, ring
    # slots, dtype), the scale and the stream
    lib = types.SimpleNamespace(fleetx_paged_attention_decode=(
        types.SimpleNamespace(argtypes=None, restype=None)))
    monkeypatch.setattr(build, "load", lambda name: lib)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    assert mod._kernel_fn().argtypes == ([ptr] * 10 + [i32] * 11
                                         + [ctypes.c_float, ptr])
