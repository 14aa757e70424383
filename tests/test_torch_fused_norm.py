"""Port parity: fused residual-add + f32 LayerNorm (``fleetx_tpu_torch/ops/
fused_norm.py``).

The same numpy inputs, made from a seed, go through the JAX package's
Pallas kernels ``_fwd_call`` / ``_bwd_call`` (interpret mode on the CPU,
as its own tests run them) and through the port's ``fwd_call`` /
``bwd_call`` on CPU tensors, which run the kernels' plain PyTorch
versions. The CUDA kernels are held to those plain versions on the card
by ``chip_smoke.py``.

Tolerances:

- f32: atol 1e-5 (rtol 1e-5) everywhere: the same operations in the same
  order, summed by another library;
- bf16 operands: the statistics and every intermediate are f32 on both
  sides; a bf16 output may land one bf16 ulp apart (rtol 2**-7) when f32
  values that agree to 1e-6 straddle a rounding boundary.
- bf16 with a residual: ``s = residual + x`` is bit-identical on both
  sides, but XLA's CPU lowering of the interpret-mode kernel folds the
  bf16 round trip ``f32(bf16(r + x))`` away and takes the statistics of
  the UNrounded sum, while the port normalises the rounded ``s`` (as
  ``_fwd_kernel``'s source reads, and as the port's unfused path does).
  So the port's ``out``/``mean``/``var`` are held to the Pallas kernel
  run on that rounded ``s``, within the bf16 tolerance above.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fleetx_tpu.ops import fused_norm as JFN
from fleetx_tpu_torch.ops import fused_norm as FN

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

SHAPE = (2, 16, 128)
EPS = 1e-5
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(name: str) -> dict:
    return (dict(rtol=1e-5, atol=1e-5) if name == "float32"
            else dict(rtol=2.0 ** -7, atol=1e-5))


def _case(seed: int, shape=SHAPE):
    rng = np.random.RandomState(seed)
    hidden = shape[-1]
    return (rng.randn(*shape).astype(np.float32),
            rng.randn(*shape).astype(np.float32),
            (1.0 + 0.1 * rng.randn(hidden)).astype(np.float32),
            (0.1 * rng.randn(hidden)).astype(np.float32),
            rng.randn(*shape).astype(np.float32))


def _j(a, jdt):
    return jnp.asarray(a).astype(jdt)


def _t(a, tdt):
    return torch.from_numpy(np.array(a)).to(tdt)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, **tol) -> None:
    np.testing.assert_allclose(_np(got), _np(want), **tol)


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_plain_matches_pallas_kernel(dtype, residual):
    jdt, tdt = DTYPES[dtype]
    x, r, scale, bias, _ = _case(1)
    j_out = JFN._fwd_call(_j(x, jdt), _j(r, jdt) if residual else None,
                          jnp.asarray(scale), jnp.asarray(bias), EPS, jdt)
    if residual and dtype == "bfloat16":
        s_rounded = j_out[1]
        j_out = JFN._fwd_call(s_rounded, None, jnp.asarray(scale),
                              jnp.asarray(bias), EPS, jdt)
        j_out = (j_out[0], s_rounded, j_out[2], j_out[3])
    t_out = FN.fwd_call(_t(x, tdt), _t(r, tdt) if residual else None,
                        _t(scale, torch.float32), _t(bias, torch.float32),
                        EPS, tdt)
    for name, got, want in zip(("out", "s", "mean", "var"), t_out, j_out):
        assert tuple(got.shape) == tuple(want.shape), name
        _close(got, want, **_tol(dtype))
    assert t_out[0].dtype == tdt and t_out[1].dtype == tdt
    assert t_out[2].dtype == torch.float32


@pytest.mark.parametrize("with_dsin", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_plain_matches_pallas_kernel(dtype, with_dsin):
    jdt, tdt = DTYPES[dtype]
    x, r, scale, bias, dout = _case(2)
    ds_in = np.random.RandomState(3).randn(*SHAPE).astype(np.float32)
    _, s, mean, var = JFN._fwd_call(_j(x, jdt), _j(r, jdt),
                                    jnp.asarray(scale), jnp.asarray(bias),
                                    EPS, jdt)
    j_dx = JFN._bwd_call(s, jnp.asarray(scale), mean, var, _j(dout, jdt), EPS,
                         ds_in=_j(ds_in, jdt) if with_dsin else None)
    t_dx = FN.bwd_call(_t(np.asarray(s.astype(jnp.float32)), tdt),
                       _t(scale, torch.float32), _t(mean, torch.float32),
                       _t(var, torch.float32), _t(dout, tdt), EPS,
                       ds_in=_t(ds_in, tdt) if with_dsin else None)
    assert t_dx.dtype == tdt
    _close(t_dx, j_dx, **_tol(dtype))


@pytest.mark.parametrize("residual", [False, True])
def test_autograd_matches_jax_grad(residual):
    """dx (and dresidual), dscale, dbias through the port's autograd
    wrapper against ``jax.grad`` of ``fused_residual_norm`` (f32)."""
    x, r, scale, bias, dout = _case(4)
    ds_in = np.random.RandomState(5).randn(*SHAPE).astype(np.float32)

    def j_loss(x, r, scale, bias):
        out, s = JFN.fused_residual_norm(x, scale, bias,
                                         residual=r if residual else None,
                                         eps=EPS, out_dtype=jnp.float32)
        loss = (out * dout).sum()
        return loss + (s * ds_in).sum() if residual else loss

    j_grads = jax.grad(j_loss, argnums=(0, 1, 2, 3))(
        jnp.asarray(x), jnp.asarray(r), jnp.asarray(scale),
        jnp.asarray(bias))
    tx, tr, ts, tb = (torch.tensor(a, requires_grad=True)
                      for a in (x, r, scale, bias))
    out, s = FN.fused_residual_norm(tx, ts, tb,
                                    residual=tr if residual else None,
                                    eps=EPS, out_dtype=torch.float32)
    loss = (out * torch.from_numpy(dout)).sum()
    if residual:
        loss = loss + (s * torch.from_numpy(ds_in)).sum()
    loss.backward()
    _close(tx.grad, j_grads[0], rtol=1e-5, atol=1e-5)
    if residual:
        _close(tr.grad, j_grads[1], rtol=1e-5, atol=1e-5)
    else:
        assert tr.grad is None
    _close(ts.grad, j_grads[2], rtol=1e-5, atol=1e-5)
    _close(tb.grad, j_grads[3], rtol=1e-5, atol=1e-5)


SHAPES = [(4, 8, 128), (2, 3, 256), (16, 1024), (2, 8, 64), (2, 8, 200),
          (2, 8, 1024), (3, 384), (128,)]


@pytest.mark.parametrize("shape", SHAPES)
def test_gate_answers_as_jax_where_vmem_does_not_bind(shape):
    """Same shapes take the kernel on both sides (shapes small enough that
    the TPU's VMEM budget never decides)."""
    for dtype in ("float32", "bfloat16"):
        jdt, tdt = DTYPES[dtype]
        jx = jnp.zeros(shape, jdt)
        tx = torch.zeros(shape, dtype=tdt)
        assert FN.fused_norm_supported(tx) == JFN.fused_norm_supported(jx)
        assert FN.fused_norm_supported(tx, tx) == \
            JFN.fused_norm_supported(jx, jx)
    tx = torch.zeros(shape)
    assert not FN.fused_norm_supported(tx, torch.zeros(shape,
                                                       dtype=torch.bfloat16))
    assert not FN.fused_norm_supported(tx.to(torch.float64))


def test_cpu_runs_plain_version_and_counts_no_launch():
    from fleetx_tpu_torch.kernels import build

    FN.fwd_call.launches = FN.bwd_call.launches = 0
    x, r, scale, bias, dout = (torch.from_numpy(a) for a in _case(6))
    out, s, mean, var = FN.fwd_call(x, r, scale, bias, EPS, torch.float32)
    FN.bwd_call(s, scale, mean, var, dout, EPS, ds_in=x)
    assert FN.fwd_call.launches == FN.bwd_call.launches == 0
    assert "fused_norm" not in build.loaded()


def test_device_without_kernel_raises_instead_of_falling_back():
    x = torch.zeros(SHAPE, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        FN.fwd_call(x, None, torch.ones(128), torch.zeros(128), EPS,
                    torch.float32)
    with pytest.raises(ValueError, match="no kernel for device"):
        FN.bwd_call(x, torch.ones(128), x[..., :1], x[..., :1], x, EPS)
