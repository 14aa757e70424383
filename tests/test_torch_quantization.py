"""Port parity: int8 fake-quant (``fleetx_tpu_torch/ops/quantization.py``
against ``fleetx_tpu/ops/quantization.py``).

The same numpy inputs go through the JAX function (eager, op by op) and
the port. Tolerances: f32 bitwise (the same ops in the same order; both
round half to even); bf16 within one bf16 ulp of each output element's
magnitude (the final ``x + (q - x)`` rounds twice in bf16, and a fused
XLA computation may keep f32 between the two), the scales bitwise; the
straight-through gradient exactly the identity.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from fleetx_tpu.ops import quantization as JQ
from fleetx_tpu_torch.ops import quantization as TQ

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

#: (shape, reduced axis) pairs: per tensor, and the serving decode's
#: per-output-channel reductions of the four kernels (qkv ``[h, 3, nh,
#: hd]`` axis 0, out ``[nh, hd, h]`` axes (0, 1), wi / wo axis 0) and of
#: their stacked ``[layers, ...]`` leaves
CASES = [((64, 48), None), ((16, 3, 4, 8), 0), ((4, 8, 16), (0, 1)),
         ((33, 65), 0), ((2, 16, 3, 4, 8), (1,)), ((2, 4, 8, 16), (1, 2)),
         ((3, 1, 40), None)]


def _pair(x: np.ndarray, dtype: str):
    return (jnp.asarray(x).astype(dtype),
            torch.from_numpy(x).to(getattr(torch, dtype)))


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


@pytest.mark.parametrize("shape,axis", CASES)
@pytest.mark.parametrize("bits", [8, 4])
def test_fake_quant_f32_bitwise(shape, axis, bits):
    x = (np.random.RandomState(sum(shape)).randn(*shape) * 3).astype(
        np.float32)
    jx, tx = _pair(x, "float32")
    want = _np(JQ.fake_quant(jx, bits, axis))
    got = _np(TQ.fake_quant(tx, bits, axis))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape,axis", CASES)
def test_fake_quant_bf16_within_one_ulp(shape, axis):
    x = (np.random.RandomState(7 + sum(shape)).randn(*shape) * 5).astype(
        np.float32)
    jx, tx = _pair(x, "bfloat16")
    want = _np(JQ.fake_quant(jx, 8, axis))
    got = _np(TQ.fake_quant(tx, 8, axis))
    jitted = _np(jax.jit(lambda v: JQ.fake_quant(v, 8, axis))(jx))
    ulp = np.spacing(np.abs(want).astype(ml_dtypes.bfloat16)).astype(
        np.float32)
    for ref in (want, jitted):
        assert np.all(np.abs(got - ref) <= ulp), np.abs(got - ref).max()
    # the scales themselves agree bit for bit
    red = tuple(range(x.ndim)) if axis is None else axis
    j_amax = jnp.max(jnp.abs(jx), axis=red, keepdims=axis is not None)
    j_scale = _np(jnp.maximum(j_amax / 127.0, 1e-8).astype(jx.dtype))
    dims = tuple(range(x.ndim)) if axis is None else \
        ((axis,) if isinstance(axis, int) else tuple(axis))
    t_amax = tx.abs().amax(dim=dims, keepdim=axis is not None)
    t_scale = torch.maximum(
        t_amax / torch.tensor(127.0, dtype=torch.bfloat16),
        torch.tensor(1e-8, dtype=torch.bfloat16))
    np.testing.assert_array_equal(_np(t_scale), j_scale)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_weight_and_act_match_jax(dtype):
    rng = np.random.RandomState(3)
    w = rng.randn(24, 3, 2, 8).astype(np.float32)
    a = rng.randn(2, 5, 24).astype(np.float32)
    for out_axis in (-1, 0, 1):
        jw, tw = _pair(w, dtype)
        np.testing.assert_array_equal(
            _np(TQ.quantize_weight(tw, 8, out_axis)),
            _np(JQ.quantize_weight(jw, 8, out_axis)))
    ja, ta = _pair(a, dtype)
    np.testing.assert_array_equal(_np(TQ.quantize_act(ta, 8)),
                                  _np(JQ.quantize_act(ja, 8)))
    # per tensor == fake_quant over no axis
    np.testing.assert_array_equal(_np(TQ.quantize_act(ta)),
                                  _np(TQ.fake_quant(ta, 8, None)))


def test_exact_half_ties_round_to_even():
    """amax 127 makes the scale exactly 1: every x.5 is a tie, and both
    sides round it to the even neighbour."""
    x = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5, 126.5],
                 np.float32)
    jx, tx = _pair(x, "float32")
    got = _np(TQ.fake_quant(tx))
    np.testing.assert_array_equal(got, _np(JQ.fake_quant(jx)))
    np.testing.assert_array_equal(
        got, [127.0, 0.0, 2.0, 2.0, -0.0, -2.0, -2.0, 4.0, 126.0])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_all_zero_tensor_takes_the_floor(dtype):
    """An all-zero tensor's scale is the 1e-8 floor: zeros out, no NaN."""
    x = np.zeros((4, 6), np.float32)
    jx, tx = _pair(x, dtype)
    for axis in (None, 0):
        got = _np(TQ.fake_quant(tx, 8, axis))
        assert np.all(got == 0.0) and not np.isnan(got).any()
        np.testing.assert_array_equal(got, _np(JQ.fake_quant(jx, 8, axis)))


def test_straight_through_gradient_is_identity():
    rng = np.random.RandomState(5)
    x = rng.randn(6, 10).astype(np.float32)
    w = rng.randn(6, 10).astype(np.float32)
    tx = torch.from_numpy(x).requires_grad_(True)
    for axis in (None, 0, (0, 1)):
        (g,) = torch.autograd.grad(
            (TQ.fake_quant(tx, 8, axis) * torch.from_numpy(w)).sum(), tx)
        np.testing.assert_array_equal(g.numpy(), w)
        jg = jax.grad(lambda v: jnp.sum(JQ.fake_quant(v, 8, axis) * w))(
            jnp.asarray(x))
        np.testing.assert_array_equal(g.numpy(), np.asarray(jg))
