"""Port parity: fused residual-add + f32 LayerNorm (``fleetx_tpu_torch/ops/
fused_norm.py``).

The same numpy inputs, made from a seed, go through the JAX package's
Pallas kernels ``_fwd_call`` / ``_bwd_call`` (interpret mode on the CPU,
as its own tests run them) and through the port's ``fwd_call`` /
``bwd_call`` on CPU tensors, which run the kernels' plain PyTorch
versions. The CUDA kernels are held to those plain versions on the card
by ``chip_smoke.py``. The forward's planner (``plan_fwd``: its route,
shared memory, grid and row coverage at every admitted width) and its
launch path (the checks, the entry's arguments against a recording
stand-in, the eager non-grad path, an export still recording the custom
op) are checked here without a card.

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


# ---------------------------------------------------------------- planner
#: the forward's (input, output) dtype pairs
DTYPE_PAIRS = [(torch.float32, torch.float32),
               (torch.bfloat16, torch.bfloat16),
               (torch.bfloat16, torch.float32),
               (torch.float16, torch.float16),
               (torch.float16, torch.float32)]
#: H100 SXM
SMS = 132


def _walk(plan, rows: int) -> list:
    """The rows each (block, consumer warp, stage) of a "rows" launch
    takes, as ``csrc/fused_norm.cu``'s loops walk them: block b takes
    tiles b, b + grid, ...; its iteration j goes to warp j % warps and
    stage j % stages."""
    n_tiles = -(-rows // plan.rows_per_tile)
    taken = []
    for b in range(plan.grid):
        j = 0
        while b + j * plan.grid < n_tiles:
            t = b + j * plan.grid
            first = t * plan.rows_per_tile
            for row in range(first, min(first + plan.rows_per_tile, rows)):
                taken.append((row, b, j % plan.warps, j % plan.stages))
            j += 1
    return taken


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("pair", range(len(DTYPE_PAIRS)))
def test_plan_fwd_routes_every_admitted_width(pair, residual):
    """Every hidden the gate admits (128..32768 step 128) gets a route:
    "rows" up to 4096 with a launch the kernel takes (its shared memory
    within the block's 232,448 bytes and equal to ``rows_smem_bytes``,
    every bulk copy a multiple of 16 bytes, stages a multiple of the
    warps), "row_block" above."""
    dtype, out_dtype = DTYPE_PAIRS[pair]
    item = dtype.itemsize
    for hidden in range(128, FN.MAX_HIDDEN + 1, 128):
        x = torch.empty((2, 128), dtype=dtype)
        assert FN.fused_norm_supported(x.new_empty((2, hidden)))
        for rows in (1, 8195):
            plan = FN.plan_fwd(rows, hidden, dtype, out_dtype, residual,
                               SMS)
            if hidden > FN.ROWS_MAX_HIDDEN:
                assert plan.route == "row_block" and plan.grid == rows
                assert plan.smem_bytes == 0 and plan.code == 0
                assert 1 <= plan.warps <= 32
                continue
            assert plan.route == "rows", hidden
            assert plan.smem_bytes <= FN.SMEM_MAX == 232448
            assert plan.smem_bytes == FN.rows_smem_bytes(
                hidden, item, residual, plan.rows_per_tile, plan.stages)
            # one row's copy, and a tile's (a partial last tile copies
            # whole rows)
            assert (hidden * item) % 16 == 0
            assert (plan.rows_per_tile * hidden * item) % 16 == 0
            assert 1 <= plan.warps <= 8 and 1 <= plan.stages <= 32
            assert plan.stages % plan.warps == 0
            assert plan.rows_per_tile * hidden * item * (1 + residual) \
                < 2 ** 20
            assert 1 <= plan.grid <= -(-rows // plan.rows_per_tile)
            assert plan.code == (1 | plan.warps << 4 | plan.stages << 8
                                 | plan.rows_per_tile << 16)


@pytest.mark.parametrize("rows", [1, 7, 8192, 8195])
def test_plan_fwd_grid_covers_every_row_once(rows):
    """The grid lies between 1 and the tiles, every row is normalised by
    exactly one consumer warp, and a stage always returns to the warp that
    read it last (no wait can pass on a stale mbarrier phase)."""
    for hidden, dtype, residual in ((128, torch.bfloat16, False),
                                    (1024, torch.bfloat16, True),
                                    (2048, torch.float32, True),
                                    (4096, torch.float16, False)):
        plan = FN.plan_fwd(rows, hidden, dtype, dtype, residual, SMS)
        n_tiles = -(-rows // plan.rows_per_tile)
        assert 1 <= plan.grid <= n_tiles
        taken = _walk(plan, rows)
        assert sorted(row for row, *_ in taken) == list(range(rows))
        stage_warp = {}
        for _, b, warp, stage in taken:
            assert stage_warp.setdefault((b, stage), warp) == warp


MAIN_PATH_SHAPES = [
    ("345M", (8, 1024, 1024), torch.bfloat16, True),
    ("345M ln_f", (8, 1024, 1024), torch.bfloat16, False),
    ("seq 8192", (2, 8192, 2048), torch.bfloat16, True),
    ("decode", (8, 1, 1024), torch.bfloat16, True),
    ("345M fp16", (8, 1024, 1024), torch.float16, True),
    ("345M f32", (8, 1024, 1024), torch.float32, True),
    ("1.3B", (8, 1024, 2048), torch.bfloat16, True),
]


@pytest.mark.parametrize("name,shape,dtype,residual", MAIN_PATH_SHAPES,
                         ids=[s[0] for s in MAIN_PATH_SHAPES])
def test_main_path_shapes_plan_rows(name, shape, dtype, residual):
    rows = shape[0] * shape[1]
    plan = FN.plan_fwd(rows, shape[-1], dtype, dtype, residual, SMS)
    assert plan.route == "rows", name
    if name == "decode":  # one row a tile, one block (one warp) a row
        assert plan.rows_per_tile == 1 and plan.grid == 8
        assert plan.warps == plan.stages == 1
    else:  # every SM takes work
        assert plan.grid >= SMS
    with pytest.raises(ValueError, match="no route"):
        FN.plan_fwd(rows, 8192, dtype, dtype, residual, SMS, route="rows")


class _Entry:
    """Stand-in for the C forward entry: records its arguments."""

    def __init__(self, rc: int = 0):
        self.calls, self.rc = [], rc

    def __call__(self, *args):
        self.calls.append(args)
        return self.rc


@pytest.fixture()
def entry(monkeypatch):
    """``_fwd_launch`` on CPU tensors against a recording entry (no
    library, no card): stream 7, 132 SMs, counters and plans restored."""
    fake = _Entry()
    monkeypatch.setattr(FN, "_fns", lambda: (fake, None))
    monkeypatch.setattr(FN, "_stream", lambda index: 7)
    monkeypatch.setattr(FN, "_sm_count", lambda index: SMS)
    FN._plan.cache_clear()
    monkeypatch.setattr(FN.fwd_call, "launches", 0)
    monkeypatch.setattr(FN.fwd_call, "fp16_launches", 0)
    monkeypatch.setattr(FN.fwd_call, "rows_launches", 0)
    yield fake
    FN._plan.cache_clear()  # plans made for the stand-in's 132 SMs


def test_launch_passes_plan_and_leaves_f32_vectors_alone(entry):
    """The entry gets the eight pointers, rows, hidden, the dtype word,
    the plan word, the grid, eps and the stream; an f32 contiguous
    scale/bias on the device goes as it is, another is copied once to
    f32; the plan is made once a shape; launches count by route."""
    x = torch.zeros((8, 1, 1024), dtype=torch.bfloat16)
    r = torch.zeros_like(x)
    scale = torch.ones(1024)
    bias = torch.zeros(1024, dtype=torch.bfloat16)
    for _ in range(2):
        out, s, mean, var = FN._fwd_launch(x, r, scale, bias, 1e-5,
                                           torch.bfloat16)
    assert out.shape == s.shape == x.shape and out.dtype == torch.bfloat16
    assert mean.shape == var.shape == (8, 1, 1) and s is not x
    assert len(entry.calls) == 2
    args = entry.calls[-1]
    assert len(args) == 15
    plan = FN.plan_fwd(8, 1024, torch.bfloat16, torch.bfloat16, True, SMS)
    assert args[0] == x.data_ptr() and args[1] == r.data_ptr()
    assert args[2] == scale.data_ptr() and args[3] != bias.data_ptr()
    assert args[4:8] == (out.data_ptr(), s.data_ptr(), mean.data_ptr(),
                         var.data_ptr())
    assert args[8:13] == (8, 1024, 1 | 1 << 4, plan.code, plan.grid)
    assert args[13] == pytest.approx(1e-5) and args[14] == 7
    assert FN._plan.cache_info().currsize == 1
    FN._fwd_launch(x, None, scale, scale, 1e-5, torch.float32,
                   route="row_block")
    args = entry.calls[-1]
    assert args[1] is None and args[5] is None
    assert args[10:12] == (1 | 0 << 4, 0)
    assert FN.fwd_call.launches == 3
    assert FN.fwd_call.rows_launches == 2


def test_caller_that_drops_the_statistics_gets_none_written(entry):
    """``stats=False`` (the eager non-grad path) hands route "rows" null
    mean/var pointers and allocates none; "row_block" still writes
    them."""
    x = torch.zeros((8, 1, 1024), dtype=torch.bfloat16)
    w, b = torch.ones(1024), torch.zeros(1024)
    out, s, mean, var = FN._fwd_launch(x, x, w, b, 1e-5, torch.bfloat16,
                                       stats=False)
    assert mean is None and var is None and out.shape == x.shape
    assert entry.calls[-1][6:8] == (None, None)
    _, _, mean, var = FN._fwd_launch(x, x, w, b, 1e-5, torch.bfloat16,
                                     route="row_block", stats=False)
    assert mean.shape == var.shape == (8, 1, 1)
    assert entry.calls[-1][6:8] == (mean.data_ptr(), var.data_ptr())
    assert FN.fwd_call.launches == 2 and FN.fwd_call.rows_launches == 1


def test_lean_wrapper_still_raises(entry):
    """Every check that guards the kernel stays: dtype, shape, contiguity,
    16-byte alignment, the residual's match, the out dtype, a route past
    its width; a refused launch raises (no fallback) and counts
    nothing."""
    x = torch.zeros((4, 256))
    w, b = torch.ones(256), torch.zeros(256)

    def launch(x, r=None, out_dtype=torch.float32, **kw):
        return FN._fwd_launch(x, r, w, b, 1e-5, out_dtype, **kw)

    with pytest.raises(TypeError, match="dtype"):
        launch(x.double())
    with pytest.raises(ValueError, match="outside"):
        launch(torch.zeros((4, 200)))
    with pytest.raises(ValueError, match="contiguous"):
        launch(torch.zeros((256, 4)).t())
    flat = torch.zeros(4 * 256 + 1)
    with pytest.raises(ValueError, match="aligned"):
        launch(flat[1:].view(4, 256))
    with pytest.raises(ValueError, match="residual"):
        launch(x, torch.zeros((4, 128)))
    with pytest.raises(ValueError, match="residual"):
        launch(x, x.to(torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):
        launch(x, torch.zeros((256, 4)).t())
    with pytest.raises(ValueError, match="aligned"):
        launch(x, flat[1:].view(4, 256))
    with pytest.raises(TypeError, match="out dtype"):
        launch(x, out_dtype=torch.float16)
    with pytest.raises(ValueError, match="no route"):
        FN._fwd_launch(torch.zeros((4, 8192)), None, torch.ones(8192),
                       torch.zeros(8192), 1e-5, torch.float32, route="rows")
    with pytest.raises(ValueError, match="vector"):
        FN._fwd_launch(x, None, torch.ones(128), b, 1e-5, torch.float32)
    assert entry.calls == []
    entry.rc = 1
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        launch(x)
    assert FN.fwd_call.launches == 0
    assert FN.fwd_call.rows_launches == 0


def test_cpu_eager_call_runs_plain_version_without_library_or_op(
        monkeypatch):
    """On a CPU tensor the eager non-grad path runs ``fwd_plain`` through
    ``fwd_call`` (not the custom op's dispatch), counts no launch and
    loads no library."""
    from fleetx_tpu_torch.kernels import build

    op_calls = []
    monkeypatch.setattr(FN, "fused_norm_fwd",
                        lambda *a: op_calls.append(a) or FN.fwd_call(*a))
    monkeypatch.setattr(FN.fwd_call, "launches", 0)
    monkeypatch.setattr(FN.fwd_call, "rows_launches", 0)
    x, r, scale, bias, _ = (torch.from_numpy(a) for a in _case(7))
    out, s = FN.fused_residual_norm(x, scale, bias, residual=r, eps=EPS)
    want = FN.fwd_plain(x, r, scale, bias, EPS, torch.float32)
    torch.testing.assert_close(out, want[0], rtol=0, atol=0)
    torch.testing.assert_close(s, want[1], rtol=0, atol=0)
    assert op_calls == []
    assert FN.fwd_call.launches == 0
    assert FN.fwd_call.rows_launches == 0
    assert "fused_norm" not in build.loaded()


def test_export_trace_still_records_the_custom_op():
    """Under ``torch.export`` the same call goes through the custom op, so
    the program records ``fleetx_tpu_torch.fused_norm_fwd``."""

    class Norm(torch.nn.Module):
        def forward(self, x, r):
            return FN.fused_residual_norm(x, torch.ones(128),
                                          torch.zeros(128), residual=r,
                                          eps=EPS)[0]

    x = torch.zeros((2, 4, 128))
    program = torch.export.export(Norm(), (x, x))
    targets = {str(n.target) for n in program.graph.nodes
               if n.op == "call_function"}
    assert "fleetx_tpu_torch.fused_norm_fwd.default" in targets
