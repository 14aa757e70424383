"""Fused residual-add + f32 LayerNorm + cast: Hopper kernels, plain
versions, gate, planner and autograd wrapper.

Port of ``fleetx_tpu/ops/fused_norm.py``. The TPU kernels (``_fwd_kernel``
launched by ``_fwd_call``, ``_bwd_kernel`` launched by ``_bwd_call``) run
one VMEM-resident pass per row block. Here the same two functions are the
CUDA kernels in ``csrc/fused_norm.cu`` (built by ``kernels/build.py``,
bound with ``ctypes``). The forward has two routes, which ``plan_fwd``
picks per shape: ``"rows"`` up to hidden 4096 (a persistent grid, a warp
per row, rows brought into a shared-memory ring by bulk asynchronous
copies) and ``"row_block"`` above it (one block per row, the row in
registers). The backward is one block per row.

- ``fwd_call(x, residual, scale, bias, eps, out_dtype)`` returns
  ``(out, s, mean, var)``: ``s = residual + x`` in the input dtype (``x``
  itself without a residual), f32 mean/var over the last dim, ``out =
  ((s - mean) * rsqrt(var + eps) * scale + bias).to(out_dtype)``;
- ``bwd_call(s, scale, mean, var, dout, eps, ds_in)`` returns ``dx`` in
  ``s.dtype``, transcribing ``_bwd_kernel``'s op order (``rstd`` from the
  saved ``var + eps``, ``dxc_b`` before ``dxc_a``, ``ds_in`` joining
  first, ``dmean`` summed per branch);
- ``param_grads`` reduces ``dscale``/``dbias`` outside the kernel in
  plain torch, as ``_param_grads`` does.

On a CUDA tensor each ``*_call`` launches its kernel or raises; on a CPU
tensor it runs its plain version (``fwd_plain`` / ``bwd_plain``), which
the CPU tests hold against the Pallas kernels and ``chip_smoke.py`` holds
the kernels against on the card. ``fwd_call.launches`` and
``bwd_call.launches`` count kernel launches only, their
``fp16_launches`` the launches of the fp16 instantiation (``__half``
rows, ``Vec8<__half>`` in ``csrc/fused_norm.cu``), and
``fwd_call.rows_launches`` the forward's launches of route ``"rows"``
(the others took ``"row_block"``). The forward is also the custom op
``torch.ops.fleetx_tpu_torch.fused_norm_fwd`` (with a fake
implementation, so ``torch.export`` can record it), which
``fused_residual_norm`` calls where autograd does not record the call and
a trace may (``_traced``), and which the autograd wrappers' forwards call
too; an eager call that nothing traces launches the kernel directly,
without the statistics it would drop. The autograd forwards are save
points (``ops/save_points.py``): under the ``dots`` granularity the span
keeps their outputs and its recomputation does not launch them again.

The launch path resolves the C entry once a process, plans each shape
once, passes ``scale``/``bias`` through when they are already f32,
contiguous and aligned on the device, and reads the raw stream handle.

``fused_norm_supported`` mirrors the JAX gate where it is not about VMEM:
rank >= 2, hidden a multiple of 128 (up to 32768, what one block of at
most 1024 threads holds in registers), f32/bf16/f16, residual of the same
shape and dtype.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from fleetx_tpu_torch.ops.flash_attention import needs_grad
from fleetx_tpu_torch.ops.save_points import kept

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

#: widest row one block holds in registers (1024 threads x 32 values)
MAX_HIDDEN = 32768


def fused_norm_supported(x: torch.Tensor,
                         residual: Optional[torch.Tensor] = None) -> bool:
    """True when the fused kernels take this activation shape."""
    if x.dim() < 2:
        return False
    if residual is not None and (residual.shape != x.shape
                                 or residual.dtype != x.dtype):
        return False
    if x.dtype not in _DTYPE_CODES:
        return False
    hidden = x.shape[-1]
    return 128 <= hidden <= MAX_HIDDEN and hidden % 128 == 0


# ------------------------------------------------------------- plain
def fwd_plain(x: torch.Tensor, residual: Optional[torch.Tensor],
              scale: torch.Tensor, bias: torch.Tensor, eps: float,
              out_dtype: torch.dtype):
    """The forward kernel's function in plain PyTorch (``_fwd_kernel``)."""
    s = x if residual is None else residual + x
    x32 = s.float()
    mean = x32.mean(-1, keepdim=True)
    var = ((x32 - mean) ** 2).mean(-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    out = (y * scale.float() + bias.float()).to(out_dtype)
    return out, s, mean, var


def bwd_plain(s: torch.Tensor, scale: torch.Tensor, mean: torch.Tensor,
              var: torch.Tensor, dout: torch.Tensor, eps: float,
              ds_in: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The backward kernel's function in plain PyTorch (``_bwd_kernel``)."""
    hidden = s.shape[-1]
    s32 = s.float()
    u = var + eps
    rstd = torch.rsqrt(u)
    xc = s32 - mean
    dy = dout.float() * scale.float()
    dxc_a = dy * rstd
    drstd = (xc * dy).sum(-1, keepdim=True)
    e_res = -0.5 * (rstd / u)
    f_res = 2.0 * xc
    dxc_b = ((drstd * e_res) / hidden) * f_res
    if ds_in is not None:
        acc = (ds_in.float() + dxc_b) + dxc_a
    else:
        acc = dxc_b + dxc_a
    dmean = ((-dxc_b).sum(-1, keepdim=True)
             + (-dxc_a).sum(-1, keepdim=True))
    return (acc + dmean / hidden).to(s.dtype)


def param_grads(s: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
                dout: torch.Tensor, eps: float, scale_dtype: torch.dtype):
    """``dscale``/``dbias`` from the saved stats (``_param_grads``)."""
    lead = tuple(range(dout.dim() - 1))
    y = (s.float() - mean) * torch.rsqrt(var + eps)
    dout32 = dout.float()
    dscale = (y * dout32).sum(dim=lead).to(scale_dtype)
    dbias = dout32.sum(dim=lead).to(scale_dtype)
    return dscale, dbias


# --------------------------------------------------------------- plan
#: route "rows" (persistent warp-per-row kernel) up to this hidden; wider
#: rows take "row_block" (a block per row)
ROWS_MAX_HIDDEN = 4096
#: up to this hidden a lane holds scale, bias and its values of a row in
#: registers (4 chunks of 8); wider, scale and bias sit in shared memory
ROWS_REG_HIDDEN = 1024
#: consumer warps a block, and ring stages a consumer warp
ROWS_WARPS, ROWS_DEPTH = 4, 2
#: bytes of x (and residual) a tile aims at, and a block's ring
ROWS_TILE_BYTES, ROWS_RING_BYTES = 8192, 65536
#: resident blocks an SM the grid counts on
ROWS_BLOCKS_PER_SM = 2
#: a block's dynamic shared memory, and an SM's (the H100: 227 / 228 KB,
#: 1 KB of the SM's reserved per resident block)
SMEM_MAX, SM_SMEM, SMEM_RESERVED = 232448, 233472, 1024
_ROUTE_CODES = {"row_block": 0, "rows": 1}


class FwdPlan(NamedTuple):
    """How the forward launches at one shape: the route, the consumer
    warps a block ("row_block": the warps of its one-row block), rows a
    tile, ring stages, blocks and dynamic shared memory (bytes)."""
    route: str
    warps: int
    rows_per_tile: int
    stages: int
    grid: int
    smem_bytes: int

    @property
    def code(self) -> int:
        """The plan as the C entry's ``plan`` word."""
        return (_ROUTE_CODES[self.route] | self.warps << 4
                | self.stages << 8 | self.rows_per_tile << 16) \
            if self.route == "rows" else _ROUTE_CODES[self.route]


def rows_smem_bytes(hidden: int, itemsize: int, residual: bool,
                    rows_per_tile: int, stages: int) -> int:
    """``rows_smem_bytes`` of ``csrc/fused_norm.cu``: the mbarriers (16
    bytes a stage, padded to 128), scale and bias above
    ``ROWS_REG_HIDDEN``, and the ring."""
    bars = (16 * stages + 127) // 128 * 128
    affine = 8 * hidden if hidden > ROWS_REG_HIDDEN else 0
    tile = rows_per_tile * hidden * itemsize * (2 if residual else 1)
    return bars + affine + stages * tile


def plan_fwd(rows: int, hidden: int, dtype: torch.dtype,
             out_dtype: torch.dtype, residual: bool, sm_count: int,
             route: Optional[str] = None) -> FwdPlan:
    """The forward's launch at ``[rows, hidden]`` on a card of
    ``sm_count`` SMs: ``"rows"`` up to ``ROWS_MAX_HIDDEN``, else
    ``"row_block"`` (``route`` asks for one; ``"rows"`` past its width
    raises). ``out_dtype`` does not change the launch: the ring holds
    inputs only."""
    if out_dtype not in (dtype, torch.float32):
        raise TypeError(f"fused_norm: out dtype {out_dtype} is neither "
                        f"{dtype} nor float32")
    route = route or ("rows" if hidden <= ROWS_MAX_HIDDEN else "row_block")
    if route == "row_block":
        per_thread = 8 if hidden <= 8192 else 32
        return FwdPlan("row_block", -(-hidden // per_thread // 32), 1, 0,
                       rows, 0)
    if route != "rows" or hidden > ROWS_MAX_HIDDEN:
        raise ValueError(f"fused_norm: no route {route!r} at hidden "
                         f"{hidden}")
    itemsize = dtype.itemsize
    row_bytes = hidden * itemsize * (2 if residual else 1)
    # a tile of ~ROWS_TILE_BYTES, cut so that few rows still spread over
    # every SM's warps (one row a tile at the one-token decode shape)
    spread = -(-rows // (sm_count * ROWS_WARPS))
    rows_per_tile = max(1, min(ROWS_TILE_BYTES // row_bytes, spread))
    tile = rows_per_tile * row_bytes
    n_tiles = -(-rows // rows_per_tile)
    stages = max(2, min(ROWS_WARPS * ROWS_DEPTH, ROWS_RING_BYTES // tile))
    warps = min(ROWS_WARPS, stages)
    for _ in range(2):  # the second pass sizes a block to its tiles
        stages -= stages % warps  # a stage returns to the warp that read it
        smem = rows_smem_bytes(hidden, itemsize, residual, rows_per_tile,
                               stages)
        per_sm = max(1, min(ROWS_BLOCKS_PER_SM,
                            SM_SMEM // (smem + SMEM_RESERVED)))
        grid = min(n_tiles, per_sm * sm_count)
        per_block = -(-n_tiles // grid)
        warps = min(warps, per_block)
        stages = min(stages, -(-per_block // warps) * warps)
    smem = rows_smem_bytes(hidden, itemsize, residual, rows_per_tile, stages)
    return FwdPlan("rows", warps, rows_per_tile, stages, grid, smem)


# ------------------------------------------------------------ kernels
@functools.lru_cache(maxsize=None)
def _fns():
    """The two C entry points with their argument types declared,
    resolved once a process (the first CUDA call builds the library)."""
    from fleetx_tpu_torch.kernels import build

    lib = build.load("fused_norm")
    fwd, bwd = lib.fleetx_fused_norm_fwd, lib.fleetx_fused_norm_bwd
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fwd.argtypes = [ptr] * 8 + [i32] * 5 + [ctypes.c_float, ptr]
    fwd.restype = i32
    bwd.argtypes = [ptr] * 7 + [i32] * 3 + [ctypes.c_float, ptr]
    bwd.restype = i32
    return fwd, bwd


def _stream(index: int) -> int:
    """The current stream's raw handle on CUDA device ``index``, without
    building a ``torch.cuda.Stream``."""
    return torch._C._cuda_getCurrentRawStream(index)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _plan(rows: int, hidden: int, dtype, out_dtype, residual: bool,
          index: int, route: Optional[str]) -> tuple:
    """``plan_fwd`` of one call's shape on CUDA device ``index`` and its
    ``code``, made once a shape."""
    plan = plan_fwd(rows, hidden, dtype, out_dtype, residual,
                    _sm_count(index), route)
    return plan, plan.code


def _check(name: str, x: torch.Tensor, *others) -> None:
    """Raise on anything the kernels do not take: the dtype, the shape,
    and each operand's device, contiguity and 16-byte alignment (the bulk
    copies and vector loads need both)."""
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: dtype {x.dtype} not in float32/bfloat16/"
                        f"float16")
    hidden = x.shape[-1]
    if x.dim() < 2 or hidden % 128 or not 128 <= hidden <= MAX_HIDDEN:
        raise ValueError(f"{name}: shape {tuple(x.shape)} outside what the "
                         f"kernel takes (hidden a multiple of 128 up to "
                         f"{MAX_HIDDEN})")
    index = x.get_device()
    for t in (x,) + others:
        if t.get_device() != index:
            raise ValueError(f"{name}: operands on {t.device} and "
                             f"{x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: operand is not 16-byte aligned")


def _vec(v: torch.Tensor, hidden: int, x: torch.Tensor) -> torch.Tensor:
    """A scale/bias vector as contiguous, 16-byte aligned f32 ``[hidden]``
    on ``x``'s device: ``v`` itself when it is one already, else a
    copy."""
    if (v.dtype is torch.float32 and v.is_contiguous()
            and v.numel() == hidden and v.get_device() == x.get_device()
            and v.data_ptr() % 16 == 0):
        return v
    v = v.reshape(-1)
    if v.shape[0] != hidden:
        raise ValueError(f"vector of {v.shape[0]} != hidden {hidden}")
    return torch.empty(hidden, dtype=torch.float32, device=x.device).copy_(v)


def fwd_call(x: torch.Tensor, residual: Optional[torch.Tensor],
             scale: torch.Tensor, bias: torch.Tensor, eps: float,
             out_dtype: torch.dtype, *, route: Optional[str] = None):
    """Forward (``_fwd_call``'s contract): ``(out, s, mean, var)`` with
    ``mean``/``var`` f32 of shape ``x.shape[:-1] + (1,)``. On a CUDA
    tensor the route is ``plan_fwd``'s; ``route`` asks for one
    (``"rows"`` or ``"row_block"``: ``chip_smoke.py`` times them in
    turns)."""
    if x.device.type == "cpu":
        return fwd_plain(x, residual, scale, bias, eps, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"fused_norm: no kernel for device {x.device}")
    return _fwd_launch(x, residual, scale, bias, eps, out_dtype, route)


def _fwd_launch(x, residual, scale, bias, eps, out_dtype, route=None,
                stats: bool = True):
    """Check the operands, plan and launch the forward kernel. Without
    ``stats`` (a caller that drops them) route "rows" writes no mean and
    var, and they come back None."""
    dtype, shape = x.dtype, x.shape
    if residual is not None and (residual.shape != shape
                                 or residual.dtype is not dtype):
        raise ValueError("fused_norm: residual must match x in shape and "
                         "dtype")
    if out_dtype is not dtype and out_dtype is not torch.float32:
        raise TypeError(f"fused_norm: out dtype {out_dtype} is neither "
                        f"{dtype} nor float32")
    _check("fused_norm fwd", x, *(() if residual is None else (residual,)))
    hidden = shape[-1]
    rows = x.numel() // hidden
    scale_v = _vec(scale, hidden, x)
    bias_v = _vec(bias, hidden, x)
    plan, code = _plan(rows, hidden, dtype, out_dtype, residual is not None,
                       x.get_device(), route)
    out = torch.empty_like(x, dtype=out_dtype)
    s = x if residual is None else torch.empty_like(x)
    if stats or plan.route != "rows":
        stat_shape = shape[:-1] + (1,)
        mean = torch.empty(stat_shape, dtype=torch.float32, device=x.device)
        var = torch.empty(stat_shape, dtype=torch.float32, device=x.device)
        stat_ptrs = (mean.data_ptr(), var.data_ptr())
    else:
        mean = var = None
        stat_ptrs = (None, None)
    err = _fns()[0](
        x.data_ptr(), None if residual is None else residual.data_ptr(),
        scale_v.data_ptr(), bias_v.data_ptr(), out.data_ptr(),
        None if residual is None else s.data_ptr(), *stat_ptrs, rows, hidden,
        _DTYPE_CODES[dtype] | _DTYPE_CODES[out_dtype] << 4, code, plan.grid,
        float(eps), _stream(x.get_device()))
    if err != 0:
        raise RuntimeError(f"fused norm forward kernel launch failed: CUDA "
                           f"error {err} (route {plan.route})")
    fwd_call.launches += 1
    if plan.route == "rows":
        fwd_call.rows_launches += 1
    if dtype is torch.float16:
        fwd_call.fp16_launches += 1
    return out, s, mean, var


fwd_call.launches = 0
fwd_call.fp16_launches = 0
#: launches of route "rows" (``plan_fwd``; the rest took "row_block"):
#: every main-path shape takes "rows"
fwd_call.rows_launches = 0


@torch.library.custom_op(
    "fleetx_tpu_torch::fused_norm_fwd", mutates_args=(),
    schema="(Tensor x, Tensor? residual, Tensor scale, Tensor bias, "
           "float eps, ScalarType out_dtype) -> (Tensor, Tensor, Tensor, "
           "Tensor)")
def fused_norm_fwd(x: torch.Tensor, residual: Optional[torch.Tensor],
                   scale: torch.Tensor, bias: torch.Tensor, eps: float,
                   out_dtype: torch.dtype):
    """``fwd_call`` as the custom op
    ``torch.ops.fleetx_tpu_torch.fused_norm_fwd``: what an exported
    program (``torch.export``) records in place of the ctypes launch. Its
    implementation is ``fwd_call`` itself (the plain version on a CPU
    tensor), so a run of an exported program counts its launches. Without
    a residual ``s`` is ``x`` itself, which an op may not return: it comes
    back empty and the caller keeps ``x``."""
    out, s, mean, var = fwd_call(x, residual, scale, bias, eps, out_dtype)
    if residual is None:
        s = x.new_empty((0,))
    return out, s, mean, var


@fused_norm_fwd.register_fake
def _fused_norm_fwd_fake(x, residual, scale, bias, eps, out_dtype):
    stat = tuple(x.shape[:-1]) + (1,)
    return (x.new_empty(x.shape, dtype=out_dtype),
            x.new_empty((0,)) if residual is None else torch.empty_like(x),
            x.new_empty(stat, dtype=torch.float32),
            x.new_empty(stat, dtype=torch.float32))


def bwd_call(s: torch.Tensor, scale: torch.Tensor, mean: torch.Tensor,
             var: torch.Tensor, dout: torch.Tensor, eps: float,
             ds_in: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Backward (``_bwd_call``'s contract): ``dx`` in ``s.dtype``."""
    if s.device.type == "cpu":
        return bwd_plain(s, scale, mean, var, dout, eps, ds_in)
    if s.device.type != "cuda":
        raise ValueError(f"fused_norm: no kernel for device {s.device}")
    for name, t in (("dout", dout), ("ds_in", ds_in)):
        if t is not None and (t.shape != s.shape or t.dtype
                              not in _DTYPE_CODES):
            raise ValueError(f"fused_norm bwd: {name} {tuple(t.shape)} "
                             f"{t.dtype} does not match s "
                             f"{tuple(s.shape)}")
    if dout.dtype != s.dtype or (ds_in is not None
                                 and ds_in.dtype != s.dtype):
        raise TypeError("fused_norm bwd: dout and ds_in must share s's "
                        "dtype")
    hidden = s.shape[-1]
    rows = s.numel() // hidden
    if mean.numel() != rows or var.numel() != rows or \
            mean.dtype != torch.float32 or var.dtype != torch.float32:
        raise ValueError("fused_norm bwd: mean/var must be f32, one per row")
    _check("fused_norm bwd", s, dout, mean, var,
           *(() if ds_in is None else (ds_in,)))
    scale_v = _vec(scale, hidden, s)
    dx = torch.empty_like(s)
    stream = torch.cuda.current_stream(s.device).cuda_stream
    _, bwd = _fns()
    err = bwd(s.data_ptr(), scale_v.data_ptr(), mean.data_ptr(),
              var.data_ptr(), dout.data_ptr(),
              ds_in.data_ptr() if ds_in is not None else None,
              dx.data_ptr(), rows, hidden,
              _DTYPE_CODES[s.dtype] | (_DTYPE_CODES[dout.dtype] << 4),
              float(eps), stream)
    if err != 0:
        raise RuntimeError(f"fused norm backward kernel launch failed: CUDA "
                           f"error {err}")
    bwd_call.launches += 1
    bwd_call.fp16_launches += int(s.dtype == torch.float16)
    return dx


bwd_call.launches = 0
bwd_call.fp16_launches = 0


# ----------------------------------------------------------- autograd
class _FusedAddNorm(torch.autograd.Function):
    """``(out, s) = (LN(residual + x).to(out_dtype), residual + x)``."""

    @staticmethod
    def forward(ctx, x, residual, scale, bias, eps, out_dtype):
        """Forward kernel through the custom op ``fused_norm_fwd`` (a save
        point of kind ``"kernel"``); saves ``(s, scale, mean, var)``."""
        x, residual = x.contiguous(), residual.contiguous()
        out, s, mean, var = kept("kernel", lambda: fused_norm_fwd(
            x, residual, scale, bias, eps, out_dtype))
        ctx.save_for_backward(s, scale, mean, var)
        ctx.eps = eps
        ctx.set_materialize_grads(False)
        return out, s

    @staticmethod
    def backward(ctx, dout, ds_in):
        """Backward kernel with ``ds_in`` folded in; the same ``ds`` for
        ``x`` and ``residual``."""
        s, scale, mean, var = ctx.saved_tensors
        if dout is None:
            dout = torch.zeros_like(s)
        ds = bwd_call(s, scale, mean, var, dout.contiguous(), ctx.eps,
                      ds_in=None if ds_in is None else ds_in.contiguous())
        dscale, dbias = param_grads(s, mean, var, dout, ctx.eps, scale.dtype)
        return ds, ds, dscale, dbias, None, None


class _FusedNorm(torch.autograd.Function):
    """``LN(x).to(out_dtype)`` with no residual add."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps, out_dtype):
        """Forward kernel without a residual, through the custom op (a
        save point of kind ``"kernel"``); saves ``(x, scale, mean,
        var)``."""
        x = x.contiguous()
        out, _, mean, var = kept("kernel", lambda: fused_norm_fwd(
            x, None, scale, bias, eps, out_dtype))
        ctx.save_for_backward(x, scale, mean, var)
        ctx.eps = eps
        return out

    @staticmethod
    def backward(ctx, dout):
        """Backward kernel for ``dx``; ``dscale``/``dbias`` outside it."""
        s, scale, mean, var = ctx.saved_tensors
        dout = dout.contiguous()
        dx = bwd_call(s, scale, mean, var, dout, ctx.eps)
        dscale, dbias = param_grads(s, mean, var, dout, ctx.eps, scale.dtype)
        return dx, dscale, dbias, None, None


def _traced(x: torch.Tensor) -> bool:
    """True when something may record this call: a tensor subclass (the
    fake and functional tensors of an export trace), an active dispatch
    mode, or the compiler. Then the forward goes through the custom op,
    which a program records; otherwise the kernel launches without the
    op's Python dispatch."""
    return (type(x) is not torch.Tensor
            or torch._C._len_torch_dispatch_stack() > 0
            or torch.compiler.is_compiling())


def fused_residual_norm(x: torch.Tensor, scale: torch.Tensor,
                        bias: torch.Tensor,
                        residual: Optional[torch.Tensor] = None, *,
                        eps: float = 1e-5,
                        out_dtype: torch.dtype = torch.float32):
    """Fused (residual-add +) f32 LayerNorm + cast; returns ``(out, s)``
    with ``s = residual + x`` (``x`` itself without a residual). Callers
    gate on ``fused_norm_supported`` first, as in the JAX package. Where
    autograd records the call the autograd wrappers run; else (eval,
    generation) the kernel directly, without the statistics it would
    drop, or the custom op where a trace may record the call (an
    export)."""
    if not needs_grad(x, residual, scale, bias):
        x = x.contiguous()
        if residual is not None:
            residual = residual.contiguous()
        args = (x, residual, scale, bias, float(eps), out_dtype)
        if _traced(x):
            out, s, _, _ = fused_norm_fwd(*args)
        elif x.device.type == "cuda":  # the statistics are dropped
            out, s, _, _ = _fwd_launch(*args, stats=False)
        else:
            out, s, _, _ = fwd_call(*args)
        return out, x if residual is None else s
    if residual is None:
        return _FusedNorm.apply(x, scale, bias, float(eps), out_dtype), x
    return _FusedAddNorm.apply(x, residual, scale, bias, float(eps),
                               out_dtype)
