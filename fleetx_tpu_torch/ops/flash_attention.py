"""Causal flash attention: the Hopper forward, fused-backward and split-
backward kernels, their plain versions, the gates, the dropout hash and
the autograd wrapper.

Port of ``fleetx_tpu/ops/flash_attention.py``. The TPU kernels are
``_fwd_kernel`` (launched by ``_fwd``), ``_bwd_fused_kernel`` (launched
by ``_bwd_fused``), ``_bwd_dq_kernel`` (``_bwd_dq``) and
``_bwd_dkv_kernel`` (``_bwd_dkv``); here the same four functions are the
CUDA kernels in ``csrc/flash_attention.cu`` (built by
``kernels/build.py``, bound with ``ctypes``).

- ``fwd_call(q3, k3, v3, seed, scale, causal, rate)`` → ``(out, lse)``:
  FlashAttention-2 forward over ``[b·heads, seq, head_dim]``: f32 scores,
  masked with -1e30 above the diagonal, f32 online softmax whose
  normaliser uses the UNdropped ``p``; dropout scales only ``p @ v``.
  ``out`` in the input dtype, ``lse = m + log(l)`` in f32.
- ``bwd_call(q3, k3, v3, do, lse, delta, seed, scale, causal, rate)`` →
  ``(dq f32, dk, dv)``: the single-pass fused backward, P recomputed from
  ``lse``, ``dv``/``dp`` masked as ``_bwd_fused_kernel:484-493``;
  ``delta = sum(out · do)`` is computed outside, as ``_bwd`` does.
- ``bwd_dq_call(...)`` → ``dq`` in the operand dtype and
  ``bwd_dkv_call(...)`` → ``(dk, dv)`` in the k/v dtype: the split
  backward, same arguments. ``lse``/``delta`` are f32 ``[bh, sq]`` (the
  port's layout for JAX's ``[bn, sq, 1]``) and ``lse`` may be any
  logsumexp of the rows: the ring path feeds the global one. ``sq != sk``
  is allowed when not causal.

On a CUDA tensor each launches its kernel or raises; on a CPU tensor it
runs its dense plain version (``fwd_plain``, ``bwd_plain``,
``bwd_dq_plain``, ``bwd_dkv_plain``), which the CPU tests hold against
the Pallas kernels and ``chip_smoke.py`` holds the kernels against on the
card. Each wrapper's ``launches`` counts kernel launches only.

The forward is also the custom op ``torch.ops.fleetx_tpu_torch.flash_fwd``
(``flash_fwd``, with a fake implementation for tracing), so that
``torch.export`` can record it: ``flash_attention`` calls the op where
autograd does not record the call (eval, generation, an export trace)
and the autograd wrapper, whose forward calls the same op, where it does
(training): a launch through ctypes inside ``autograd.Function.forward``
is invisible to the dispatcher, the op is not. That forward is a save
point (``ops/save_points.py``): under the ``dots`` granularity the span
keeps its outputs and its recomputation does not launch it again. The
kernel is counted in ``fwd_call``, once per real launch.

Routes (``tc_route``, one predicate for all four kernels). bf16 / fp16
operands at head_dim 64 and 128 take the tensor-core forward, fused
backward, dq and dk/dv kernels (wgmma on 16-bit tiles, f32
accumulation); each wrapper's ``tc_launches`` counts those launches
beside ``launches``, which counts both routes. f32 and head_dim 256 stay
on the SIMT kernels, every product in f32. The route is a dispatch on
dtype and head_dim, not a fallback: a tensor-core kernel that fails
raises. The tensor-core kernels round the dropped ``p`` (forward, and
``pᵀ`` for dv) and ``ds`` (for dk and dq) to the operand dtype before
their products, as every GPU FlashAttention does; the JAX kernels and the
plain versions by default keep them in f32. ``round_operands=True`` makes
``fwd_plain``, ``bwd_plain``, ``bwd_dq_plain`` and ``bwd_dkv_plain``
round them exactly where the kernels do: the card holds each tensor-core
kernel to that variant with a tight tolerance and to the unrounded one
within a drift bound (``chip_smoke.py``). The fused tensor-core kernel,
like the SIMT one and ``_bwd_fused_kernel``, is deterministic: one CTA
owns a head and adds its dq partials in a fixed order, without atomics.

Dropout. The TPU kernel draws its mask from the TPU's hardware PRNG per
block; those bits cannot be had on a GPU. Here the mask is one
counter-based hash keyed per ELEMENT by ``(seed, b·head, row, col)``
(``dropout_bits``: three rounds of a 32-bit integer mixer), written
identically in the CUDA source and below in int64 arithmetic masked to
32 bits. ``b·head`` is the GLOBAL batch-head index: every function takes
``heads = (local_heads, total_heads, batch_offset, head_offset)``, which
maps a launch's index ``i`` to ``(batch_offset + i // local_heads) ·
total_heads + head_offset + i % local_heads`` (``NO_SHARD``, the
default, leaves it as it is), so a rank that holds a block of the batch
rows and of the heads draws the masks one rank draws for them. Forward, fused and split backward therefore see the same mask
whatever their tiling, and kernel and plain version use bit-identical
masks. An element is kept when ``bits >= rate·2^32`` and scaled by
``1/(1-rate)``, as ``_dropout_mask`` decides.

The gates keep the JAX contract: ``supported`` (rank 4, seq a multiple of
128, ``sq == sk`` under causal, head_dim in {64, 128, 256}) and
``fused_backward_supported`` (that, and head_dim <= 128). The backward
takes the fused kernel where ``fused_bwd`` is on and
``fused_backward_supported`` admits the shape, and the split pair
otherwise (``fused_bwd`` off, head_dim 256), as ``_bwd`` does. One
difference is kept on purpose: JAX's predicate also rejects a
full-sequence f32 dq window ``(seq + 2·block)·head_dim·4`` above 4 MiB, a
TPU VMEM budget with no counterpart here (the CUDA fused kernel keeps dq
in device memory). So a non-ring seq-8192 head_dim-128 call takes the
fused kernel in the port and the split pair in JAX; both compute the same
function.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from fleetx_tpu_torch.ops.save_points import kept

_NEG_INF = -1e30
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_MASK32 = 0xFFFFFFFF
#: operand dtypes and head_dims of the tensor-core kernels
TC_DTYPES = (torch.bfloat16, torch.float16)
TC_HEAD_DIMS = (64, 128)
#: ``heads`` of an unsharded call: the launch's index is the global one
NO_SHARD = (1, 1, 0, 0)


def _map_kw(heads) -> dict:
    """``heads`` as a keyword argument, none for an unsharded call (so a
    call without a map is the call it was before maps)."""
    return {} if tuple(heads) == NO_SHARD else {"heads": tuple(heads)}


def tc_route(dtype: torch.dtype, head_dim: int) -> bool:
    """True where the flash kernels (forward, fused backward, dq, dk/dv)
    run on the tensor cores (bf16 / fp16 at head_dim 64 and 128); the C
    entry points refuse any other answer."""
    return dtype in TC_DTYPES and int(head_dim) in TC_HEAD_DIMS


def supported(q: torch.Tensor, k: Optional[torch.Tensor] = None,
              causal: bool = True) -> bool:
    """True when the flash kernels apply (``supported``'s contract)."""
    if q.dim() != 4:
        return False
    seq, head_dim = q.shape[1], q.shape[3]
    if seq < 128 or seq % 128:
        return False
    if k is not None:
        if k.dim() != 4 or k.shape[3] != head_dim:
            return False
        sk = k.shape[1]
        if causal and sk != seq:
            return False
        if sk < 128 or sk % 128:
            return False
    return head_dim in (64, 128, 256)


def fused_backward_supported(q: torch.Tensor,
                             k: Optional[torch.Tensor] = None,
                             causal: bool = True) -> bool:
    """True when the single-pass fused backward kernel applies: the base
    contract and head_dim <= 128. JAX's 4 MiB dq-window rule (a TPU VMEM
    budget) is left out: the CUDA kernel's dq lives in device memory."""
    return supported(q, k, causal=causal) and q.shape[3] <= 128


# ------------------------------------------------------------ dropout
def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2^32`` for uint32 values held in int64, without
    overflowing int64 (the high half of ``c`` contributes only its low 16
    product bits)."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """The 32-bit integer mixer of ``csrc/flash_attention.cu:mix32``."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def global_heads(bh: int, heads=NO_SHARD, device=None) -> torch.Tensor:
    """The global batch-head index of each of a launch's ``bh`` rows
    (``heads`` as the module docstring says)."""
    local, total, b_off, h_off = (int(x) for x in heads)
    i = torch.arange(bh, dtype=torch.int64, device=device)
    return (b_off + i // local) * total + h_off + i % local


def dropout_bits(seed: int, bh: int, sq: int, sk: int,
                 device=None, heads=NO_SHARD) -> torch.Tensor:
    """The kernels' 32-bit random word per element, ``[bh, sq, sk]`` int64:
    ``mix32(mix32(mix32(seed ^ mix32(h ^ K0)) ^ row) ^ (col · K1))``, ``h``
    the global batch-head index."""
    heads = global_heads(bh, heads, device)
    rows = torch.arange(sq, dtype=torch.int64, device=device)
    cols = torch.arange(sk, dtype=torch.int64, device=device)
    k_head = _mix32((int(seed) & _MASK32) ^ _mix32(heads ^ 0x85EBCA6B))
    r = _mix32(k_head[:, None] ^ rows[None, :])                 # [bh, sq]
    c = _mul32(cols, 0x9E3779B9)                                # [sk]
    return _mix32(r[:, :, None] ^ c[None, None, :])


def keep_threshold(rate: float) -> int:
    """``_dropout_mask``'s threshold: keep where ``bits >= rate·2^32``."""
    return min(int(rate * 2.0 ** 32), 2 ** 32 - 1)


def dropout_keep(seed: int, bh: int, sq: int, sk: int, rate: float,
                 device=None, heads=NO_SHARD) -> torch.Tensor:
    """The kernels' keep mask ``[bh, sq, sk]`` (bool)."""
    return dropout_bits(seed, bh, sq, sk, device, heads) >= \
        keep_threshold(rate)


# -------------------------------------------------------------- plain
def _scores(q3, k3, scale, causal):
    s = torch.einsum("bqd,bkd->bqk", q3.float(), k3.float()) * scale
    if causal:
        sq, sk = s.shape[1], s.shape[2]
        mask = torch.ones((sq, sk), dtype=torch.bool,
                          device=s.device).tril()
        s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
    return s


def fwd_plain(q3: torch.Tensor, k3: torch.Tensor, v3: torch.Tensor,
              seed: int, scale: float, causal: bool = True,
              rate: float = 0.0, round_operands: bool = False,
              heads=NO_SHARD):
    """The forward kernel's function, dense: ``(out, lse)``.
    ``round_operands`` rounds the dropped ``p`` to q's dtype before
    ``p @ v``, as the tensor-core kernel does; the normaliser keeps the
    unrounded ``p``."""
    s = _scores(q3, k3, scale, causal)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    if rate > 0.0:
        keep = dropout_keep(seed, q3.shape[0], q3.shape[1], k3.shape[1],
                            rate, q3.device, heads)
        p = torch.where(keep, p / (1.0 - rate), torch.zeros_like(p))
    if round_operands:
        p = p.to(q3.dtype).float()
    acc = torch.einsum("bqk,bkd->bqd", p, v3.float())
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    out = (acc / l_safe[..., None]).to(q3.dtype)
    return out, m + torch.log(l_safe)


def _split_p_dp(q3, k3, v3, do, lse, seed, scale, causal, rate,
                heads=NO_SHARD):
    """``p = exp(s - lse)``, ``dp = do · vᵀ`` and the keep mask (None
    without dropout), in f32, as every backward kernel recomputes them."""
    p = torch.exp(_scores(q3, k3, scale, causal) - lse[..., None])
    dp = torch.einsum("bqd,bkd->bqk", do.float(), v3.float())
    keep = None
    if rate > 0.0:
        keep = dropout_keep(seed, q3.shape[0], q3.shape[1], k3.shape[1],
                            rate, q3.device, heads)
    return p, dp, keep


def _ds_dk_dv(q3, k3, v3, do, lse, delta, seed, scale, causal, rate,
              round_operands=False, heads=NO_SHARD):
    """``(ds, dk, dv)`` in f32, kept ``p`` and ``dp`` multiplied by
    ``1 / (1 - rate)`` (``_bwd_fused_kernel:484-493``,
    ``_bwd_dkv_kernel:347-360``); ``round_operands`` rounds the dropped
    ``p`` and ``ds`` to q's dtype before their products (``ds`` comes back
    unrounded)."""
    p, dp, keep = _split_p_dp(q3, k3, v3, do, lse, seed, scale, causal, rate,
                              heads)
    pd = p
    if keep is not None:
        inv = 1.0 / (1.0 - rate)
        zero = torch.zeros_like(p)
        pd = torch.where(keep, p * inv, zero)
        dp = torch.where(keep, dp * inv, zero)
    def rnd(x):
        return x.to(q3.dtype).float() if round_operands else x

    dv = torch.einsum("bqk,bqd->bkd", rnd(pd), do.float())
    ds = p * (dp - delta[..., None]) * scale
    dk = torch.einsum("bqk,bqd->bkd", rnd(ds), q3.float())
    return ds, dk, dv


def bwd_plain(q3: torch.Tensor, k3: torch.Tensor, v3: torch.Tensor,
              do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
              seed: int, scale: float, causal: bool = True,
              rate: float = 0.0, round_operands: bool = False,
              heads=NO_SHARD):
    """The fused backward kernel's function, dense: ``(dq f32, dk, dv)``.
    ``round_operands`` rounds the dropped ``p`` (for dv) and ``ds`` (for
    dk and dq) to q's dtype before their products, as the tensor-core
    kernel does."""
    ds, dk, dv = _ds_dk_dv(q3, k3, v3, do, lse, delta, seed, scale, causal,
                           rate, round_operands, heads)
    if round_operands:
        ds = ds.to(q3.dtype).float()
    dq = torch.einsum("bqk,bkd->bqd", ds, k3.float())
    return dq, dk.to(k3.dtype), dv.to(v3.dtype)


def bwd_dq_plain(q3: torch.Tensor, k3: torch.Tensor, v3: torch.Tensor,
                 do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                 seed: int, scale: float, causal: bool = True,
                 rate: float = 0.0, round_operands: bool = False,
                 heads=NO_SHARD) -> torch.Tensor:
    """The dq kernel's function, dense: dq in the operand dtype. Kept
    ``dp`` is divided by ``1 - rate`` (``_bwd_dq_kernel:301-305``).
    ``round_operands`` rounds ``ds`` to q's dtype before ``dq = ds k``, as
    the tensor-core kernel does."""
    p, dp, keep = _split_p_dp(q3, k3, v3, do, lse, seed, scale, causal, rate,
                              heads)
    if keep is not None:
        dp = torch.where(keep, dp / (1.0 - rate), torch.zeros_like(dp))
    ds = p * (dp - delta[..., None]) * scale
    if round_operands:
        ds = ds.to(q3.dtype).float()
    return torch.einsum("bqk,bkd->bqd", ds, k3.float()).to(q3.dtype)


def bwd_dkv_plain(q3: torch.Tensor, k3: torch.Tensor, v3: torch.Tensor,
                  do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                  seed: int, scale: float, causal: bool = True,
                  rate: float = 0.0, round_operands: bool = False,
                  heads=NO_SHARD):
    """The dk/dv kernel's function, dense: ``(dk, dv)`` in the k/v
    dtype. ``round_operands`` rounds the dropped ``pᵀ`` and ``dsᵀ`` to q's
    dtype before ``dv += pᵀ do`` and ``dk += dsᵀ q``, as the tensor-core
    kernel does."""
    _, dk, dv = _ds_dk_dv(q3, k3, v3, do, lse, delta, seed, scale, causal,
                          rate, round_operands, heads)
    return dk.to(k3.dtype), dv.to(v3.dtype)


# ------------------------------------------------------------ kernels
def _fns():
    """The four C entry points (forward, fused, dq, dk/dv) with their
    argument types declared."""
    from fleetx_tpu_torch.kernels import build

    lib = build.load("flash_attention")
    fns = (lib.fleetx_flash_fwd, lib.fleetx_flash_bwd_fused,
           lib.fleetx_flash_bwd_dq, lib.fleetx_flash_bwd_dkv)
    if fns[0].argtypes is None:
        ptr, i32, u32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
        # ..., scale, seed, the head map (4), thresh, dropout,
        # keep_prob / inv, the route (tc)
        tail = [ctypes.c_float, u32] + [i32] * 4 + \
            [u32, i32, ctypes.c_float, i32]
        for fn, n_ptrs in zip(fns, (5, 9, 7, 8)):
            fn.argtypes = [ptr] * n_ptrs + [i32] * 6 + tail + [ptr]
            fn.restype = i32
    return fns


def _check(name: str, tensors, shapes) -> None:
    """Raise on anything the kernels do not take."""
    q = tensors[0]
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: dtype {q.dtype} not in float32/bfloat16/"
                        f"float16")
    for t, want in zip(tensors, shapes):
        if t.device != q.device:
            raise ValueError(f"{name}: operands on {t.device} and "
                             f"{q.device}")
        if tuple(t.shape) != tuple(want):
            raise ValueError(f"{name}: shape {tuple(t.shape)} != "
                             f"{tuple(want)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: operand is not 16-byte aligned")


def _geometry(q3, k3, causal):
    bh, sq, d = q3.shape
    sk = k3.shape[1]
    if d not in (64, 128, 256) or sq % 128 or sk % 128 or sq < 128 \
            or sk < 128 or (causal and sq != sk):
        raise ValueError(f"flash attention: geometry sq={sq} sk={sk} "
                         f"head_dim={d} outside what the kernels take")
    return bh, sq, sk, d


def _launch(name: str, fn, *args) -> None:
    """Call one C entry point on the current stream; raise on an error."""
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def _on_card(name: str, q3: torch.Tensor) -> None:
    """Raise for a tensor that is neither on the CPU nor on a card."""
    if q3.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {q3.device}")


def _bwd_operands(name: str, q3, k3, v3, do, lse, delta, causal):
    """Check the backward kernels' operands; returns ``(bh, sq, sk, d)``."""
    bh, sq, sk, d = _geometry(q3, k3, causal)
    _check(name, (q3, k3, v3, do), ((bh, sq, d), (bh, sk, d), (bh, sk, d),
                                    (bh, sq, d)))
    if len({t.dtype for t in (q3, k3, v3, do)}) != 1:
        raise TypeError(f"{name}: q, k, v and do must share one dtype")
    for what, t in (("lse", lse), ("delta", delta)):
        if t.dtype != torch.float32 or tuple(t.shape) != (bh, sq) \
                or not t.is_contiguous() or t.device != q3.device:
            raise ValueError(f"{name}: {what} must be contiguous f32 "
                             f"[{bh}, {sq}] on {q3.device}")
    return bh, sq, sk, d


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _head_map(heads, bh: int) -> tuple:
    """The head map's four C arguments, checked."""
    local, total, b_off, h_off = (int(x) for x in heads)
    if local < 1 or total < local or b_off < 0 or h_off < 0 or \
            h_off + local > total or bh % local:
        raise ValueError(f"flash attention: head map {tuple(heads)} does "
                         f"not fit {bh} rows")
    return local, total, b_off, h_off


def fwd_call(q3: torch.Tensor, k3: torch.Tensor, v3: torch.Tensor,
             seed: int, scale: float, causal: bool = True,
             rate: float = 0.0, heads=NO_SHARD):
    """Forward over ``[b·heads, seq, head_dim]``: ``(out, lse f32)``."""
    if q3.device.type == "cpu":
        return fwd_plain(q3, k3, v3, seed, scale, causal, rate,
                         **_map_kw(heads))
    _on_card("flash attention", q3)
    bh, sq, sk, d = _geometry(q3, k3, causal)
    _check("flash fwd", (q3, k3, v3), ((bh, sq, d), (bh, sk, d),
                                       (bh, sk, d)))
    if k3.dtype != q3.dtype or v3.dtype != q3.dtype:
        raise TypeError("flash fwd: q, k and v must share one dtype")
    out = torch.empty_like(q3)
    lse = torch.empty((bh, sq), dtype=torch.float32, device=q3.device)
    tc = tc_route(q3.dtype, d)
    _launch("flash attention forward", _fns()[0], q3.data_ptr(),
            k3.data_ptr(), v3.data_ptr(), out.data_ptr(), lse.data_ptr(), bh,
            sq, sk, d, int(causal), _DTYPE_CODES[q3.dtype], float(scale),
            int(seed) & _MASK32, *_head_map(heads, bh), keep_threshold(rate),
            int(rate > 0.0), 1.0 - float(rate), int(tc), _stream(q3))
    fwd_call.launches += 1
    fwd_call.tc_launches += int(tc)
    return out, lse


fwd_call.launches = 0
fwd_call.tc_launches = 0


@torch.library.custom_op(
    "fleetx_tpu_torch::flash_fwd", mutates_args=(),
    schema="(Tensor q3, Tensor k3, Tensor v3, int seed, float scale, "
           "bool causal, float rate, int[] heads=[1, 1, 0, 0]) -> "
           "(Tensor, Tensor)")
def flash_fwd(q3: torch.Tensor, k3: torch.Tensor, v3: torch.Tensor,
              seed: int, scale: float, causal: bool, rate: float,
              heads: list = NO_SHARD):
    """``fwd_call`` as the custom op ``torch.ops.fleetx_tpu_torch.flash_fwd``:
    what an exported program (``torch.export``) records in place of the
    ctypes launch, which a fake tensor cannot trace. Its implementation is
    ``fwd_call`` itself (the plain version on a CPU tensor), so a run of an
    exported program counts its launches."""
    return fwd_call(q3, k3, v3, seed, scale, causal, rate, **_map_kw(heads))


@flash_fwd.register_fake
def _flash_fwd_fake(q3, k3, v3, seed, scale, causal, rate, heads=NO_SHARD):
    return (torch.empty_like(q3),
            q3.new_empty((q3.shape[0], q3.shape[1]), dtype=torch.float32))


def bwd_call(q3: torch.Tensor, k3: torch.Tensor, v3: torch.Tensor,
             do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
             seed: int, scale: float, causal: bool = True,
             rate: float = 0.0, heads=NO_SHARD):
    """Fused backward: ``(dq f32, dk, dv)`` (dk/dv in the input dtype);
    head_dim <= 128 (``fused_backward_supported``)."""
    if q3.device.type == "cpu":
        return bwd_plain(q3, k3, v3, do, lse, delta, seed, scale, causal,
                         rate, **_map_kw(heads))
    _on_card("flash attention", q3)
    bh, sq, sk, d = _bwd_operands("flash bwd", q3, k3, v3, do, lse, delta,
                                  causal)
    if d > 128:
        raise ValueError(f"fused flash backward takes head_dim <= 128, got "
                         f"{d}: the split pair (bwd_dq_call, bwd_dkv_call) "
                         f"takes it")
    dq = torch.empty((bh, sq, d), dtype=torch.float32, device=q3.device)
    dk = torch.empty_like(k3)
    dv = torch.empty_like(v3)
    inv = 1.0 / (1.0 - rate) if rate > 0.0 else 1.0
    tc = tc_route(q3.dtype, d)
    _launch("flash attention backward", _fns()[1], q3.data_ptr(),
            k3.data_ptr(), v3.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), bh,
            sq, sk, d, int(causal), _DTYPE_CODES[q3.dtype], float(scale),
            int(seed) & _MASK32, *_head_map(heads, bh), keep_threshold(rate),
            int(rate > 0.0), float(inv), int(tc), _stream(q3))
    bwd_call.launches += 1
    bwd_call.tc_launches += int(tc)
    return dq, dk, dv


bwd_call.launches = 0
bwd_call.tc_launches = 0


def bwd_dq_call(q3: torch.Tensor, k3: torch.Tensor, v3: torch.Tensor,
                do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                seed: int, scale: float, causal: bool = True,
                rate: float = 0.0, heads=NO_SHARD) -> torch.Tensor:
    """Split backward, dq kernel: dq in the operand dtype."""
    if q3.device.type == "cpu":
        return bwd_dq_plain(q3, k3, v3, do, lse, delta, seed, scale, causal,
                            rate, **_map_kw(heads))
    _on_card("flash attention", q3)
    bh, sq, sk, d = _bwd_operands("flash bwd dq", q3, k3, v3, do, lse,
                                  delta, causal)
    dq = torch.empty_like(q3)
    tc = tc_route(q3.dtype, d)
    _launch("flash attention dq", _fns()[2], q3.data_ptr(), k3.data_ptr(),
            v3.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dq.data_ptr(), bh, sq, sk, d, int(causal),
            _DTYPE_CODES[q3.dtype], float(scale), int(seed) & _MASK32,
            *_head_map(heads, bh), keep_threshold(rate), int(rate > 0.0),
            1.0 - float(rate), int(tc), _stream(q3))
    bwd_dq_call.launches += 1
    bwd_dq_call.tc_launches += int(tc)
    return dq


bwd_dq_call.launches = 0
bwd_dq_call.tc_launches = 0


def bwd_dkv_call(q3: torch.Tensor, k3: torch.Tensor, v3: torch.Tensor,
                 do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                 seed: int, scale: float, causal: bool = True,
                 rate: float = 0.0, heads=NO_SHARD):
    """Split backward, dk/dv kernel: ``(dk, dv)`` in the k/v dtype."""
    if q3.device.type == "cpu":
        return bwd_dkv_plain(q3, k3, v3, do, lse, delta, seed, scale,
                             causal, rate, **_map_kw(heads))
    _on_card("flash attention", q3)
    bh, sq, sk, d = _bwd_operands("flash bwd dkv", q3, k3, v3, do, lse,
                                  delta, causal)
    dk = torch.empty_like(k3)
    dv = torch.empty_like(v3)
    inv = 1.0 / (1.0 - rate) if rate > 0.0 else 1.0
    tc = tc_route(q3.dtype, d)
    _launch("flash attention dk/dv", _fns()[3], q3.data_ptr(),
            k3.data_ptr(), v3.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), bh, sq, sk, d,
            int(causal), _DTYPE_CODES[q3.dtype], float(scale),
            int(seed) & _MASK32, *_head_map(heads, bh), keep_threshold(rate),
            int(rate > 0.0), float(inv), int(tc), _stream(q3))
    bwd_dkv_call.launches += 1
    bwd_dkv_call.tc_launches += int(tc)
    return dk, dv


bwd_dkv_call.launches = 0
bwd_dkv_call.tc_launches = 0


# ----------------------------------------------------------- autograd
def needs_grad(*tensors) -> bool:
    """True when autograd records a call on these operands: the autograd
    wrapper then runs; otherwise (eval, generation, an export trace) the
    custom op does."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


class _Flash3(torch.autograd.Function):
    """Flash attention on ``[b·heads, seq, head_dim]`` operands."""

    @staticmethod
    def forward(ctx, q3, k3, v3, seed, scale, causal, rate, fused=True,
                heads=NO_SHARD):
        """Forward kernel through the custom op ``flash_fwd`` (a save
        point of kind ``"kernel"``, ``ops/save_points.py``); saves the
        operands, ``out`` and ``lse``; ``fused`` picks the backward
        kernel(s)."""
        out, lse = kept("kernel", lambda: flash_fwd(
            q3, k3, v3, seed, scale, causal, rate, list(heads)))
        ctx.save_for_backward(q3, k3, v3, out, lse)
        ctx.args = (seed, scale, causal, rate, fused, tuple(heads))
        return out

    @staticmethod
    def backward(ctx, g):
        """``delta = sum(out · do)`` here, then the fused kernel (its f32
        dq cast to the operand dtype) or the split dq + dk/dv pair."""
        q3, k3, v3, out, lse = ctx.saved_tensors
        seed, scale, causal, rate, fused, heads = ctx.args
        g = g.contiguous()
        delta = (out.float() * g.float()).sum(dim=-1)
        args = (q3, k3, v3, g, lse, delta, seed, scale, causal, rate)
        if fused:
            dq, dk, dv = bwd_call(*args, **_map_kw(heads))
            dq = dq.to(q3.dtype)
        else:
            dq = bwd_dq_call(*args, **_map_kw(heads))
            dk, dv = bwd_dkv_call(*args, **_map_kw(heads))
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: Optional[float] = None,
                    dropout_rate: float = 0.0, dropout_seed: int = 0,
                    fused_bwd: bool = True,
                    heads=NO_SHARD) -> torch.Tensor:
    """Blockwise causal attention; q/k/v ``[batch, seq, heads, head_dim]``.

    ``dropout_rate`` > 0 applies attention-probability dropout inside the
    kernels with the hash mask keyed by ``dropout_seed`` (vary it per step
    and layer); ``heads`` places the call's batch rows and heads in the
    global ones the mask is keyed on (``(heads here, heads in all,
    first batch row, first head)``). The backward takes the single-pass
    fused kernel where
    ``fused_bwd`` is on and ``fused_backward_supported`` admits the shape,
    and the split dq + dk/dv kernels otherwise (``fused_bwd`` off, head_dim
    256), as the JAX ``flash_attention`` does. The port's fused predicate
    omits JAX's 4 MiB dq-window rule (a TPU VMEM budget), so a seq-8192
    head_dim-128 call takes the fused kernel here and the split pair in
    JAX: the same function either way.
    """
    b, sq, n, d = q.shape
    sk = k.shape[1]
    if causal and sq != sk:
        raise ValueError(f"flash_attention(causal=True) requires q and k to "
                         f"share a seq length; got sq={sq}, sk={sk}")
    scale = scale if scale is not None else d ** -0.5
    fused = bool(fused_bwd) and fused_backward_supported(q, k, causal=causal)

    def to3(x, s):
        return x.transpose(1, 2).reshape(b * n, s, d).contiguous()

    args = (to3(q, sq), to3(k, sk), to3(v, sk), int(dropout_seed),
            float(scale), bool(causal), float(dropout_rate))
    heads = tuple(int(x) for x in heads)
    if heads != NO_SHARD and heads[0] != n:
        raise ValueError(f"flash_attention: head map {heads} for {n} "
                         f"heads a row")
    if needs_grad(q, k, v):
        out3 = _Flash3.apply(*args, fused, heads)
    else:
        out3 = flash_fwd(*args, list(heads))[0]
    return out3.reshape(b, n, sq, d).transpose(1, 2)
