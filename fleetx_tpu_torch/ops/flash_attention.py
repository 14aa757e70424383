"""Causal flash attention: the Hopper forward and fused-backward kernels,
their plain versions, the gates, the dropout hash and the autograd
wrapper.

Port of ``fleetx_tpu/ops/flash_attention.py``. The TPU kernels are
``_fwd_kernel`` (launched by ``_fwd``) and ``_bwd_fused_kernel``
(launched by ``_bwd_fused``); here the same two functions are the CUDA
kernels in ``csrc/flash_attention.cu`` (built by ``kernels/build.py``,
bound with ``ctypes``).

- ``fwd_call(q3, k3, v3, seed, scale, causal, rate)`` → ``(out, lse)``:
  FlashAttention-2 forward over ``[b·heads, seq, head_dim]``: f32 scores,
  masked with -1e30 above the diagonal, f32 online softmax whose
  normaliser uses the UNdropped ``p``; dropout scales only ``p @ v``.
  ``out`` in the input dtype, ``lse = m + log(l)`` in f32.
- ``bwd_call(q3, k3, v3, do, lse, delta, seed, scale, causal, rate)`` →
  ``(dq f32, dk, dv)``: the single-pass fused backward, P recomputed from
  ``lse``, ``dv``/``dp`` masked as ``_bwd_fused_kernel:484-493``;
  ``delta = sum(out · do)`` is computed outside, as ``_bwd`` does.

On a CUDA tensor each launches its kernel or raises; on a CPU tensor it
runs its dense plain version (``fwd_plain`` / ``bwd_plain``), which the
CPU tests hold against the Pallas kernels and ``chip_smoke.py`` holds the
kernels against on the card. ``fwd_call.launches`` / ``bwd_call.launches``
count kernel launches only.

Dropout. The TPU kernel draws its mask from the TPU's hardware PRNG per
block; those bits cannot be had on a GPU. Here the mask is one
counter-based hash keyed per ELEMENT by ``(seed, b·head, row, col)``
(``dropout_bits``: three rounds of a 32-bit integer mixer), written
identically in the CUDA source and below in int64 arithmetic masked to
32 bits. Forward and backward therefore see the same mask whatever
their tiling, and kernel and plain version use bit-identical masks. An
element is kept when ``bits >= rate·2^32`` and scaled by ``1/(1-rate)``,
as ``_dropout_mask`` decides.

The gates keep the JAX contract: ``supported`` (rank 4, seq a multiple of
128, ``sq == sk`` under causal, head_dim in {64, 128, 256}) and
``fused_backward_supported`` (that, and head_dim <= 128). The TPU's VMEM
budgets do not apply. A shape the fused backward rejects needs the split
backward kernels, which are not ported yet.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

_NEG_INF = -1e30
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_MASK32 = 0xFFFFFFFF

SPLIT_BWD = ("the split flash backward (kernels 2/3, _bwd_dq_kernel and "
             "_bwd_dkv_kernel) is not ported yet (ROADMAP.md, kernel queue "
             "items 2-3)")


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
    """True when the single-pass fused backward kernel applies."""
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


def dropout_bits(seed: int, bh: int, sq: int, sk: int,
                 device=None) -> torch.Tensor:
    """The kernels' 32-bit random word per element, ``[bh, sq, sk]`` int64:
    ``mix32(mix32(mix32(seed ^ mix32(h ^ K0)) ^ row) ^ (col · K1))``."""
    heads = torch.arange(bh, dtype=torch.int64, device=device)
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
                 device=None) -> torch.Tensor:
    """The kernels' keep mask ``[bh, sq, sk]`` (bool)."""
    return dropout_bits(seed, bh, sq, sk, device) >= keep_threshold(rate)


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
              rate: float = 0.0):
    """The forward kernel's function, dense: ``(out, lse)``."""
    s = _scores(q3, k3, scale, causal)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    if rate > 0.0:
        keep = dropout_keep(seed, q3.shape[0], q3.shape[1], k3.shape[1],
                            rate, q3.device)
        p = torch.where(keep, p / (1.0 - rate), torch.zeros_like(p))
    acc = torch.einsum("bqk,bkd->bqd", p, v3.float())
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    out = (acc / l_safe[..., None]).to(q3.dtype)
    return out, m + torch.log(l_safe)


def bwd_plain(q3: torch.Tensor, k3: torch.Tensor, v3: torch.Tensor,
              do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
              seed: int, scale: float, causal: bool = True,
              rate: float = 0.0):
    """The fused backward kernel's function, dense: ``(dq f32, dk, dv)``."""
    q, k, v, g = q3.float(), k3.float(), v3.float(), do.float()
    p = torch.exp(_scores(q3, k3, scale, causal) - lse[..., None])
    dp = torch.einsum("bqd,bkd->bqk", g, v)
    if rate > 0.0:
        keep = dropout_keep(seed, q3.shape[0], q3.shape[1], k3.shape[1],
                            rate, q3.device)
        inv = 1.0 / (1.0 - rate)
        zero = torch.zeros_like(p)
        dv = torch.einsum("bqk,bqd->bkd", torch.where(keep, p * inv, zero),
                          g)
        dp = torch.where(keep, dp * inv, zero)
    else:
        dv = torch.einsum("bqk,bqd->bkd", p, g)
    ds = p * (dp - delta[..., None]) * scale
    dk = torch.einsum("bqk,bqd->bkd", ds, q)
    dq = torch.einsum("bqk,bkd->bqd", ds, k)
    return dq, dk.to(k3.dtype), dv.to(v3.dtype)


# ------------------------------------------------------------ kernels
def _fns():
    """The two C entry points with their argument types declared."""
    from fleetx_tpu_torch.kernels import build

    lib = build.load("flash_attention")
    fwd, bwd = lib.fleetx_flash_fwd, lib.fleetx_flash_bwd_fused
    if fwd.argtypes is None:
        ptr, i32, u32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
        f32 = ctypes.c_float
        fwd.argtypes = [ptr] * 5 + [i32] * 6 + [f32, u32, u32, i32, f32, ptr]
        fwd.restype = i32
        bwd.argtypes = [ptr] * 9 + [i32] * 6 + [f32, u32, u32, i32, f32, ptr]
        bwd.restype = i32
    return fwd, bwd


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


def fwd_call(q3: torch.Tensor, k3: torch.Tensor, v3: torch.Tensor,
             seed: int, scale: float, causal: bool = True,
             rate: float = 0.0):
    """Forward over ``[b·heads, seq, head_dim]``: ``(out, lse f32)``."""
    if q3.device.type == "cpu":
        return fwd_plain(q3, k3, v3, seed, scale, causal, rate)
    if q3.device.type != "cuda":
        raise ValueError(f"flash attention: no kernel for device "
                         f"{q3.device}")
    bh, sq, sk, d = _geometry(q3, k3, causal)
    _check("flash fwd", (q3, k3, v3), ((bh, sq, d), (bh, sk, d),
                                       (bh, sk, d)))
    if k3.dtype != q3.dtype or v3.dtype != q3.dtype:
        raise TypeError("flash fwd: q, k and v must share one dtype")
    out = torch.empty_like(q3)
    lse = torch.empty((bh, sq), dtype=torch.float32, device=q3.device)
    stream = torch.cuda.current_stream(q3.device).cuda_stream
    fwd, _ = _fns()
    err = fwd(q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), out.data_ptr(),
              lse.data_ptr(), bh, sq, sk, d, int(causal),
              _DTYPE_CODES[q3.dtype], float(scale), int(seed) & _MASK32,
              keep_threshold(rate), int(rate > 0.0), 1.0 - float(rate),
              stream)
    if err != 0:
        raise RuntimeError(f"flash attention forward kernel launch failed: "
                           f"CUDA error {err}")
    fwd_call.launches += 1
    return out, lse


fwd_call.launches = 0


def bwd_call(q3: torch.Tensor, k3: torch.Tensor, v3: torch.Tensor,
             do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
             seed: int, scale: float, causal: bool = True,
             rate: float = 0.0):
    """Fused backward: ``(dq f32, dk, dv)`` (dk/dv in the input dtype)."""
    if q3.device.type == "cpu":
        return bwd_plain(q3, k3, v3, do, lse, delta, seed, scale, causal,
                         rate)
    if q3.device.type != "cuda":
        raise ValueError(f"flash attention: no kernel for device "
                         f"{q3.device}")
    bh, sq, sk, d = _geometry(q3, k3, causal)
    if d > 128:
        raise NotImplementedError(
            f"fused flash backward takes head_dim <= 128, got {d}: "
            f"{SPLIT_BWD}")
    _check("flash bwd", (q3, k3, v3, do), ((bh, sq, d), (bh, sk, d),
                                           (bh, sk, d), (bh, sq, d)))
    if len({t.dtype for t in (q3, k3, v3, do)}) != 1:
        raise TypeError("flash bwd: q, k, v and do must share one dtype")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.dtype != torch.float32 or tuple(t.shape) != (bh, sq) \
                or not t.is_contiguous() or t.device != q3.device:
            raise ValueError(f"flash bwd: {name} must be contiguous f32 "
                             f"[{bh}, {sq}] on {q3.device}")
    dq = torch.empty((bh, sq, d), dtype=torch.float32, device=q3.device)
    dk = torch.empty_like(k3)
    dv = torch.empty_like(v3)
    stream = torch.cuda.current_stream(q3.device).cuda_stream
    _, bwd = _fns()
    inv = 1.0 / (1.0 - rate) if rate > 0.0 else 1.0
    err = bwd(q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), do.data_ptr(),
              lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
              dk.data_ptr(), dv.data_ptr(), bh, sq, sk, d, int(causal),
              _DTYPE_CODES[q3.dtype], float(scale), int(seed) & _MASK32,
              keep_threshold(rate), int(rate > 0.0), float(inv), stream)
    if err != 0:
        raise RuntimeError(f"flash attention backward kernel launch failed: "
                           f"CUDA error {err}")
    bwd_call.launches += 1
    return dq, dk, dv


bwd_call.launches = 0


# ----------------------------------------------------------- autograd
class _Flash3(torch.autograd.Function):
    """Flash attention on ``[b·heads, seq, head_dim]`` operands."""

    @staticmethod
    def forward(ctx, q3, k3, v3, seed, scale, causal, rate):
        """Forward kernel; saves the operands, ``out`` and ``lse``."""
        out, lse = fwd_call(q3, k3, v3, seed, scale, causal, rate)
        ctx.save_for_backward(q3, k3, v3, out, lse)
        ctx.args = (seed, scale, causal, rate)
        return out

    @staticmethod
    def backward(ctx, g):
        """``delta = sum(out · do)`` here, then the fused backward kernel;
        dq comes back f32 and is cast to the operand dtype."""
        q3, k3, v3, out, lse = ctx.saved_tensors
        seed, scale, causal, rate = ctx.args
        g = g.contiguous()
        delta = (out.float() * g.float()).sum(dim=-1)
        dq, dk, dv = bwd_call(q3, k3, v3, g, lse, delta, seed, scale,
                              causal, rate)
        return dq.to(q3.dtype), dk, dv, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: Optional[float] = None,
                    dropout_rate: float = 0.0, dropout_seed: int = 0,
                    fused_bwd: bool = True) -> torch.Tensor:
    """Blockwise causal attention; q/k/v ``[batch, seq, heads, head_dim]``.

    ``dropout_rate`` > 0 applies attention-probability dropout inside the
    kernels with the hash mask keyed by ``dropout_seed`` (vary it per step
    and layer). A backward the fused kernel cannot take (``fused_bwd``
    off, or head_dim > 128) raises ``NotImplementedError`` when gradients
    are needed.
    """
    b, sq, n, d = q.shape
    sk = k.shape[1]
    if causal and sq != sk:
        raise ValueError(f"flash_attention(causal=True) requires q and k to "
                         f"share a seq length; got sq={sq}, sk={sk}")
    needs_grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    if needs_grad and not (fused_bwd and fused_backward_supported(
            q, k, causal=causal)):
        raise NotImplementedError(
            f"flash attention backward for head_dim {d} with "
            f"fused_bwd={fused_bwd}: {SPLIT_BWD}")
    scale = scale if scale is not None else d ** -0.5

    def to3(x, s):
        return x.transpose(1, 2).reshape(b * n, s, d).contiguous()

    out3 = _Flash3.apply(to3(q, sq), to3(k, sk), to3(v, sk),
                         int(dropout_seed), float(scale), bool(causal),
                         float(dropout_rate))
    return out3.reshape(b, n, sq, d).transpose(1, 2)

