"""Paged-attention decode: the Hopper kernel, its plain version, its gate.

Port of ``fleetx_tpu/ops/paged_attention.py``. The TPU kernel
(``_decode_kernel``, launched by ``_paged_call``) walks each request's
block table over a sequential (batch, head-block, page) grid with
scalar-prefetched page ids. Here the same function is the CUDA kernel in
``csrc/paged_attention.cu`` (built by ``kernels/build.py``, bound with
``ctypes``): one block per (head, request) that reads its table from
device memory and folds every key row of the pool into an f32 online
softmax, each row read once and no dense gather materialised.

- ``paged_call`` takes the JAX argument order and layouts and returns
  the UNnormalised ``(acc [B,nh,hd] f32, m [B,nh], l [B,nh])``. On a CUDA
  tensor it launches the kernel or raises; on a CPU tensor it runs
  ``paged_call_plain``, the gathered-view masked softmax that computes
  the same triple (the CPU tests' path, and on the card the reference the
  smoke script holds the kernel to).
- ``paged_attention`` rewrites ``NULL_PAGE`` entries to the kernel's
  ``-1`` skip sentinel (``_localize_tables``) and normalises.
- ``paged_attention_supported`` is the gate the engine consults once.
  It is re-derived for the card: ``head_dim`` a multiple of 8 up to 256
  (16-byte vector loads, a head row spread over at most one warp), f32 or
  bf16, ``page_size`` >= 1. The TPU's VMEM budget does not apply.

``paged_call.launches`` counts kernel launches (never plain-version
calls), so a run can show that decode went through the kernel.
"""

from __future__ import annotations

import ctypes
import math

import torch

_NEG_INF = -1e30

#: the reserved filler page; must match ``serving.paged_cache.NULL_PAGE``
#: (pinned by a test; importing it here would cycle ops ← serving ← ops)
NULL_PAGE = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def paged_attention_supported(*, num_heads: int, head_dim: int,
                              page_size: int, pages_per_req: int,
                              dtype: torch.dtype = torch.float32) -> bool:
    """True when the CUDA page-walk kernel takes this engine geometry."""
    if num_heads < 1 or pages_per_req < 1 or page_size < 1:
        return False
    if head_dim < 8 or head_dim % 8 or head_dim > 256:
        return False
    return dtype in _DTYPE_CODES


def paged_call_plain(q: torch.Tensor, pool_k: torch.Tensor,
                     pool_v: torch.Tensor, tables: torch.Tensor,
                     lens: torch.Tensor):
    """The kernel's function in plain PyTorch, same inputs and outputs.

    Gathers each request's pages, casts q and k to f32 (as the kernel
    does), masks every slot that is not a valid position ``<= lens[b]``
    of a valid page, and reduces with an f32 softmax held unnormalised.
    """
    B, nh, hd = q.shape
    num_pages, ps = pool_k.shape[0], pool_k.shape[1]
    P = tables.shape[1]
    page_ok = (tables >= 0) & (tables < num_pages)                # [B, P]
    safe = torch.where(page_ok, tables, torch.zeros_like(tables)).long()
    k = pool_k[safe].float()                                 # [B,P,ps,nh,hd]
    v = pool_v[safe].float()
    scale = 1.0 / math.sqrt(hd)
    s = torch.einsum("bnd,bpsnd->bnps", q.float(), k) * scale
    pos = (torch.arange(P, device=q.device)[:, None] * ps
           + torch.arange(ps, device=q.device)[None, :])          # [P, ps]
    lens_l = lens.long()
    valid = (page_ok[:, :, None] & (pos[None] <= lens_l[:, None, None])
             & (lens_l >= 0)[:, None, None])                      # [B,P,ps]
    s = torch.where(valid[:, None], s, torch.full_like(s, _NEG_INF))
    m = s.amax(dim=(-2, -1))                                      # [B, nh]
    p = torch.exp(s - m[..., None, None]) * valid[:, None]
    l = p.sum(dim=(-2, -1))
    acc = torch.einsum("bnps,bpsnd->bnd", p, v)
    return acc, m, l


def _check_cuda_args(q, pool_k, pool_v, tables, lens) -> None:
    """Raise on anything the kernel does not take."""
    dev = q.device
    for name, t in (("pool_k", pool_k), ("pool_v", pool_v),
                    ("tables", tables), ("lens", lens)):
        if t.device != dev:
            raise ValueError(f"paged_call: {name} on {t.device}, q on {dev}")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"paged_call: dtype {q.dtype} not in float32/bfloat16")
    if pool_k.dtype != q.dtype or pool_v.dtype != q.dtype:
        raise TypeError("paged_call: q and the pools must share one dtype")
    if tables.dtype != torch.int32 or lens.dtype != torch.int32:
        raise TypeError("paged_call: tables and lens must be int32")
    if q.dim() != 3 or pool_k.dim() != 4 or tables.dim() != 2 \
            or lens.dim() != 1:
        raise ValueError("paged_call: expected q [B,nh,hd], pools "
                         "[pages,ps,nh,hd], tables [B,P], lens [B]")
    B, nh, hd = q.shape
    if pool_v.shape != pool_k.shape or tuple(pool_k.shape[2:]) != (nh, hd) \
            or tables.shape[0] != B or lens.shape[0] != B:
        raise ValueError(f"paged_call: shape mismatch q {tuple(q.shape)} "
                         f"pools {tuple(pool_k.shape)} tables "
                         f"{tuple(tables.shape)} lens {tuple(lens.shape)}")
    if not paged_attention_supported(num_heads=nh, head_dim=hd,
                                     page_size=pool_k.shape[1],
                                     pages_per_req=tables.shape[1],
                                     dtype=q.dtype) or B < 1:
        raise ValueError(f"paged_call: geometry B={B} nh={nh} hd={hd} "
                         f"outside what the kernel takes")
    for name, t in (("q", q), ("pool_k", pool_k), ("pool_v", pool_v),
                    ("tables", tables), ("lens", lens)):
        if not t.is_contiguous():
            raise ValueError(f"paged_call: {name} must be contiguous")
    for name, t in (("q", q), ("pool_k", pool_k), ("pool_v", pool_v)):
        if t.data_ptr() % 16:
            raise ValueError(f"paged_call: {name} is not 16-byte aligned")


def _kernel_fn():
    """The C entry point with its argument types declared."""
    from fleetx_tpu_torch.kernels import build

    fn = build.load("paged_attention").fleetx_paged_attention_decode
    if fn.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ptr] * 8 + [i32] * 7 + [ctypes.c_float, ptr]
        fn.restype = i32
    return fn


def paged_call(q: torch.Tensor, pool_k: torch.Tensor, pool_v: torch.Tensor,
               tables: torch.Tensor, lens: torch.Tensor):
    """Raw decode attention on one pool (``_paged_call``'s contract).

    ``q`` ``[B, nh, hd]``, pools ``[pages, page_size, nh, hd]`` (f32 or
    bf16), ``tables`` ``[B, pages_per_req]`` int32 with ``-1`` marking
    skipped entries, ``lens`` ``[B]`` int32 query positions (< 0 =
    inactive row). Returns the unnormalised ``(acc, m, l)`` in f32.
    """
    if q.device.type == "cpu":
        return paged_call_plain(q, pool_k, pool_v, tables, lens)
    if q.device.type != "cuda":
        raise ValueError(f"paged_call: no kernel for device {q.device}")
    _check_cuda_args(q, pool_k, pool_v, tables, lens)
    B, nh, hd = q.shape
    acc = torch.empty((B, nh, hd), dtype=torch.float32, device=q.device)
    m = torch.empty((B, nh), dtype=torch.float32, device=q.device)
    l = torch.empty((B, nh), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _kernel_fn()(
        q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
        tables.data_ptr(), lens.data_ptr(), acc.data_ptr(), m.data_ptr(),
        l.data_ptr(), B, nh, hd, pool_k.shape[0], pool_k.shape[1],
        tables.shape[1], _DTYPE_CODES[q.dtype], 1.0 / math.sqrt(hd), stream)
    if err != 0:
        raise RuntimeError(f"paged attention kernel launch failed: CUDA "
                           f"error {err}")
    paged_call.launches += 1
    return acc, m, l


paged_call.launches = 0


def _localize_tables(tables: torch.Tensor, num_pages: int) -> torch.Tensor:
    """Null pages and ids outside ``[0, num_pages)`` become the kernel's
    ``-1`` skip sentinel (the single-pool case of the reference's
    per-shard localisation)."""
    ok = (tables != NULL_PAGE) & (tables >= 0) & (tables < num_pages)
    return torch.where(ok, tables, torch.full_like(tables, -1)).to(
        torch.int32)


def _normalize(acc: torch.Tensor, l: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    """Final softmax division; rows with ``l == 0`` (inactive: every page
    skipped) come out exactly zero instead of NaN."""
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    return (acc / l_safe[..., None]).to(dtype)


def paged_attention(q: torch.Tensor, pool_k: torch.Tensor,
                    pool_v: torch.Tensor, block_tables: torch.Tensor,
                    lens: torch.Tensor) -> torch.Tensor:
    """Single-pool paged decode attention, output in ``q.dtype``.

    Matches ``serving/decode.py``'s gather path for active rows (softmax
    over positions ``<= lens`` with ``1/sqrt(head_dim)`` scaling, f32
    accumulation); inactive rows (``lens < 0``) return exact zeros.
    """
    tables = _localize_tables(block_tables, pool_k.shape[0]).contiguous()
    acc, _, l = paged_call(q.contiguous(), pool_k, pool_v, tables,
                           lens.to(torch.int32).contiguous())
    return _normalize(acc, l, q.dtype)
