"""Paged-attention decode: the Hopper kernel, its plain versions, its gate.

Port of ``fleetx_tpu/ops/paged_attention.py``. The TPU kernel
(``_decode_kernel``, launched by ``_paged_call``) walks each request's
block table over a sequential (batch, head-block, page) grid with
scalar-prefetched page ids. Here the same function is the CUDA kernel in
``csrc/paged_attention.cu`` (built by ``kernels/build.py``, bound with
``ctypes``): a split page walk. Each block owns a chunk of consecutive
table entries of one request and a block of heads, copies the chunk's
pages into a shared-memory ring with bulk asynchronous copies, folds them
into an f32 online softmax, and the last block of a request to finish
merges the chunks' partials in chunk order, in the same launch.

- ``paged_call`` takes the JAX argument order and layouts and returns
  the UNnormalised ``(acc [B,nh,hd] f32, m [B,nh], l [B,nh])``. On a CUDA
  tensor it launches the kernel or raises; on a CPU tensor it runs
  ``paged_call_plain``, the gathered-view masked softmax that computes
  the same triple (the CPU tests' path, and on the card the reference the
  smoke script holds the kernel to).
- ``paged_call_plain_split`` computes the same triple the kernel's way:
  a partial per chunk of ``pages_per_chunk`` table entries, merged in
  chunk order. The tests and the smoke script use it; the decode path
  never does.
- ``plan_split`` is the host-side planner: head block, rows per tile,
  pages per chunk and ring depth from the static geometry, every one of
  them fitting the card's 227 KB of shared memory a block.
- ``paged_attention`` rewrites ``NULL_PAGE`` entries to the kernel's
  ``-1`` skip sentinel (``_localize_tables``) and normalises.
- ``paged_attention_supported`` is the gate the engine consults once.
  It is re-derived for the card: ``head_dim`` a multiple of 8 up to 256
  (16-byte bulk copies and vector loads), f32 or bf16, ``page_size`` >= 1.
  The TPU's VMEM budget does not apply.
- ``paged_attention_sharded`` runs the same kernel on one rank's shard of
  a mesh-placed pool (pages over ``fsdp``, heads over ``tensor``): the
  tables are localised to the shard's pages (``_localize_tables``;
  another shard's pages become ``-1`` wherever they sit), and the
  partial triples are merged with the reference's flash-decoding combine
  (``pmax`` of ``m``, then one ``psum`` of the rescaled numerator and
  denominator) in plain torch around the kernel, as JAX does outside the
  Pallas call. ``paged_sharded_supported`` is its gate.

``paged_call.launches`` counts kernel launches (never plain-version
calls), so a run can show that decode went through the kernel; the count
is taken under a lock, since replicas in one process decode on threads
of their own.
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading
from dataclasses import dataclass
from typing import Any, Optional

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


def paged_sharded_supported(mesh: Any, *, num_heads: int,
                            num_pages: int) -> bool:
    """True when the per-shard kernel call applies: the pool's page dim
    splits evenly over ``fsdp`` and its head dim over ``tensor`` (the
    ``serving_kv`` placement), and decode runs under neither sequence
    nor pipeline parallelism."""
    if mesh is None:
        return False
    shape = dict(mesh.shape)
    if shape.get("seq", 1) != 1 or shape.get("pipe", 1) != 1:
        return False
    return num_pages % shape.get("fsdp", 1) == 0 and \
        num_heads % shape.get("tensor", 1) == 0


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


def paged_call_plain_split(q: torch.Tensor, pool_k: torch.Tensor,
                           pool_v: torch.Tensor, tables: torch.Tensor,
                           lens: torch.Tensor, pages_per_chunk: int):
    """The kernel's split in plain PyTorch: the triple of each chunk of
    ``pages_per_chunk`` table entries, merged in chunk order.

    A chunk that starts beyond ``lens[b]`` (every chunk of an inactive
    row) is the empty partial ``m = -1e30, l = 0, acc = 0``, as is a chunk
    whose pages are all skipped; the merge rescales each partial by
    ``exp(m_c - m)`` against the largest ``m`` and sums in chunk order, so
    an all-empty row stays ``(0, -1e30, 0)``.
    """
    ps, P = pool_k.shape[1], tables.shape[1]
    span = pages_per_chunk * ps
    parts = []
    for c in range(-(-P // pages_per_chunk)):
        sub = tables[:, c * pages_per_chunk:(c + 1) * pages_per_chunk]
        local = lens.long() - c * span
        # a chunk beyond lens[b] reads nothing: its local position is < 0
        parts.append(paged_call_plain(
            q, pool_k, pool_v, sub.contiguous(),
            torch.where(local < 0, torch.full_like(local, -1),
                        local).to(torch.int32)))
    m = parts[0][1]
    for _, m_c, _ in parts[1:]:
        m = torch.maximum(m, m_c)
    acc = torch.zeros_like(parts[0][0])
    l = torch.zeros_like(parts[0][2])
    for acc_c, m_c, l_c in parts:
        w = torch.exp(m_c - m)
        acc = acc + acc_c * w[..., None]
        l = l + l_c * w
    return acc, m, l


#: consumer groups of a block, each of ``GROUP_THREADS`` threads, folding
#: alternate pages of its chunk (``kGroups``, ``kGroupThreads``)
GROUPS = 2
GROUP_THREADS = 128
#: threads of one kernel block (``kThreads`` in the source)
THREADS = GROUPS * GROUP_THREADS
#: f32 bytes of the workers' (m, l) and head-row slices (``kWorkerBytes``)
WORKER_BYTES = 4 * (2 * THREADS + 8 * THREADS)
#: bytes of one K or V tile the planner aims for
TILE_BYTES = 8 * 1024
#: most rows (or heads) of one TMA box
MAX_BOX = 256
#: ring slots (a page's K and V tiles each) in flight per group
SLOTS = 2
#: most table entries one block walks
MAX_CHUNK_PAGES = 8
#: blocks the planner wants resident per SM for a full table
BLOCKS_PER_SM = 2
#: shared memory one block may use on sm_90 (227 KB)
SMEM_LIMIT = 232448
#: SMs of the H100 SXM; a CUDA plan reads the card's own count
H100_SMS = 132


def _round_up(n: int, k: int) -> int:
    return -(-n // k) * k


def group_lanes(head_dim: int, itemsize: int) -> int:
    """Lanes of one worker (``group_lanes`` in the source): the fewest, a
    power of two up to 32, whose 16-byte vectors span a head row."""
    g = 1
    while g < 32 and g < head_dim * itemsize // 16:
        g *= 2
    return g


def smem_bytes(head_block: int, rows_per_tile: int, head_dim: int,
               itemsize: int, slots: int, pages_per_chunk: int) -> int:
    """Dynamic shared memory of one block (``smem_bytes`` in the source,
    which ``chip_smoke.py`` holds equal): alignment, the ring of K and V
    tiles, the workers' f32 state, the mbarriers, the work item, the
    chunk's table, a flag."""
    tile = _round_up(rows_per_tile * head_block * head_dim * itemsize, 128)
    return (128 + GROUPS * slots * 2 * tile + WORKER_BYTES + 8 * GROUPS * slots
            + 16 + 4 * pages_per_chunk + 16)


@dataclass(frozen=True)
class SplitPlan:
    """How the kernel splits one call: ``route`` is ``"bulk_split"`` (the
    CUDA kernel) or ``"plain"`` (a CPU tensor: ``paged_call_plain``)."""

    route: str
    head_block: int
    rows_per_tile: int
    pages_per_chunk: int
    slots: int
    smem_bytes: int

    def grid(self, batch: int, num_heads: int, pages_per_req: int):
        """(chunks, head blocks, requests) of one launch."""
        return (-(-pages_per_req // self.pages_per_chunk),
                -(-num_heads // self.head_block), batch)


def plan_split(*, batch: int, num_heads: int, head_dim: int,
               page_size: int, pages_per_req: int, dtype: torch.dtype,
               device: torch.device, sms: int = H100_SMS) -> SplitPlan:
    """The split of one geometry, from static shapes only (no lens: the
    plan never waits on the device).

    Head block: all heads when a page's K rows of all heads fit a
    ``TILE_BYTES`` tile, else the most heads that do (at least one), never
    more heads than a group has workers. Rows per tile: the page, or as
    many rows as fit the tile (at most a TMA box's 256). Pages per chunk:
    the most, up to ``MAX_CHUNK_PAGES``, that still give
    ``BLOCKS_PER_SM`` blocks on every SM for a full table, so no block
    walks more than a few pages.
    """
    itemsize = dtype.itemsize
    row = head_dim * itemsize
    hb = max(1, min(num_heads, GROUP_THREADS // group_lanes(head_dim,
                                                            itemsize),
                    TILE_BYTES // (page_size * row)))
    rb = max(1, min(page_size, MAX_BOX, TILE_BYTES // (hb * row)))
    n_hblk = -(-num_heads // hb)
    ppc = 1
    while (ppc * 2 <= MAX_CHUNK_PAGES and batch * n_hblk * -(
            -pages_per_req // (ppc * 2)) >= BLOCKS_PER_SM * sms):
        ppc *= 2
    route = "bulk_split" if device.type == "cuda" else "plain"
    return SplitPlan(route, hb, rb, ppc, SLOTS,
                     smem_bytes(hb, rb, head_dim, itemsize, SLOTS, ppc))


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
        fn.argtypes = [ptr] * 10 + [i32] * 11 + [ctypes.c_float, ptr]
        fn.restype = i32
    return fn


#: (device, stream, batch, head blocks, chunks, head block, head_dim) →
#: the kernel's f32 partials and its zeroed arrival counters, allocated
#: once: a decode step reuses the same buffers every layer and every step,
#: and launches on two streams, which may overlap, never share them
_workspaces: dict = {}


def _workspace(dev: torch.device, stream: int, batch: int, n_hblk: int,
               n_chunks: int, head_block: int, head_dim: int):
    key = (dev, stream, batch, n_hblk, n_chunks, head_block, head_dim)
    ws = _workspaces.get(key)
    if ws is None:
        parts = batch * n_hblk * n_chunks
        ws = (torch.empty(parts * head_block * (head_dim + 2),
                          dtype=torch.float32, device=dev),
              torch.zeros(batch * n_hblk, dtype=torch.int32, device=dev))
        _workspaces[key] = ws
    return ws


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch(q, pool_k, pool_v, tables, lens, plan: SplitPlan):
    """Launch the kernel with ``plan`` (checked arguments); returns the
    unnormalised triple."""
    B, nh, hd = q.shape
    P = tables.shape[1]
    n_chunks, n_hblk, _ = plan.grid(B, nh, P)
    stream = _stream(q)
    ws, counters = _workspace(q.device, stream, B, n_hblk, n_chunks,
                              plan.head_block, hd)
    acc = torch.empty((B, nh, hd), dtype=torch.float32, device=q.device)
    m = torch.empty((B, nh), dtype=torch.float32, device=q.device)
    l = torch.empty((B, nh), dtype=torch.float32, device=q.device)
    err = _kernel_fn()(
        q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
        tables.data_ptr(), lens.data_ptr(), acc.data_ptr(), m.data_ptr(),
        l.data_ptr(), ws.data_ptr(), counters.data_ptr(), B, nh, hd,
        pool_k.shape[0], pool_k.shape[1], P, plan.head_block,
        plan.rows_per_tile, plan.pages_per_chunk, plan.slots,
        _DTYPE_CODES[q.dtype], 1.0 / math.sqrt(hd), stream)
    if err != 0:
        raise RuntimeError(f"paged attention kernel launch failed: CUDA "
                           f"error {err}")
    return acc, m, l


@functools.lru_cache(maxsize=None)
def _cuda_plan(batch: int, num_heads: int, head_dim: int, page_size: int,
               pages_per_req: int, dtype: torch.dtype,
               index: int) -> SplitPlan:
    """The plan of one geometry on CUDA device ``index`` (its own SM
    count), made once: a decode step asks for it every layer."""
    return plan_split(
        batch=batch, num_heads=num_heads, head_dim=head_dim,
        page_size=page_size, pages_per_req=pages_per_req, dtype=dtype,
        device=torch.device("cuda", index),
        sms=torch.cuda.get_device_properties(index).multi_processor_count)


def _plan_for(q, pool_k, tables) -> SplitPlan:
    """The plan of a call's tensors (``route`` "plain" off the card)."""
    B, nh, hd = q.shape
    if q.device.type == "cuda":
        index = q.device.index if q.device.index is not None \
            else torch.cuda.current_device()
        return _cuda_plan(B, nh, hd, pool_k.shape[1], tables.shape[1],
                          q.dtype, index)
    return plan_split(batch=B, num_heads=nh, head_dim=hd,
                      page_size=pool_k.shape[1],
                      pages_per_req=tables.shape[1], dtype=q.dtype,
                      device=q.device)


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
    out = _launch(q, pool_k, pool_v, tables, lens,
                  _plan_for(q, pool_k, tables))
    with _launches_lock:
        paged_call.launches += 1
    return out


paged_call.launches = 0
_launches_lock = threading.Lock()


def _localize_tables(tables: torch.Tensor, page_lo: int,
                     local_pages: Optional[int] = None) -> torch.Tensor:
    """Rewrite global page ids to the ids of a shard holding the pages
    ``[page_lo, page_lo + local_pages)``; null pages and pages another
    shard owns become the kernel's ``-1`` skip sentinel, wherever they
    sit in a table. With two arguments the second is the page count of
    one whole pool (``page_lo`` 0)."""
    if local_pages is None:
        page_lo, local_pages = 0, page_lo
    local = tables - int(page_lo)
    ok = (tables != NULL_PAGE) & (local >= 0) & (local < int(local_pages))
    return torch.where(ok, local, torch.full_like(local, -1)).to(
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


def paged_attention_sharded(q: torch.Tensor, pool_k: torch.Tensor,
                            pool_v: torch.Tensor, block_tables: torch.Tensor,
                            lens: torch.Tensor, *,
                            mesh: Optional[Any] = None) -> torch.Tensor:
    """Paged decode attention on a rank's shard of a mesh-placed pool.

    ``q`` ``[B, nh / tensor, hd]`` holds this rank's heads and the pools
    ``[pages / fsdp, page_size, nh / tensor, hd]`` its pages of them;
    ``block_tables`` hold global page ids. Each rank walks its own pages
    (``paged_call``: kernel row 7 on a CUDA tensor) and the partial
    ``(acc, m, l)`` triples are merged over ``fsdp`` with the
    flash-decoding combine of the reference: ``m_g = pmax(m)``, ``w =
    exp(m - m_g)``, ``psum(acc * w)`` and ``psum(l * w)``, then the
    normalisation. Heads need no combine: each rank's are its own. With
    no mesh (or a trivial one) this is ``paged_attention``. Callers gate
    on ``paged_sharded_supported``.
    """
    from fleetx_tpu_torch.parallel.mesh import axis_index, pmax, psum

    fsdp = 1 if mesh is None else mesh.shape.get("fsdp", 1)
    if fsdp == 1:
        return paged_attention(q, pool_k, pool_v, block_tables, lens)
    local_pages = pool_k.shape[0]
    lo = axis_index("fsdp", mesh) * local_pages
    tables = _localize_tables(block_tables, lo, local_pages).contiguous()
    acc, m, l = paged_call(q.contiguous(), pool_k, pool_v, tables,
                           lens.to(torch.int32).contiguous())
    m_g = pmax(m, "fsdp", mesh)
    w = torch.exp(m - m_g)
    # one psum of the packed numerator and denominator: the two psums of
    # the reference in one collective
    packed = psum(torch.cat([acc * w[..., None], (l * w)[..., None]], -1),
                  "fsdp", mesh)
    return _normalize(packed[..., :-1], packed[..., -1], q.dtype)
