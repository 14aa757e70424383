"""Paged KV cache: a preallocated page pool + a host-side page allocator.

Port of ``fleetx_tpu/serving/paged_cache.py`` with unchanged semantics.
Pool layout (K and V each), in the config's dtype on the engine's
device::

    [layers, num_pages, page_size, heads, head_dim]

Page 0 is the reserved **null page**: block-table filler slots and masked
(inactive) batch rows point at it, so the steps scatter/gather with fully
static shapes; whatever is written to or read from page 0 is always
masked out of the attention scores.

Sharding: ``pool_shardings(mesh)`` places the page dim over ``fsdp`` and
the heads dim over ``tensor`` (``parallel/rules.py:kv_pool_spec``), and
``init_pool(..., mesh=...)`` allocates this rank's shard only, as one
contiguous tensor ``[layers, pages / fsdp, page_size, heads / tensor,
head_dim]``. The ``PageAllocator`` keeps global page ids, as in JAX:
fsdp shard ``s`` holds pages ``[s * pages / fsdp, (s + 1) * pages /
fsdp)``, so the null page 0 lives on shard 0.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Union

import torch

from fleetx_tpu_torch.observability import tsan

#: reserved scratch page — never allocated, always masked when read
NULL_PAGE = 0


class PageAllocatorError(ValueError):
    """A page-accounting violation: double-free, freeing a page that was
    never handed out, or an invalid (non-positive) allocation size.

    A real exception, not an ``assert``: under ``python -O`` an assert
    vanishes and a double-free would hand one page to two requests.
    Exhaustion is not an error: ``alloc`` returns None for that.
    """


@dataclasses.dataclass(frozen=True)
class PoolSharding:
    """The pool's placement on a mesh (JAX's ``NamedSharding``): ``spec``
    names the mesh axes of ``(layers, pages, page_size, heads,
    head_dim)``."""

    mesh: Any
    spec: tuple

    def degree(self, dim: int) -> int:
        """The combined mesh degree of pool dim ``dim``."""
        entry = self.spec[dim] if dim < len(self.spec) else None
        n = 1
        for a in (entry if isinstance(entry, (tuple, list)) else (entry,)):
            if a is not None:
                n *= self.mesh.shape[a]
        return n

    def local_shape(self, shape: tuple) -> tuple:
        """This rank's shard of a pool of global ``shape``; a dim its
        degree does not divide raises (JAX's ``device_put`` refuses an
        uneven pool too)."""
        out = []
        for dim, size in enumerate(shape):
            n = self.degree(dim)
            if size % n:
                raise ValueError(
                    f"pool dim {dim} of {size} does not split over the "
                    f"mesh's {self.spec[dim]!r} degree {n}")
            out.append(size // n)
        return tuple(out)


def pool_shardings(mesh: Any) -> PoolSharding:
    """The pool's mesh placement: pages over ``fsdp``, heads over
    ``tensor`` (the registry's ``serving_kv`` rule)."""
    from fleetx_tpu_torch.parallel.rules import kv_pool_spec

    return PoolSharding(mesh, kv_pool_spec())


def init_pool(cfg: Any, num_pages: int, page_size: int, dtype: Any = None,
              device: Union[str, torch.device] = "cpu",
              sharding: Optional[PoolSharding] = None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Allocate the (K, V) page pools for a GPT config: the whole pool,
    or under ``sharding`` this rank's shard of it.

    ``num_pages`` INCLUDES the reserved null page, so usable capacity is
    ``(num_pages - 1) * page_size`` token slots per layer.
    """
    dtype = dtype or cfg.dtype
    shape = (cfg.num_layers, int(num_pages), int(page_size),
             cfg.num_attention_heads, cfg.head_dim)
    if sharding is not None:
        shape = sharding.local_shape(shape)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


class PageAllocator:
    """Host-side free-list allocator over the pool's page ids.

    Policy-free: it hands out and reclaims page ids, all-or-nothing, and
    raises :class:`PageAllocatorError` on any accounting violation; the
    engine's lazy admission and preempt-youngest policies sit on top.
    Owned by the engine's scheduler thread (``FLEETX_TSAN=1`` flags a
    cross-thread alloc/free).
    """

    def __init__(self, num_pages: int, page_size: int):
        if num_pages < 2:
            raise PageAllocatorError(
                "need at least the null page + one usable page")
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        # LIFO free list → recently-freed (cache-warm) pages are reused first
        self._free = list(range(self.num_pages - 1, NULL_PAGE, -1))
        self._allocated: set[int] = set()
        tsan.register_object(self, "page-allocator")

    @property
    def usable_pages(self) -> int:
        """Pages that can ever be handed out (pool minus the null page)."""
        return self.num_pages - 1

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def allocated_pages(self) -> int:
        return len(self._allocated)

    def pages_needed(self, tokens: int) -> int:
        """Pages required to hold ``tokens`` KV entries."""
        return max(-(-int(tokens) // self.page_size), 1)

    def can_allocate(self, n: int) -> bool:
        """Whether ``n`` pages are free right now."""
        return n <= len(self._free)

    def fits_ever(self, n: int) -> bool:
        """Whether ``n`` pages could EVER be satisfied (False = the request
        is larger than the pool)."""
        return n <= self.usable_pages

    def alloc(self, n: int) -> Optional[list[int]]:
        """Allocate ``n`` pages, or None (state untouched) when the free
        list cannot satisfy the request; ``n <= 0`` raises."""
        tsan.note_access(self, "alloc")
        if n <= 0:
            raise PageAllocatorError(f"invalid allocation size {n}")
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        self._allocated.update(pages)
        return pages

    def free(self, pages: list[int]) -> None:
        """Return ``pages`` to the free list; a page that is not currently
        allocated raises :class:`PageAllocatorError`."""
        tsan.note_access(self, "free")
        for p in pages:
            if p not in self._allocated:
                raise PageAllocatorError(
                    f"freeing unallocated page {p} (double-free or foreign "
                    f"id); {len(self._allocated)} pages currently out")
            self._allocated.discard(p)
            self._free.append(p)

    def occupancy(self) -> float:
        """Allocated fraction of usable pages (the page-occupancy gauge)."""
        return len(self._allocated) / max(self.usable_pages, 1)

    def internal_fragmentation(self, used_slots: int) -> float:
        """Reserved-but-unwritten fraction of the allocated slots."""
        allocated_slots = len(self._allocated) * self.page_size
        if allocated_slots <= 0:
            return 0.0
        return 1.0 - min(int(used_slots), allocated_slots) / allocated_slots
