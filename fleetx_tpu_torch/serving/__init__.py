"""Serving runtime of the port: continuous batching over a paged KV cache.

- ``paged_cache`` — page pool + host-side page allocator, and the pool's
  placement on a mesh (``pool_shardings``: pages over fsdp, heads over
  tensor);
- ``decode``      — chunk-prefill and one-token decode steps, tensor-
  parallel over a mesh (``shard_params``);
- ``engine``      — the continuous-batching scheduler; on a mesh its
  leader schedules and every rank computes (``follow``);
- ``server``      — one engine replica behind a JSON-lines TCP front, with
  the fault plan's chaos knobs;
- ``router``      — the breaker-gated, hedging request router over N
  replicas and the fleet observer (stdlib only);
- ``bench``       — the Poisson-load serving bench.

The package's exports resolve on first attribute access (PEP 562, as
``fleetx_tpu/serving/__init__.py:25-44`` does), so ``import
fleetx_tpu_torch.serving.router`` never imports torch: the router comes
up before the replicas it fronts.
"""

__all__ = ["ServingConfig", "ServingEngine", "PageAllocator", "init_pool",
           "NULL_PAGE"]

#: package export → defining submodule, imported on first access
_EXPORTS = {
    "ServingConfig": "engine", "ServingEngine": "engine",
    "PageAllocator": "paged_cache", "init_pool": "paged_cache",
    "NULL_PAGE": "paged_cache",
}


def __getattr__(name: str):
    """Lazy package exports (keeps the router's import path torch-free)."""
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(f"{__name__}.{module}"), name)
