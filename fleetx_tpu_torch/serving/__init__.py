"""Serving runtime of the port: continuous batching over a paged KV cache.

- ``paged_cache`` — page pool + host-side page allocator;
- ``decode``      — chunk-prefill and one-token decode steps;
- ``engine``      — the continuous-batching scheduler;
- ``server``      — one engine replica behind a JSON-lines TCP front;
- ``bench``       — the Poisson-load serving bench;
- ``router``      — only the ``Serving.router`` block's schema so far.
"""
