"""Device-side input double buffering (port of
``fleetx_tpu/data/prefetch.py``).

Without it ``EagerEngine.fit`` runs fetch → host-to-device copy → step in
series, the copy of batch N on the compute stream ahead of step N's
kernels. ``DevicePrefetcher`` moves the copy off that path: a producer
thread pulls host batches and copies them to the card ``depth`` batches
ahead, on its own ``torch.cuda.Stream``, recording an event after each
copy, so the copy of batch N+1 overlaps step N on the card. The consumer
makes the compute stream wait on that event (a device-side wait, no host
sync) and calls ``record_stream`` on every tensor, so the caching
allocator does not hand the batch's memory back to the copy stream while
the compute stream still reads it. The consumer's wait in ``__next__`` is
then pure input starvation (the ``data_fetch`` span the data-stall metric
integrates), while the producer's copy runs under the separate
``shard_batch_async`` span.

The shutdown contract (stop-aware bounded puts, producer exceptions
re-raised consumer-side, ``close()`` joining with a timeout) is
``dataloader.StopAwareQueue``'s, shared with ``DataLoader.__iter__``; the
queue's ``depth`` bounds the pinned batches in flight. On the CPU the
producer runs ``shard_fn`` with no stream and no event.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Iterator, Optional

import torch

from fleetx_tpu_torch.data.dataloader import StopAwareQueue

__all__ = ["DevicePrefetcher"]


class _ProducerError:
    """Marker carrying a producer-side exception to the consumer."""

    __slots__ = ("exc",)

    def __init__(self, exc: BaseException):
        self.exc = exc


def _tensors(tree: Any):
    """Every tensor of a batch (dicts, lists and tuples walked)."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


class DevicePrefetcher:
    """Iterator of device batches, produced ``depth`` ahead.

    ``shard_fn`` (the engine's ``to_device`` on a card) runs on the
    producer thread inside the copy stream's context; ``device`` is the
    engine's device (a CUDA one turns the stream on).
    """

    _SENTINEL = object()

    def __init__(self, host_iter: Iterator, shard_fn: Callable[[Any], Any],
                 depth: int = 2, obs: Optional[Any] = None, device=None):
        self._queue = StopAwareQueue(depth)
        self._done = False
        self._device = torch.device(device) if device is not None else None
        self._stream = None
        if self._device is not None and self._device.type == "cuda":
            self._stream = torch.cuda.Stream(device=self._device)
        self._thread = threading.Thread(
            target=self._produce, args=(host_iter, shard_fn, obs),
            daemon=True, name="fleetx-torch-device-prefetch")
        self._thread.start()

    # ------------------------------------------------------------- producer
    def _copy(self, shard_fn: Callable, item: Any) -> tuple:
        """One batch copied on the copy stream, with its event."""
        if self._stream is None:
            return shard_fn(item), None
        with torch.cuda.stream(self._stream):
            moved = shard_fn(item)
            event = torch.cuda.Event()
            event.record(self._stream)
        return moved, event

    def _produce(self, host_iter: Iterator, shard_fn: Callable,
                 obs: Optional[Any]) -> None:
        try:
            if self._stream is not None:
                # the current device is per thread
                torch.cuda.set_device(self._device)
            for item in host_iter:
                # the span name differs from the engine's "shard_batch":
                # this copy overlaps the card's compute, so it must not feed
                # the data-stall integral (Observability.stall_seconds_total)
                if obs is not None and getattr(obs, "enabled", False):
                    with obs.timed_span("shard_batch_async"):
                        moved = self._copy(shard_fn, item)
                else:
                    moved = self._copy(shard_fn, item)
                if not self._queue.put(moved):
                    return  # consumer closed the prefetcher
        except BaseException as e:  # noqa: BLE001 — re-raised consumer-side
            self._queue.put(_ProducerError(e))
            return
        self._queue.put(self._SENTINEL)

    # ------------------------------------------------------------- consumer
    def __iter__(self) -> "DevicePrefetcher":
        return self

    def __next__(self) -> Any:
        if self._done:
            raise StopIteration
        item = self._queue.get()
        if item is self._SENTINEL:
            self._done = True
            raise StopIteration
        if isinstance(item, _ProducerError):
            self._done = True
            raise item.exc
        moved, event = item
        if event is not None:
            compute = torch.cuda.current_stream(self._device)
            compute.wait_event(event)
            for t in _tensors(moved):
                t.record_stream(compute)
        return moved

    def close(self) -> bool:
        """Release the producer thread (idempotent; safe mid-iteration).

        Returns True when the producer actually exited. False means the
        join timed out (``shard_fn`` or the host iterator is hung) and the
        host iterator is STILL EXECUTING on the producer thread: callers
        must not close() that generator nor assume exclusive access to its
        sampler.
        """
        self._queue.stop()
        self._queue.drain()  # unblock a producer waiting in put()
        self._thread.join(timeout=5.0)
        return not self._thread.is_alive()
