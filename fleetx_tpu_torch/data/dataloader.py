"""Host-side data loader: sampler → collated numpy batches, assembled on
a prefetch thread (a copy of ``fleetx_tpu/data/dataloader.py``). The
engine moves each batch to the card itself, through pinned memory, or
``data/prefetch.DevicePrefetcher`` does it ahead on a side stream."""

from __future__ import annotations

import queue as queue_mod
import threading
from typing import Callable, Iterable, Optional

import numpy as np

from fleetx_tpu_torch.utils.log import logger


class StopAwareQueue:
    """Bounded producer→consumer hand-off whose blocking ``put`` polls a
    consumer-owned stop flag, so a producer thread never outlives a
    consumer that walked away mid-epoch."""

    _POLL_S = 0.1

    def __init__(self, maxsize: int):
        self._q: queue_mod.Queue = queue_mod.Queue(maxsize=max(int(maxsize), 1))
        self._stop = threading.Event()

    def put(self, item) -> bool:
        """Producer-side put; False once the consumer has stopped."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=self._POLL_S)
                return True
            except queue_mod.Full:
                continue
        return False

    def get(self):
        """Consumer-side blocking get."""
        return self._q.get()

    def stop(self) -> None:
        """Consumer signals abandonment; pending puts unblock promptly."""
        self._stop.set()

    def drain(self) -> None:
        """Discard queued items (lets a producer blocked in put() exit)."""
        try:
            while True:
                self._q.get_nowait()
        except queue_mod.Empty:
            pass


def default_collate(samples: list) -> dict:
    """Stack dict-of-array samples into a batch."""
    first = samples[0]
    if isinstance(first, dict):
        return {k: np.stack([s[k] for s in samples]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(np.stack(col) for col in zip(*samples))
    return np.stack(samples)


class DataLoader:
    """Iterates a batch sampler over a dataset, collating to numpy;
    ``prefetch`` > 0 assembles batches on a background thread."""

    def __init__(self, dataset, batch_sampler: Iterable,
                 collate_fn: Optional[Callable] = None, prefetch: int = 2):
        self.dataset = dataset
        self.batch_sampler = batch_sampler
        self.collate_fn = collate_fn or default_collate
        self.prefetch = int(prefetch)

    def _make(self, indices) -> dict:
        return self.collate_fn([self.dataset[i] for i in indices])

    def __iter__(self):
        if self.prefetch <= 0:
            for indices in self.batch_sampler:
                yield self._make(indices)
            return
        q = StopAwareQueue(self.prefetch)
        sentinel = object()
        error: list = []

        def producer():
            try:
                for indices in self.batch_sampler:
                    if not q.put(self._make(indices)):
                        return  # consumer abandoned the iterator
            except BaseException as e:  # noqa: BLE001 — re-raised below
                error.append(e)
            q.put(sentinel)

        t = threading.Thread(target=producer, daemon=True,
                             name="fleetx-torch-dataloader")
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    if error:
                        raise error[0]
                    break
                yield item
        finally:
            q.stop()
            t.join(timeout=5.0)
            if t.is_alive():
                logger.error("dataloader producer did not exit within its "
                             "join timeout")

    def __len__(self) -> int:
        return len(self.batch_sampler)
