"""Distributed batch sampler with exact mid-epoch resume (a copy of
``fleetx_tpu/data/sampler/batch_sampler.py``).

Global batches are laid out over the data-parallel ranks and
``consumed_samples`` lets a restarted run continue from the exact sample
a checkpoint stopped at: a sampler built or rewound (``EagerEngine.fit``
after a restore) to a checkpoint's ``consumed_samples`` yields next the
batch the uninterrupted run would have taken. A prefetching loader moves
the sampler's own count ahead of training, so the engine keeps the
trained count it saves.
"""

from __future__ import annotations

import numpy as np


class DistributedBatchSampler:
    """Rank-sliced random batch sampler."""

    def __init__(self, dataset_len: int, batch_size: int, *,
                 num_replicas: int = 1, rank: int = 0, shuffle: bool = False,
                 drop_last: bool = True, seed: int = 1234):
        if not 0 <= rank < num_replicas:
            raise ValueError(f"rank {rank} outside [0, {num_replicas})")
        self.dataset_len = int(dataset_len)
        self.batch_size = int(batch_size)
        self.num_replicas = int(num_replicas)
        self.rank = int(rank)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = int(epoch)

    def _indices(self) -> np.ndarray:
        idx = np.arange(self.dataset_len, dtype=np.int64)
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(idx)
        return idx

    def __iter__(self):
        idx = self._indices()
        global_bs = self.batch_size * self.num_replicas
        n_batches = (len(idx) // global_bs if self.drop_last
                     else -(-len(idx) // global_bs))
        for b in range(n_batches):
            chunk = idx[b * global_bs:(b + 1) * global_bs]
            mine = chunk[self.rank * self.batch_size:
                         (self.rank + 1) * self.batch_size]
            if len(mine) == self.batch_size or not self.drop_last:
                yield mine.tolist()

    def __len__(self) -> int:
        global_bs = self.batch_size * self.num_replicas
        return (self.dataset_len // global_bs if self.drop_last
                else -(-self.dataset_len // global_bs))


class GPTBatchSampler(DistributedBatchSampler):
    """Sequential sampler with ``consumed_samples`` resume."""

    def __init__(self, dataset_len: int, batch_size: int, *,
                 num_replicas: int = 1, rank: int = 0,
                 consumed_samples: int = 0, drop_last: bool = True,
                 seed: int = 1234):
        super().__init__(dataset_len, batch_size, num_replicas=num_replicas,
                         rank=rank, shuffle=False, drop_last=drop_last,
                         seed=seed)
        self.consumed_samples = int(consumed_samples)

    def __iter__(self):
        global_bs = self.batch_size * self.num_replicas
        start = self.consumed_samples
        while start + global_bs <= self.dataset_len:
            chunk = np.arange(start, start + global_bs, dtype=np.int64)
            yield chunk[self.rank * self.batch_size:
                        (self.rank + 1) * self.batch_size].tolist()
            start += global_bs
            self.consumed_samples = start

    def __len__(self) -> int:
        global_bs = self.batch_size * self.num_replicas
        return max(0, (self.dataset_len - self.consumed_samples) // global_bs)
