"""Megatron-style memmap pretraining dataset (a copy of
``fleetx_tpu/data/dataset/gpt_dataset.py:36-320``).

- ``GPTDataset`` over ``{prefix}_ids.npy`` (one flat token stream) and
  ``{prefix}_idx.npz`` (per-document lengths), with the doc/sample/shuffle
  index triple built deterministically from (num_samples, seq_length,
  seed) and cached next to the data; the sample index comes from the
  native C++ builder (``data/native``), as in
  ``fleetx_tpu/data/dataset/gpt_dataset.py:154-160``, and from the
  byte-identical numpy builder, with a logged warning, where it cannot
  build.
- ``BlendedDataset``: a weighted mixture of datasets, its sample order
  from the native ``build_blending_indices`` (the numpy builder where it
  cannot build, as JAX's :272-279).
- ``SyntheticGPTDataset``: deterministic random tokens, no data files.
- ``write_corpus``: documents of token ids → the ``_ids.npy`` /
  ``_idx.npz`` pair ``GPTDataset`` reads.

Samples are ``{tokens, position_ids, labels, loss_mask}`` numpy arrays,
labels shifted by one, loss masked at eos.
"""

from __future__ import annotations

import hashlib
import os
import subprocess

import numpy as np

from fleetx_tpu_torch.utils.log import logger


# --------------------------------------------------------------------------
# index construction (reference gpt_dataset.py:253-373 / C++ helper)
# --------------------------------------------------------------------------


def build_doc_idx(documents: np.ndarray, num_epochs: int,
                  rng: np.random.RandomState,
                  separate_last_epoch: bool) -> np.ndarray:
    """Epoch-replicated shuffled document order (reference ``_build_doc_idx``)."""
    if not separate_last_epoch or num_epochs == 1:
        doc_idx = np.tile(documents, num_epochs)
        rng.shuffle(doc_idx)
        return doc_idx.astype(np.int32)
    head = build_doc_idx(documents, num_epochs - 1, rng, False)
    tail = build_doc_idx(documents, 1, rng, False)
    return np.concatenate([head, tail]).astype(np.int32)


def build_sample_idx(sizes: np.ndarray, doc_idx: np.ndarray, seq_length: int,
                     num_samples: int) -> np.ndarray:
    """[num_samples+1, 2] (doc_idx position, token offset) per sample start.

    Vectorised equivalent of the reference C++ ``build_sample_idx``
    (``fast_index_map_helpers.cpp:92-190``): sample ``i`` starts at stream
    position ``i * seq_length`` of the doc_idx-ordered token stream (each
    sample consumes seq_length tokens; one extra token overlaps for labels).
    """
    lens = sizes[doc_idx].astype(np.int64)
    cum = np.cumsum(lens)
    total_tokens = int(cum[-1])
    max_samples = (total_tokens - 1) // seq_length
    num_samples = min(num_samples, max_samples)
    starts = np.arange(num_samples + 1, dtype=np.int64) * seq_length
    pos = np.searchsorted(cum, starts, side="right")
    prev_cum = np.where(pos > 0, cum[pos - 1], 0)
    offsets = starts - prev_cum
    out = np.empty((num_samples + 1, 2), np.int64)
    out[:, 0] = pos
    out[:, 1] = offsets
    return out


def build_shuffle_idx(num_samples: int, total_size: int,
                      rng: np.random.RandomState) -> np.ndarray:
    """Shuffle within [0, num_samples) and [num_samples, total) separately
    (reference ``_build_shuffle_idx``: keeps the last partial epoch's samples
    after the full epochs)."""
    dtype = np.int64 if total_size >= np.iinfo(np.int32).max - 1 else np.int32
    head = np.arange(num_samples, dtype=dtype)
    rng.shuffle(head)
    if total_size <= num_samples:
        return head
    tail = np.arange(num_samples, total_size, dtype=dtype)
    rng.shuffle(tail)
    return np.concatenate([head, tail])


def _num_epochs(tokens_per_epoch: int, seq_length: int, num_samples: int) -> int:
    epochs = 0
    total = 0
    while True:
        epochs += 1
        total += tokens_per_epoch
        if (total - 1) // seq_length >= num_samples:
            return epochs


def build_index_mappings(name: str, cache_dir: str, sizes: np.ndarray,
                         documents: np.ndarray, num_samples: int,
                         seq_length: int, seed: int):
    """Build (or load cached) doc/sample/shuffle index triple, cached as
    ``{name}_{hash}_{doc,sample,shuffle}_idx.npy`` next to the data."""
    key = hashlib.md5(
        f"{name}-{len(documents)}-{num_samples}-{seq_length}-{seed}".encode()
    ).hexdigest()[:10]
    os.makedirs(cache_dir, exist_ok=True)
    paths = {
        kind: os.path.join(cache_dir, f"{name}_{key}_{kind}_idx.npy")
        for kind in ("doc", "sample", "shuffle")
    }
    if all(os.path.exists(p) for p in paths.values()):
        return tuple(np.load(paths[k], mmap_mode="r")
                     for k in ("doc", "sample", "shuffle"))

    rng = np.random.RandomState(seed)
    tokens_per_epoch = int(sizes[documents].sum())
    num_epochs = _num_epochs(tokens_per_epoch, seq_length, num_samples)
    # separate_last_epoch logic (reference gpt_dataset.py:284-302): don't let
    # the final partial epoch leak shuffled into the full epochs
    if num_epochs == 1:
        separate_last_epoch = False
    else:
        samples_wo_last = ((num_epochs - 1) * tokens_per_epoch - 1) // seq_length
        last_epoch_samples = num_samples - samples_wo_last
        samples_per_epoch = (tokens_per_epoch - 1) // seq_length
        separate_last_epoch = last_epoch_samples < int(0.8 * samples_per_epoch)

    doc_idx = build_doc_idx(documents, num_epochs, rng, separate_last_epoch)

    try:
        from fleetx_tpu_torch.data.native import index_builder

        sample_idx = index_builder.build_sample_idx(
            sizes.astype(np.int32), doc_idx, seq_length, num_samples)
    except (OSError, RuntimeError, subprocess.SubprocessError) as e:
        # no compiler or a failed build: the numpy path is byte-identical
        logger.warning("native index builder unavailable (%s: %s); "
                       "using numpy fallback", type(e).__name__, e)
        sample_idx = build_sample_idx(sizes, doc_idx, seq_length,
                                      num_samples)

    if separate_last_epoch:
        num_samples_ = samples_wo_last
    else:
        num_samples_ = sample_idx.shape[0] - 1
    shuffle_idx = build_shuffle_idx(num_samples_, sample_idx.shape[0] - 1, rng)

    # atomic publish: write to a tmp name, then rename — concurrent same-host
    # processes and the multi-host pollers above never see partial files
    for kind, arr in (("doc", doc_idx), ("sample", sample_idx),
                      ("shuffle", shuffle_idx)):
        tmp = paths[kind][:-len(".npy")] + f".tmp{os.getpid()}.npy"
        np.save(tmp, arr, allow_pickle=False)
        os.replace(tmp, paths[kind])
    logger.info("built index mappings for %s: %d samples, %d epochs",
                name, sample_idx.shape[0] - 1, num_epochs)
    return doc_idx, sample_idx, shuffle_idx


# --------------------------------------------------------------------------
# dataset
# --------------------------------------------------------------------------


class GPTDataset:
    """Pretraining dataset over a memmapped token stream.

    ``data_prefix`` names ``{prefix}_ids.npy`` (flat token array) and
    ``{prefix}_idx.npz`` with key ``lens`` (per-doc lengths). Returns dict
    batches matching the model contract.
    """

    def __init__(self, data_prefix: str, *, name: str = "train",
                 num_samples: int, seq_length: int = 1024, seed: int = 1234,
                 eos_id: int = 50256, documents: np.ndarray | None = None,
                 cache_dir: str | None = None):
        self.tokens = np.load(data_prefix + "_ids.npy", mmap_mode="r")
        idx = np.load(data_prefix + "_idx.npz")
        self.doc_lens = idx["lens"].astype(np.int64)
        self.doc_starts = np.concatenate([[0], np.cumsum(self.doc_lens)])
        self.seq_length = int(seq_length)
        self.eos_id = int(eos_id)
        if documents is None:
            documents = np.arange(len(self.doc_lens), dtype=np.int32)
        cache_dir = cache_dir or os.path.dirname(os.path.abspath(data_prefix))
        self.doc_idx, self.sample_idx, self.shuffle_idx = build_index_mappings(
            name, cache_dir, self.doc_lens, documents, num_samples,
            self.seq_length, seed)

    def __len__(self) -> int:
        return self.shuffle_idx.shape[0]

    def _gather(self, idx: int) -> np.ndarray:
        """seq_length+1 contiguous stream tokens, stitched across docs
        (reference ``_construct_sample``/``__getitem__`` l.134-185)."""
        pos_f, off_f = self.sample_idx[idx]
        pos_l, off_l = self.sample_idx[idx + 1]
        parts = []
        need = self.seq_length + 1
        pos, off = int(pos_f), int(off_f)
        while need > 0:
            doc = int(self.doc_idx[pos])
            start = self.doc_starts[doc] + off
            take = min(need, int(self.doc_lens[doc]) - off)
            parts.append(self.tokens[start:start + take])
            need -= take
            pos += 1
            off = 0
        return np.concatenate(parts).astype(np.int64)

    def __getitem__(self, i: int) -> dict:
        sample = self._gather(int(self.shuffle_idx[i]))
        tokens = sample[:-1].astype(np.int32)
        labels = sample[1:].astype(np.int32)
        loss_mask = np.ones(self.seq_length, np.float32)
        loss_mask[tokens == self.eos_id] = 0.0  # reference gpt_dataset.py:145
        position_ids = np.arange(self.seq_length, dtype=np.int32)
        return {"tokens": tokens, "position_ids": position_ids,
                "labels": labels, "loss_mask": loss_mask}


def build_blending_indices(weights: np.ndarray,
                           num_samples: int) -> tuple:
    """Greedy weighted assignment of samples to datasets: sample ``i``
    goes to the dataset furthest behind its share ``weights * (i + 1)``
    (ties to the lower index); ``(dataset index [n] int32, sample index
    within it [n] int64)``."""
    weights = np.asarray(weights, np.float64)
    counts = np.zeros(len(weights), np.int64)
    ds_idx = np.empty(num_samples, np.int32)
    ds_sample_idx = np.empty(num_samples, np.int64)
    for i in range(num_samples):
        errs = weights * (i + 1) - counts
        best = int(np.argmax(errs))
        ds_idx[i] = best
        ds_sample_idx[i] = counts[best]
        counts[best] += 1
    return ds_idx, ds_sample_idx


class BlendedDataset:
    """Weighted mixture of map-style datasets; ``weights`` are normalised,
    and sample ``i`` of the blend is sample ``dataset_sample_index[i] %
    len`` of ``datasets[dataset_index[i]]``."""

    def __init__(self, datasets: list, weights: list, num_samples: int):
        if not datasets or len(datasets) != len(weights):
            raise ValueError(f"BlendedDataset: {len(datasets)} datasets and "
                             f"{len(weights)} weights")
        w = np.asarray(weights, np.float64)
        w = w / w.sum()
        self.datasets = datasets
        try:
            from fleetx_tpu_torch.data.native import index_builder

            self.dataset_index, self.dataset_sample_index = \
                index_builder.build_blending_indices(w, int(num_samples))
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            logger.warning("native blending builder unavailable (%s); "
                           "using numpy fallback", e)
            self.dataset_index, self.dataset_sample_index = \
                build_blending_indices(w, int(num_samples))

    def __len__(self) -> int:
        return len(self.dataset_index)

    def __getitem__(self, i: int) -> dict:
        ds = self.datasets[int(self.dataset_index[i])]
        return ds[int(self.dataset_sample_index[i]) % len(ds)]


class SyntheticGPTDataset:
    """Deterministic random-token dataset for smoke runs and benchmarking —
    lets ``tools/train.py`` run with zero data files (the reference demands a
    downloaded 300M-token demo set before anything runs)."""

    def __init__(self, *, num_samples: int, seq_length: int = 1024,
                 vocab_size: int = 50304, seed: int = 1234, **_unused):
        self.num_samples = int(num_samples)
        self.seq_length = int(seq_length)
        self.vocab_size = int(vocab_size)
        self.seed = int(seed)

    def __len__(self) -> int:
        return self.num_samples

    def __getitem__(self, i: int) -> dict:
        rng = np.random.RandomState(self.seed + int(i))
        sample = rng.randint(0, self.vocab_size, size=self.seq_length + 1)
        return {
            "tokens": sample[:-1].astype(np.int32),
            "position_ids": np.arange(self.seq_length, dtype=np.int32),
            "labels": sample[1:].astype(np.int32),
            "loss_mask": np.ones(self.seq_length, np.float32),
        }


def write_corpus(prefix: str, docs: list, dtype=np.uint16) -> None:
    """Write documents of token ids as ``{prefix}_ids.npy`` (the flat
    stream in ``dtype``) and ``{prefix}_idx.npz`` (``lens``, int64)."""
    flat = np.concatenate([np.asarray(d, dtype=dtype) for d in docs])
    np.save(prefix + "_ids.npy", flat, allow_pickle=False)
    np.savez(prefix + "_idx.npz",
             lens=np.array([len(d) for d in docs], np.int64))
