"""ERNIE masked-LM pretraining datasets (a copy of
``fleetx_tpu/data/dataset/ernie_dataset.py:21-145``).

Samples are the batch the ERNIE model reads: ``input_ids``,
``token_type_ids``, ``attention_mask``, ``mlm_labels`` and
``next_sentence_labels``, numpy arrays drawn from one
``np.random.RandomState(seed + i)`` per sample, so the same seed gives
the same samples as the JAX package.

- ``apply_mlm_mask``: BERT masking, 15% of the maskable positions
  labelled (80% of them replaced by ``[MASK]``, 10% by a random token,
  10% kept), ``IGNORE_INDEX`` elsewhere;
- ``ErnieDataset``: sentence pairs over the ``{prefix}_ids.npy`` /
  ``{prefix}_idx.npz`` memmap pair the GPT pipeline writes
  (``tools/preprocess_data.py``): a positive pair is two adjacent spans of
  one document, a negative pairs spans of two different documents;
- ``SyntheticErnieDataset``: random tokens, no data files.
"""

from __future__ import annotations

import numpy as np

#: unmasked-position sentinel in ``mlm_labels``; equal to
#: ``models/ernie/model.IGNORE_INDEX`` (kept here so the loader's threads
#: import no model code)
IGNORE_INDEX = -100


def apply_mlm_mask(tokens: np.ndarray, rng: np.random.RandomState, *,
                   vocab_size: int, mask_id: int, mask_prob: float = 0.15,
                   special_ids: tuple = ()) -> tuple:
    """``(masked_tokens, mlm_labels)``; the labels hold ``IGNORE_INDEX``
    at every position that was not picked."""
    tokens = tokens.copy()
    labels = np.full_like(tokens, IGNORE_INDEX)
    maskable = ~np.isin(tokens, list(special_ids))
    pick = (rng.rand(*tokens.shape) < mask_prob) & maskable
    labels[pick] = tokens[pick]
    roll = rng.rand(*tokens.shape)
    tokens[pick & (roll < 0.8)] = mask_id
    rand_pick = pick & (roll >= 0.8) & (roll < 0.9)
    tokens[rand_pick] = rng.randint(0, vocab_size, rand_pick.sum())
    return tokens, labels


class ErnieDataset:
    """Sentence-pair masked-LM dataset over a memmap token stream."""

    def __init__(self, data_prefix: str, *, num_samples: int,
                 seq_length: int = 512, vocab_size: int = 40000,
                 seed: int = 1234, cls_id: int = 1, sep_id: int = 2,
                 mask_id: int = 3, **_unused):
        self.tokens = np.load(data_prefix + "_ids.npy", mmap_mode="r")
        idx = np.load(data_prefix + "_idx.npz")
        self.doc_lens = idx["lens"].astype(np.int64)
        self.doc_starts = np.concatenate([[0], np.cumsum(self.doc_lens)])
        self.num_samples = int(num_samples)
        self.seq_length = int(seq_length)
        self.vocab_size = int(vocab_size)
        self.seed = int(seed)
        self.cls_id, self.sep_id, self.mask_id = cls_id, sep_id, mask_id

    def __len__(self) -> int:
        return self.num_samples

    def _doc_slice(self, doc: int, off: int, length: int) -> np.ndarray:
        """``length`` tokens of document ``doc`` from ``off``, wrapping
        within the document when it is too short; reads only the positions
        it needs from the memmap."""
        start = int(self.doc_starts[doc])
        dl = max(int(self.doc_lens[doc]), 1)
        if off + length <= dl:
            return np.asarray(self.tokens[start + off: start + off + length],
                              np.int64)
        idx = start + (int(off) + np.arange(length)) % dl
        return np.asarray(self.tokens[idx], np.int64)

    def __getitem__(self, i: int) -> dict:
        rng = np.random.RandomState(self.seed + int(i))
        s = self.seq_length
        half = (s - 3) // 2
        blen = s - 3 - half
        ndocs = len(self.doc_lens)
        is_next = int(rng.rand() < 0.5)
        doc_a = int(rng.randint(0, ndocs))
        if is_next:
            dl = int(self.doc_lens[doc_a])
            off = int(rng.randint(0, max(dl - (half + blen), 1)))
            a = self._doc_slice(doc_a, off, half)
            b = self._doc_slice(doc_a, off + half, blen)
        else:
            doc_b = int(rng.randint(0, max(ndocs - 1, 1)))
            if ndocs > 1 and doc_b >= doc_a:
                doc_b += 1
            a = self._doc_slice(doc_a,
                                rng.randint(0, max(int(self.doc_lens[doc_a])
                                                   - half, 1)), half)
            b = self._doc_slice(doc_b,
                                rng.randint(0, max(int(self.doc_lens[doc_b])
                                                   - blen, 1)), blen)
        ids = np.concatenate([[self.cls_id], a, [self.sep_id], b,
                              [self.sep_id]]).astype(np.int64)
        token_type = np.concatenate([
            np.zeros(2 + len(a), np.int32), np.ones(len(b) + 1, np.int32)])
        masked, labels = apply_mlm_mask(
            ids, rng, vocab_size=self.vocab_size, mask_id=self.mask_id,
            special_ids=(self.cls_id, self.sep_id))
        return {
            "input_ids": masked.astype(np.int32),
            "token_type_ids": token_type,
            "attention_mask": np.ones(s, np.int32),
            "mlm_labels": labels.astype(np.int32),
            "next_sentence_labels": np.int32(is_next),
        }


class SyntheticErnieDataset:
    """Deterministic random masked-LM samples (no data files)."""

    def __init__(self, *, num_samples: int = 1024, seq_length: int = 512,
                 vocab_size: int = 40000, seed: int = 1234, mask_id: int = 3,
                 **_unused):
        self.num_samples = int(num_samples)
        self.seq_length = int(seq_length)
        self.vocab_size = int(vocab_size)
        self.seed = int(seed)
        self.mask_id = mask_id

    def __len__(self) -> int:
        return self.num_samples

    def __getitem__(self, i: int) -> dict:
        rng = np.random.RandomState(self.seed + int(i))
        s = self.seq_length
        ids = rng.randint(4, self.vocab_size, size=s).astype(np.int64)
        masked, labels = apply_mlm_mask(ids, rng, vocab_size=self.vocab_size,
                                        mask_id=self.mask_id)
        return {
            "input_ids": masked.astype(np.int32),
            "token_type_ids": (np.arange(s) >= s // 2).astype(np.int32),
            "attention_mask": np.ones(s, np.int32),
            "mlm_labels": labels.astype(np.int32),
            "next_sentence_labels": np.int32(rng.rand() < 0.5),
        }
