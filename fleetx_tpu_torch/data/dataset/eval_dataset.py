"""Offline evaluation datasets: WikiText perplexity and LAMBADA accuracy
(a copy of ``fleetx_tpu/data/dataset/eval_dataset.py:23-120``).

- ``LMEvalDataset``: overlapping evaluation windows over one token stream:
  window ``i`` re-feeds ``seq_len`` tokens of context but counts loss only
  on its last ``overlapping_eval`` new targets (the first window counts
  all), so the windows tile every target exactly once;
- ``LambadaEvalDataset``: each sample is (context, target last word);
  accuracy requires every target token to be the argmax prediction.

Both take token ids; ``lm_eval_from_text`` and ``lambada_from_jsonl``
tokenize a text file or a ``{"text": ...}`` jsonl with the port's BPE
tokenizer.
"""

from __future__ import annotations

import json

import numpy as np


class LMEvalDataset:
    """Sliding-window perplexity dataset (reference ``gpt_dataset.py:462-560``)."""

    def __init__(self, tokens, seq_length: int, *, overlapping_eval: int = 32,
                 pad_id: int = 0):
        self.tokens = np.asarray(tokens, np.int64)
        self.seq_length = int(seq_length)
        self.overlap = int(overlapping_eval) or self.seq_length
        self.pad_id = int(pad_id)
        n_tokens = len(self.tokens) - 1  # targets are shifted by one
        if n_tokens <= self.seq_length:
            self.num_samples = 1
        else:
            self.num_samples = 1 + int(
                np.ceil((n_tokens - self.seq_length) / self.overlap))

    def __len__(self) -> int:
        return self.num_samples

    def __getitem__(self, i: int) -> dict:
        S = self.seq_length
        n_targets = len(self.tokens) - 1
        # window i ends at target `end`; only its `new` trailing targets are
        # counted, so the windows tile all targets exactly once
        # (reference l.539-556)
        if i == 0:
            end = min(S, n_targets)
            new_tokens = end
        else:
            end = min(S + i * self.overlap, n_targets)
            new_tokens = end - (S + (i - 1) * self.overlap)
        start = max(end - S, 0)
        chunk = self.tokens[start:end + 1]
        tokens = np.full(S, self.pad_id, np.int32)
        labels = np.full(S, self.pad_id, np.int32)
        mask = np.zeros(S, np.float32)
        n = len(chunk) - 1
        tokens[:n] = chunk[:-1]
        labels[:n] = chunk[1:]
        mask[max(n - new_tokens, 0):n] = 1.0
        return {"tokens": tokens, "position_ids": np.arange(S, dtype=np.int32),
                "labels": labels, "loss_mask": mask}


class LambadaEvalDataset:
    """Last-word cloze accuracy dataset (reference ``gpt_dataset.py:562-627``)."""

    def __init__(self, pairs: list[tuple[list[int], list[int]]],
                 seq_length: int, *, pad_id: int = 0):
        self.pairs = pairs
        self.seq_length = int(seq_length)
        self.pad_id = int(pad_id)

    def __len__(self) -> int:
        return len(self.pairs)

    def __getitem__(self, i: int) -> dict:
        S = self.seq_length
        ctx, target = self.pairs[i]
        full = (list(ctx) + list(target))[-(S + 1):]
        tokens = np.full(S, self.pad_id, np.int32)
        labels = np.full(S, self.pad_id, np.int32)
        mask = np.zeros(S, np.float32)
        n = len(full) - 1
        tokens[:n] = full[:-1]
        labels[:n] = full[1:]
        mask[n - len(target):n] = 1.0  # judge only the target word's tokens
        return {"tokens": tokens, "position_ids": np.arange(S, dtype=np.int32),
                "labels": labels, "loss_mask": mask}


# ----------------------------------------------------------------- loaders


def lm_eval_from_text(path: str, tokenizer, seq_length: int,
                      overlapping_eval: int = 32) -> LMEvalDataset:
    """WikiText-style raw text file → PPL dataset (reference wikitext
    detokenization is upstream preprocessing; we evaluate the file as-is)."""
    with open(path, encoding="utf-8") as f:
        text = f.read()
    return LMEvalDataset(np.asarray(tokenizer.encode(text)), seq_length,
                         overlapping_eval=overlapping_eval,
                         pad_id=tokenizer.eos_token_id)


def lambada_from_jsonl(path: str, tokenizer, seq_length: int) -> LambadaEvalDataset:
    """LAMBADA jsonl ({"text": ...} lines): split off the last word as the
    cloze target (reference ``gpt_dataset.py:575-590``)."""
    pairs = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            text = json.loads(line)["text"]
            ctx, last = text.rsplit(" ", 1)
            pairs.append((tokenizer.encode(ctx), tokenizer.encode(" " + last)))
    return LambadaEvalDataset(pairs, seq_length, pad_id=tokenizer.eos_token_id)
