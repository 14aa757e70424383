"""GPT-2 byte-level BPE tokenizer (port of
``fleetx_tpu/data/tokenizers/gpt_tokenizer.py``: ``bytes_to_unicode``,
``GPTTokenizer`` with ``encode`` / ``decode`` / ``from_files`` /
``from_pretrained`` / ``save_pretrained``, and ``train_bpe`` with its
naive twin, :174-323). Pure Python.

Two differences from the JAX package's module, neither in what it
computes:

- the GPT-2 pre-tokeniser ``'s|'t|'re|'ve|'m|'ll|'d| ?\\p{L}+| ?\\p{N}+|
  ?[^\\s\\p{L}\\p{N}]+|\\s+(?!\\S)|\\s+`` is a hand-written scanner
  (``pretokenize``) over ``unicodedata`` categories instead of the
  third-party ``regex`` package, which the card's machine does not have.
  It gives the same pieces: ``\\p{L}`` / ``\\p{N}`` are the categories
  ``L*`` / ``N*``, and ``\\s`` is ``str.isspace`` without U+001C-U+001F,
  which ``regex`` does not count as space. Code points that Python's
  Unicode database (15.0 in Python 3.12) leaves unassigned but a newer
  ``regex`` database assigns are classed as "other" here;
- ``from_files`` reads local paths only (the JAX package also fetches
  URLs through its download cache; the port has no network).
"""

from __future__ import annotations

import heapq
import json
import os
import unicodedata
from functools import lru_cache

#: apostrophe contractions the pre-tokeniser splits off first, in order
_CONTRACTIONS = ("s", "t", "re", "ve", "m", "ll", "d")
#: characters ``str.isspace`` counts that the ``regex`` package's ``\s``
#: does not
_NOT_SPACE = frozenset("\x1c\x1d\x1e\x1f")


def _is_space(c: str) -> bool:
    return c.isspace() and c not in _NOT_SPACE


def _is_letter(c: str) -> bool:
    return unicodedata.category(c)[0] == "L"


def _is_number(c: str) -> bool:
    return unicodedata.category(c)[0] == "N"


def _is_other(c: str) -> bool:
    return not (_is_space(c) or _is_letter(c) or _is_number(c))


def pretokenize(text: str) -> list:
    """The GPT-2 pre-tokeniser's ``findall`` over ``text``: at each
    position the first alternative that matches, in the pattern's order."""
    out = []
    i, n = 0, len(text)
    while i < n:
        c = text[i]
        if c == "'":
            suffix = next((s for s in _CONTRACTIONS
                           if text.startswith(s, i + 1)), None)
            if suffix is not None:
                out.append(text[i:i + 1 + len(suffix)])
                i += 1 + len(suffix)
                continue
        end = None
        for kind in (_is_letter, _is_number, _is_other):
            # ` ?<class>+`: a leading U+0020 joins a run that follows it
            start = i + 1 if c == " " and i + 1 < n and kind(text[i + 1]) \
                else i
            if kind(text[start]):
                end = start + 1
                while end < n and kind(text[end]):
                    end += 1
                break
        if end is None:  # whitespace
            end = i + 1
            while end < n and _is_space(text[end]):
                end += 1
            # `\s+(?!\S)` gives back the run's last character to a
            # following non-space; `\s+` takes a lone one
            if end < n and end - i >= 2:
                end -= 1
        out.append(text[i:end])
        i = end
    return out


@lru_cache()
def bytes_to_unicode() -> dict:
    """Reversible byte → printable-unicode map."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(2 ** 8):
        if b not in bs:
            bs.append(b)
            cs.append(2 ** 8 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def get_pairs(word: tuple) -> set:
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


class GPTTokenizer:
    """Byte-level BPE with a ranked merge table. ``vocab``: token string →
    id; ``merges``: the ordered merge pairs."""

    def __init__(self, vocab: dict, merges: list,
                 eos_token: str = "<|endoftext|>"):
        self.encoder = dict(vocab)
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.bpe_ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self.cache: dict = {}
        self.eos_token = eos_token
        if eos_token not in self.encoder:
            self.encoder[eos_token] = len(self.encoder)
            self.decoder[self.encoder[eos_token]] = eos_token
        self.eos_token_id = self.encoder[eos_token]
        # eod == eos for GPT pretraining
        self.eod_token_id = self.eos_token_id

    # ----------------------------------------------------- construction
    @classmethod
    def from_files(cls, vocab_file: str, merges_file: str) -> "GPTTokenizer":
        """Load GPT-2 ``vocab.json`` + ``merges.txt`` from local paths."""
        with open(vocab_file, encoding="utf-8") as f:
            vocab = json.load(f)
        merges = []
        with open(merges_file, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#version"):
                    continue
                a, b = line.split()
                merges.append((a, b))
        return cls(vocab, merges)

    @classmethod
    def from_pretrained(cls, path: str) -> "GPTTokenizer":
        return cls.from_files(os.path.join(path, "vocab.json"),
                              os.path.join(path, "merges.txt"))

    def save_pretrained(self, path: str) -> None:
        """Write ``vocab.json`` + ``merges.txt`` under ``path``."""
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "vocab.json"), "w",
                  encoding="utf-8") as f:
            json.dump(self.encoder, f, ensure_ascii=False)
        merges = sorted(self.bpe_ranks.items(), key=lambda kv: kv[1])
        with open(os.path.join(path, "merges.txt"), "w",
                  encoding="utf-8") as f:
            f.write("#version: 0.2\n")
            for (a, b), _ in merges:
                f.write(f"{a} {b}\n")

    @property
    def vocab_size(self) -> int:
        return len(self.encoder)

    # ------------------------------------------------------------- core
    def bpe(self, token: str) -> str:
        """Greedy merge loop over one pre-token (GPT-2 BPE)."""
        if token in self.cache:
            return self.cache[token]
        word = tuple(token)
        pairs = get_pairs(word)
        if not pairs:
            return token
        while True:
            bigram = min(pairs,
                         key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: list = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = get_pairs(word)
        out = " ".join(word)
        # a memo: BPE is deterministic per token, a lost race costs one
        # recompute
        self.cache[token] = out
        return out

    def encode(self, text: str) -> list:
        """Text → token ids."""
        ids: list = []
        for tok in pretokenize(text):
            mapped = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self.bpe(mapped).split(" "))
        return ids

    def decode(self, ids) -> str:
        """Token ids → text. Ids past the vocabulary (model vocabularies
        are padded past the tokenizer's) decode to nothing; tokens outside
        the byte alphabet (``<|endoftext|>``) are dropped by the byte
        decode, as in the JAX package."""
        text = "".join(self.decoder.get(int(i), "") for i in ids)
        data = bytearray(self.byte_decoder[c] for c in text
                         if c in self.byte_decoder)
        return data.decode("utf-8", errors="replace")

    def __call__(self, text: str) -> list:
        return self.encode(text)


def _count_words(texts) -> dict:
    """Pre-tokenise and byte-map ``texts`` into word → count (shared by
    both trainers, which must stay bit-identical)."""
    byte_encoder = bytes_to_unicode()
    word_counts: dict = {}
    for text in texts:
        for tok in pretokenize(text):
            mapped = tuple(byte_encoder[b] for b in tok.encode("utf-8"))
            if mapped:
                word_counts[mapped] = word_counts.get(mapped, 0) + 1
    return word_counts


def _apply_merge(word: tuple, best: tuple, merged: str) -> tuple:
    """``word`` with every non-overlapping, left-to-right occurrence of
    the pair ``best`` fused into ``merged``."""
    out: list = []
    i = 0
    while i < len(word):
        if i < len(word) - 1 and (word[i], word[i + 1]) == best:
            out.append(merged)
            i += 2
        else:
            out.append(word[i])
            i += 1
    return tuple(out)


def _train_bpe_naive(texts, vocab_size: int,
                     eos_token: str = "<|endoftext|>") -> GPTTokenizer:
    """Naive BPE trainer: a full pair recount per merge. The executable
    specification ``train_bpe`` must reproduce bit for bit."""
    alphabet = sorted(bytes_to_unicode().values())
    vocab = {ch: i for i, ch in enumerate(alphabet)}
    merges: list = []

    words = _count_words(texts)
    while len(vocab) < vocab_size - 1:  # -1 reserves the eos slot
        pair_counts: dict = {}
        for word, cnt in words.items():
            for p in zip(word, word[1:]):
                pair_counts[p] = pair_counts.get(p, 0) + cnt
        if not pair_counts:
            break
        best = max(pair_counts.items(), key=lambda kv: (kv[1], kv[0]))[0]
        merges.append(best)
        merged = best[0] + best[1]
        vocab[merged] = len(vocab)
        new_words: dict = {}
        for word, cnt in words.items():
            out = _apply_merge(word, best, merged)
            new_words[out] = new_words.get(out, 0) + cnt
        words = new_words

    return GPTTokenizer(vocab, merges, eos_token=eos_token)


def _inv_str(s: str) -> tuple:
    """Order-inverting key for strings: ``a < b`` iff
    ``_inv_str(a) > _inv_str(b)`` (negated code points, with a ``+1``
    sentinel so a proper prefix maps to a larger key)."""
    return tuple(-ord(c) for c in s) + (1,)


def train_bpe(texts, vocab_size: int,
              eos_token: str = "<|endoftext|>") -> GPTTokenizer:
    """Learn a byte-level BPE vocab + merges from an iterable of texts.

    The selection order of ``_train_bpe_naive`` (most frequent pair
    first, ties to the lexicographically largest pair) with incremental
    pair counting: each merge touches only the words holding the merged
    pair, and the arg-max is a lazy max-heap.
    """
    alphabet = sorted(bytes_to_unicode().values())
    vocab = {ch: i for i, ch in enumerate(alphabet)}
    merges: list = []

    words = _count_words(texts)
    pair_counts: dict = {}
    # pair -> the words currently holding it
    where: dict = {}
    for word, cnt in words.items():
        for p in zip(word, word[1:]):
            pair_counts[p] = pair_counts.get(p, 0) + cnt
            where.setdefault(p, set()).add(word)

    # lazy max-heap over (count, pair); stale entries are checked against
    # pair_counts when popped
    heap = [(-c, _inv_str(p[0]), _inv_str(p[1]), p)
            for p, c in pair_counts.items()]
    heapq.heapify(heap)

    def push(p: tuple) -> None:
        heapq.heappush(heap, (-pair_counts[p], _inv_str(p[0]),
                              _inv_str(p[1]), p))

    while len(vocab) < vocab_size - 1:  # -1 reserves the eos slot
        best = None
        while heap:
            neg_c, _, _, p = heapq.heappop(heap)
            if neg_c < 0 and pair_counts.get(p, 0) == -neg_c:
                best = p
                break
        if best is None:
            break
        merges.append(best)
        merged = best[0] + best[1]
        vocab[merged] = len(vocab)

        changed: list = []
        for word in list(where.get(best, ())):
            cnt = words.pop(word, 0)
            if cnt == 0:
                continue
            changed.append((word, _apply_merge(word, best, merged), cnt))

        touched: set = set()
        for old, new, cnt in changed:
            for p in zip(old, old[1:]):
                pair_counts[p] -= cnt
                occ = where.get(p)
                if occ is not None:
                    occ.discard(old)
                touched.add(p)
        for _, new, cnt in changed:
            words[new] = words.get(new, 0) + cnt
        # keyed by the final words, so two old words collapsing into one
        # new word index it once
        for _, new, cnt in changed:
            for p in zip(new, new[1:]):
                pair_counts[p] = pair_counts.get(p, 0) + cnt
                where.setdefault(p, set()).add(new)
                touched.add(p)
        for p in touched:
            if pair_counts.get(p, 0) <= 0:
                pair_counts.pop(p, None)
                where.pop(p, None)
            else:
                push(p)

    return GPTTokenizer(vocab, merges, eos_token=eos_token)
