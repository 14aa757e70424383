"""Port parity: the GPT-2 byte-level BPE tokenizer
(``fleetx_tpu_torch/data/tokenizers/gpt_tokenizer.py``) against the JAX
package's (``fleetx_tpu/data/tokenizers/gpt_tokenizer.py``).

Tolerance: none, everything is exact. The same ids from ``encode``, the
same text from ``decode``, the same pre-tokeniser pieces, the same vocab
and merges from ``train_bpe`` and byte-identical ``save_pretrained``
files. The port's pre-tokeniser is a hand-written scanner over
``unicodedata`` in place of the ``regex`` package; its character classes
are held to ``regex``'s over every code point Python's Unicode database
assigns.
"""

import os
import random
import unicodedata

import pytest
import torch
import regex

from fleetx_tpu.data.tokenizers import gpt_tokenizer as J
from fleetx_tpu_torch.data.tokenizers import gpt_tokenizer as T

pytestmark = pytest.mark.torch_port


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """This file's tensors are tiny: torch runs them on one intra-op
    thread (its default pool, on cores the other test workers share,
    costs far more than the work). The count is restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TEXTS = {
    "ascii": "The quick brown fox jumps over the lazy dog. 1234, 56!",
    "contractions": "I'm sure they'll say it's fine; we've heard you'd "
                    "won't. 'S and 'RE stay apart.",
    "unicode": "Ünïcödé — 中文字符 with emoji 😀 and résumé ²³ Ⅻ ٣٤",
    "whitespace": "  two  spaces\n\nnewlines\t\ttabs   \r\n trailing   ",
    "eos": "first document<|endoftext|>second document <|endoftext|>",
    "punctuation": "a--b...c?!(d)[e]{f} @g #h $i %j ^k &l *m _n +o =p",
    "separators": "x\x1cy\x1d z\x1e\x1f w\x85v u t　s",
}


@pytest.fixture(scope="module")
def corpus():
    with open(os.path.join(REPO, "README.md"), encoding="utf-8") as f:
        readme = f.read()
    return [readme] + list(TEXTS.values())


@pytest.fixture(scope="module")
def pair(corpus):
    """The same trained vocabulary in both tokenizers."""
    return J.train_bpe(corpus, 600), T.train_bpe(corpus, 600)


@pytest.mark.parametrize("name", sorted(TEXTS))
def test_pretokenize_equals_the_regex(name):
    text = TEXTS[name]
    assert T.pretokenize(text) == J.PRETOKENIZE_PAT.findall(text)


def test_pretokenize_equals_the_regex_on_random_strings():
    alphabet = (list("ab Z9'\n\t\r .,!?-_") + ["'s", "'re", "'ll", "'S",
                                                "'d", "'m", "'ve", "'t"]
                + list("é中٣² \x1c\x1f\x85😀́Ⅻ　"))
    rng = random.Random(0)
    for _ in range(3000):
        s = "".join(rng.choice(alphabet) for _ in range(rng.randint(0, 24)))
        assert T.pretokenize(s) == J.PRETOKENIZE_PAT.findall(s), repr(s)


def test_character_classes_equal_regex_on_assigned_code_points():
    """``\\p{L}``, ``\\p{N}`` and ``\\s`` against the port's predicates
    over the Basic Multilingual Plane; code points Python's database
    leaves unassigned (``Cn``) may be assigned in ``regex``'s newer one."""
    letter, number = regex.compile(r"\p{L}"), regex.compile(r"\p{N}")
    space = regex.compile(r"\s")
    for cp in range(0x10000):
        c = chr(cp)
        if unicodedata.category(c) == "Cn":
            continue
        assert T._is_letter(c) == bool(letter.match(c)), hex(cp)
        assert T._is_number(c) == bool(number.match(c)), hex(cp)
        assert T._is_space(c) == bool(space.match(c)), hex(cp)


def test_bytes_to_unicode_matches():
    assert T.bytes_to_unicode() == J.bytes_to_unicode()


@pytest.mark.parametrize("name", sorted(TEXTS))
def test_encode_decode_match_the_reference(pair, name):
    jt, tt = pair
    text = TEXTS[name]
    ids = tt.encode(text)
    assert ids == jt.encode(text)
    assert tt(text) == ids
    assert tt.decode(ids) == jt.decode(ids)
    assert tt.decode(ids + [10 ** 6]) == jt.decode(ids + [10 ** 6])
    if "<|endoftext|>" not in text:
        assert tt.decode(ids) == text


def test_train_bpe_matches_the_reference(pair):
    jt, tt = pair
    assert tt.encoder == jt.encoder
    assert tt.bpe_ranks == jt.bpe_ranks
    assert tt.vocab_size == jt.vocab_size == 600
    assert tt.eos_token_id == jt.eos_token_id == 599


def test_fast_trainer_equals_its_naive_twin(corpus):
    fast, naive = T.train_bpe(corpus[1:], 320), \
        T._train_bpe_naive(corpus[1:], 320)
    assert fast.encoder == naive.encoder
    assert fast.bpe_ranks == naive.bpe_ranks


def test_save_pretrained_files_are_byte_identical(pair, tmp_path):
    jt, tt = pair
    jt.save_pretrained(str(tmp_path / "jax"))
    tt.save_pretrained(str(tmp_path / "port"))
    for name in ("vocab.json", "merges.txt"):
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes()
    loaded = T.GPTTokenizer.from_pretrained(str(tmp_path / "jax"))
    assert loaded.encoder == tt.encoder
    assert loaded.bpe_ranks == tt.bpe_ranks
    text = TEXTS["unicode"] + TEXTS["ascii"]
    assert loaded.encode(text) == \
        J.GPTTokenizer.from_pretrained(str(tmp_path / "port")).encode(text)
