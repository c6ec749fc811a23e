"""Tokenization for the data pipeline.

The paper's workload is word counting over preprocessed Wikipedia text
(§IV-B: lowercase, punctuation stripped, whitespace collapsed).  We keep the
same preprocessing, and two tokenizers:

  * ``HashTokenizer`` — stateless word→id via the same FNV-1a the shuffle
    uses; no vocabulary pass needed (ids are hash buckets).  This feeds the
    device word-count job and LM toy training.
  * ``build_vocab`` — an exact vocabulary built *by a MapReduce job* (word
    count → top-K), which is the paper's own pipeline eating its own output.
"""

from __future__ import annotations

import re
import string

_PUNCT = str.maketrans("", "", string.punctuation)
_WS = re.compile(r"\s+")


def preprocess(text: str) -> str:
    """The paper's locality preprocessing (§IV-B)."""
    return _WS.sub(" ", text.lower().translate(_PUNCT)).strip()


def fnv1a(word: str) -> int:
    h = 0xCBF29CE484222325
    for b in word.encode():
        h = ((h ^ b) * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


class HashTokenizer:
    """word → hash bucket in [0, vocab).  Deterministic, collision-accepting
    (documented: counts are per-bucket when collisions occur)."""

    def __init__(self, vocab: int) -> None:
        self.vocab = vocab

    def encode_words(self, words: list[str]) -> list[int]:
        return [fnv1a(w) % self.vocab for w in words]

    def encode(self, text: str) -> list[int]:
        return self.encode_words(preprocess(text).split())


def build_vocab(counts: dict[str, int], max_size: int) -> dict[str, int]:
    """Exact vocab from word counts (a MapReduce output): most frequent
    first, ties broken lexicographically; id 0 reserved for <unk>."""
    ordered = sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))
    vocab = {"<unk>": 0}
    for w, _ in ordered[: max_size - 1]:
        vocab[w] = len(vocab)
    return vocab
