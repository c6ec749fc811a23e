"""Data layer: the paper's text preprocessing, the two tokenizers, the
synthetic Zipf corpus, and the training half of the reference's
``repro.data`` — packed next-token batches read through the Splitter's
byte ranges (``PackedLMDataset``) and their host-side ``Prefetcher``."""

from .pipeline import (PackedLMDataset, Prefetcher, make_store_with_corpus,
                       synth_corpus)
from .tokenizer import HashTokenizer, build_vocab

__all__ = ["HashTokenizer", "PackedLMDataset", "Prefetcher", "build_vocab",
           "make_store_with_corpus", "synth_corpus"]
