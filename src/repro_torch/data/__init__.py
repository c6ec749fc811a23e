"""Data layer: the paper's text preprocessing, the two tokenizers and the
synthetic Zipf corpus the batch word count and its benchmarks read.

The training half of the reference's ``repro.data`` (``PackedLMDataset``
and its ``Prefetcher``) arrives with the training slice (ROADMAP Queue A
#13f).
"""

from .pipeline import synth_corpus
from .tokenizer import HashTokenizer, build_vocab

__all__ = ["HashTokenizer", "build_vocab", "synth_corpus"]
