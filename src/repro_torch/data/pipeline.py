"""The batch word count's corpus: the synthetic Zipf text that stands
in for the paper's preprocessed Wikipedia dump — byte for byte the
reference's ``synth_corpus`` (numpy's seeded Zipf draw), so both packages
count the same text.
"""

from __future__ import annotations

import numpy as np

__all__ = ["synth_corpus"]


def synth_corpus(n_words: int, vocab_words: int = 1000, seed: int = 0,
                 zipf: float = 1.3) -> str:
    """Zipf-distributed synthetic corpus (stands in for the paper's
    preprocessed Wikipedia dump — same locality statistics shape)."""
    rng = np.random.default_rng(seed)
    ranks = rng.zipf(zipf, size=n_words)
    ranks = np.clip(ranks, 1, vocab_words)
    return " ".join(f"w{r}" for r in ranks)

