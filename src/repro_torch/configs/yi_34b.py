"""yi-34b [dense] — Yi (arXiv:2403.04652), llama-arch GQA.

60L, d_model 7168, 56 heads (GQA kv=8, head_dim 128), d_ff 20480,
vocab 64000, rope_theta 5e6.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="yi-34b",
    family="dense",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    vocab=64_000,
    rope_theta=5_000_000.0,
    activation="silu",
    notes="long_500k SKIPPED: pure full attention (DESIGN.md §5).",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        n_layers=3, d_model=56, n_heads=7, n_kv_heads=1, head_dim=8,
        d_ff=144, vocab=512,
        param_dtype="float32", compute_dtype="float32", remat=False)
