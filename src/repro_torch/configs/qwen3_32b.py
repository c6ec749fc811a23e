"""qwen3-32b [dense] — Qwen3 (family config per hf:Qwen/Qwen3-8B).

64L, d_model 5120, 64 heads (GQA kv=8, head_dim 128), d_ff 25600,
vocab 151936.  Per-head-dim RMS qk-norm, RMSNorm, SwiGLU, rope_theta 1e6.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=25600,
    vocab=151_936,
    rope_theta=1_000_000.0,
    qk_norm=True,
    activation="silu",
    notes="long_500k SKIPPED: pure full attention (DESIGN.md §5).",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        n_layers=4, d_model=64, n_heads=8, n_kv_heads=2, head_dim=8,
        d_ff=192, vocab=512,
        param_dtype="float32", compute_dtype="float32", remat=False)
