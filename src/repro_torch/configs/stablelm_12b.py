"""stablelm-12b [dense] — StableLM 2 12B (hf:stabilityai/stablelm-2-12b,
family config per hf:stabilityai/stablelm-2-1_6b).

40L, d_model 5120, 32 heads (GQA kv=8), d_ff 13824, vocab 100352.
Partial rotary (25%), per-head qk-norm, LayerNorm.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=13824,
    vocab=100_352,
    rope_theta=10_000.0,
    rope_pct=0.25,
    qk_norm=True,
    norm="layernorm",
    norm_eps=1e-5,
    activation="silu",
    notes="long_500k SKIPPED: pure full attention (DESIGN.md §5).",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, d_ff=160, vocab=512,
        param_dtype="float32", compute_dtype="float32", remat=False)
