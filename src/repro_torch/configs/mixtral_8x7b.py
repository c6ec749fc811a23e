"""mixtral-8x7b [moe] — Mixtral of Experts (arXiv:2401.04088).

32L, d_model 4096, 32 heads (GQA kv=8, head_dim 128), vocab 32000.
8 experts top-2 (expert d_ff 14336), sliding-window attention (4096) on
every layer, rope_theta 1e6.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab=32_000,
    rope_theta=1_000_000.0,
    sliding_window=4096,
    window_pattern="all",
    n_experts=8,
    top_k=2,
    expert_d_ff=14336,
    capacity_factor=1.25,
    activation="silu",
    notes="long_500k RUNS: SWA on all layers bounds the KV window "
          "(rolling cache) — sub-quadratic serving (DESIGN.md §5).",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=512, sliding_window=16,
        n_experts=4, top_k=2, expert_d_ff=128,
        param_dtype="float32", compute_dtype="float32", remat=False)
