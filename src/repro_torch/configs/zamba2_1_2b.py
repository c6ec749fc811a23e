"""zamba2-1.2b [hybrid] — Zamba2 (arXiv:2411.15242).

38 Mamba2 blocks, d_model 2048 (d_inner 4096, ssm_state 64, 64 SSD heads of
dim 64), plus a *shared* full-attention transformer block (32 heads MHA,
d_ff 8192) invoked every 6 layers with the same parameters — the Zamba
weight-sharing trick.  vocab 32000.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,                 # shared attention block MLP
    vocab=32_000,
    layer_kind="mamba2",
    ssm_state=64,
    d_inner=4096,
    mamba_head_dim=64,
    conv_kernel=4,
    shared_attn_every=6,
    activation="gelu",
    notes="long_500k RUNS: O(1) SSM state; shared attn blocks carry their own"
          " KV caches per invocation (DESIGN.md §5).",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        n_layers=6, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab=512, ssm_state=8, d_inner=128, mamba_head_dim=32,
        shared_attn_every=3,
        param_dtype="float32", compute_dtype="float32", remat=False)
