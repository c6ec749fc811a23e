"""qwen2-moe-a2.7b [moe] — Qwen1.5-MoE-A2.7B (hf:Qwen/Qwen1.5-MoE-A2.7B).

24L, d_model 2048, 16 heads (MHA, kv=16), vocab 151936.  MoE every layer:
60 routed experts top-4 (expert d_ff 1408) + 4 shared-expert slices
(shared intermediate 5632 = 4×1408) behind a sigmoid gate.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,                   # routed expert intermediate
    vocab=151_936,
    rope_theta=1_000_000.0,
    n_experts=60,
    top_k=4,
    expert_d_ff=1408,
    n_shared_experts=4,
    shared_expert_d_ff=1408,     # ×4 shared slices = 5632
    capacity_factor=1.25,
    activation="silu",
    notes="MoE dispatch = the paper's shuffle: route(token)→expert replaces "
          "hash(key)→reducer (DESIGN.md §5). long_500k SKIPPED (full attn).",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=96, vocab=512,
        n_experts=8, top_k=2, expert_d_ff=96, n_shared_experts=1,
        shared_expert_d_ff=96,
        param_dtype="float32", compute_dtype="float32", remat=False)
