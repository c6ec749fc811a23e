"""gemma2-9b [dense] — Gemma 2 (arXiv:2408.00118).

42L, d_model 3584, 16 heads (GQA kv=8, head_dim 256), d_ff 14336,
vocab 256000.  Local(4096)+global alternating attention, attn logit
softcap 50, final logit softcap 30, GeGLU, sandwich (post-block) norms,
Gemma-style (1+w) RMSNorm and sqrt(d) embedding scaling, tied embeddings.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b",
    family="dense",
    n_layers=42,
    d_model=3584,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=14336,
    vocab=256_000,
    rope_theta=10_000.0,
    attn_softcap=50.0,
    final_softcap=30.0,
    sliding_window=4096,
    window_pattern="alternate",
    post_block_norm=True,
    activation="gelu",
    norm_offset=1.0,
    embed_scale=True,
    tie_embeddings=True,
    notes="long_500k RUNS: half the layers are SWA-4096; decode is O(window)"
          " there and O(ctx) on the global layers (DESIGN.md §5).",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=512, sliding_window=16,
        param_dtype="float32", compute_dtype="float32", remat=False)
