"""internvl2-2b [vlm] — InternVL2 (arXiv:2404.16821): InternViT-300M vision
frontend + InternLM2-1.8B language backbone.

Only the transformer backbone is modelled, as in the reference: the vision
frontend is a stub, and callers hand the model precomputed patch embeddings
(B, S, d_model), so ``input_mode='embeddings'``.

Backbone (InternLM2-1.8B): 24L, d_model 2048, 16 heads (GQA kv=8),
d_ff 8192, vocab 92553, rope_theta 1e6.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=8192,
    vocab=92_553,
    rope_theta=1_000_000.0,
    input_mode="embeddings",
    activation="silu",
    notes="Vision frontend stubbed (precomputed patch embeddings), per spec. "
          "long_500k SKIPPED: pure full attention (DESIGN.md §5).",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=512,
        param_dtype="float32", compute_dtype="float32", remat=False)
