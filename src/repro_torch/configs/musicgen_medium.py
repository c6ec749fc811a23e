"""musicgen-medium [audio] — MusicGen (arXiv:2306.05284), decoder-only over
EnCodec tokens.

48L, d_model 1536, 24 heads (MHA kv=24), d_ff 6144, vocab 2048 (EnCodec
codebook).  As in the reference, the EnCodec frontend (and the codebook
delay pattern) is a stub: the backbone consumes precomputed frame
embeddings (B, S, d_model), or a single token stream through its embed
table in ``decode_step``.  Text-conditioning cross-attention is not
modelled.  GELU + LayerNorm with biases.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    d_ff=6144,
    vocab=2048,
    norm="layernorm",
    norm_eps=1e-5,
    activation="gelu",
    notes="EnCodec frontend + delay pattern stubbed per spec. "
          "long_500k SKIPPED: pure full attention (DESIGN.md §5).",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=256,
        param_dtype="float32", compute_dtype="float32", remat=False)
