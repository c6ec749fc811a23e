"""falcon-mamba-7b [ssm] — Falcon Mamba (arXiv:2410.05355), mamba1 arch.

64 Mamba-1 layers (attention-free), d_model 4096 (d_inner 8192,
ssm_state 16, conv kernel 4), vocab 65024, RMSNorm, tied embeddings.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=1,            # attention-free; unused
    n_kv_heads=1,
    d_ff=0,
    vocab=65_024,
    layer_kind="mamba1",
    ssm_state=16,
    d_inner=8192,
    conv_kernel=4,
    tie_embeddings=True,
    notes="Attention-free: the paper's shuffle applies to data/gradient "
          "plane only (DESIGN.md §5 — technique orthogonal to the mixer). "
          "long_500k RUNS: O(1) state.",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        n_layers=4, d_model=64, vocab=512, ssm_state=8, d_inner=128,
        param_dtype="float32", compute_dtype="float32", remat=False)
