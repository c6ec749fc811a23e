"""The LM stack's models: the partner of ``repro/models`` for the
attention family — dense (gemma2-9b, qwen3-32b, stablelm-12b, yi-34b)
and mixture-of-experts (qwen2-moe-a2.7b, mixtral-8x7b) —, the Mamba-1
family (falcon-mamba-7b) and the hybrid zamba2-1.2b (Mamba-2 layers and
a shared attention block), with the same public names."""

from .config import (ALL_SHAPES, DECODE_32K, LONG_500K, PREFILL_32K,
                     SHAPES_BY_NAME, TRAIN_4K, ModelConfig, ShapeConfig,
                     shapes_for)
from .transformer import (decode_step, forward, init_cache, init_params,
                          loss_fn, prefill, prefill_forward)

__all__ = [
    "ALL_SHAPES", "DECODE_32K", "LONG_500K", "PREFILL_32K", "SHAPES_BY_NAME",
    "TRAIN_4K", "ModelConfig", "ShapeConfig", "shapes_for", "decode_step",
    "forward", "init_cache", "init_params", "loss_fn", "prefill",
    "prefill_forward",
]
