"""The LM stack's models: the partner of ``repro/models`` for the dense
attention family, with the same public names."""

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
