"""The optimizer substrate: the partner of ``repro/optim`` — AdamW with
float32 moments, gradient clipping and schedules, and int8 gradient
compression over a worker axis — on torch tensors in the port's
parameter trees (``optim.tree``)."""

from .adamw import AdamW, OptState, TrainState, apply_updates, global_norm
from .compression import (compress_int8, compressed_psum, decompress_int8,
                          ef_compress_update)
from .schedule import cosine_schedule, linear_warmup

__all__ = ["AdamW", "OptState", "TrainState", "apply_updates",
           "compress_int8", "decompress_int8", "compressed_psum",
           "cosine_schedule", "ef_compress_update", "global_norm",
           "linear_warmup"]
