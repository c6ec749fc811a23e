"""The training plane: the train step as a MapReduce round and the
fault-tolerant Trainer (the partner of ``repro/runtime``)."""

from .train_step import (init_train_state, make_eval_step,
                         make_shardmap_train_step, make_train_step)
from .trainer import PreemptionError, Trainer, TrainerConfig

__all__ = ["init_train_state", "make_eval_step", "make_shardmap_train_step",
           "make_train_step", "PreemptionError", "Trainer", "TrainerConfig"]
