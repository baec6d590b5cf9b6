"""The training loop on the engine's device: AdamW with fp32 master weights
(``adamw``), seeded synthetic token batches and their prefetch (``data``),
and the pure train step (``step``)."""
from .adamw import AdamWConfig, apply_adamw, init_opt_state, schedule
from .step import TrainState, make_train_step, init_train_state
from .data import SyntheticLM, shard_batch

__all__ = ["AdamWConfig", "apply_adamw", "init_opt_state", "schedule",
           "TrainState", "make_train_step", "init_train_state",
           "SyntheticLM", "shard_batch"]
