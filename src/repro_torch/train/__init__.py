"""Training on one card (counterpart of ``repro.train``): AdamW with
float32 moments over bf16 parameters, and the trainer with checkpoints,
resume and the straggler watchdog."""
from .optim import AdamWConfig, adamw_update, init_opt_state, schedule
from .trainer import TrainConfig, Trainer

__all__ = ["AdamWConfig", "init_opt_state", "adamw_update", "schedule",
           "Trainer", "TrainConfig"]
