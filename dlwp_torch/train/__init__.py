"""Training loop, optax-equal optimizers, callbacks and checkpoints (port of
``dlwp_tpu.train``)."""

from dlwp_torch.train.callbacks import (
    BatchHistory,
    JsonlRun,
    LearningRateTracker,
    RunHistory,
)
from dlwp_torch.train.checkpoint import restore_checkpoint, save_checkpoint
from dlwp_torch.train.optim import (
    OPTIMIZERS,
    add_decayed_weights,
    chain,
    clip_by_global_norm,
    cosine_decay_schedule,
)
from dlwp_torch.train.trainer import (
    EarlyStoppingMin,
    History,
    TrainConfig,
    Trainer,
    resolve_loss,
    resolve_optimizer,
)

__all__ = [
    "BatchHistory",
    "EarlyStoppingMin",
    "History",
    "JsonlRun",
    "LearningRateTracker",
    "OPTIMIZERS",
    "RunHistory",
    "TrainConfig",
    "Trainer",
    "add_decayed_weights",
    "chain",
    "clip_by_global_norm",
    "cosine_decay_schedule",
    "resolve_loss",
    "resolve_optimizer",
    "restore_checkpoint",
    "save_checkpoint",
]
