from .optim import adam_steplr, step_lr
from .trainer import (TrainConfig, Task, make_loss_fn, make_train_step,
                      make_eval_step, fit, evaluate, FitResult, param_leaves,
                      trainable)
from .tasks import GKNTask, GCNTask, MGKNGeneralTask, MGKNOrthogonalTask
from .checkpoint import save_checkpoint, restore_checkpoint, latest_step
from .metrics import MetricsLogger, profile_trace
from .export import save_bundle, load_bundle, load_meta

__all__ = [
    "adam_steplr", "step_lr", "TrainConfig", "Task", "make_loss_fn",
    "make_train_step", "make_eval_step", "fit", "evaluate", "FitResult",
    "param_leaves", "trainable", "GKNTask", "GCNTask", "MGKNGeneralTask",
    "MGKNOrthogonalTask", "save_checkpoint",
    "restore_checkpoint", "latest_step", "MetricsLogger", "profile_trace",
    "save_bundle", "load_bundle", "load_meta",
]
