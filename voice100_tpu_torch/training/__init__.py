"""Training of the port: task adapters, trainer and checkpoints (ASR v2
and the TTS v2 pair), and the WORLD statistics loader."""

from .checkpoint import (TrainState, load_model_weights, merge_world_stats, restore_checkpoint,
                         save_checkpoint)
from .tasks import Task, make_task
from .trainer import Trainer, TrainerConfig

__all__ = ["Task", "make_task", "Trainer", "TrainerConfig", "TrainState",
           "save_checkpoint", "restore_checkpoint", "load_model_weights", "merge_world_stats"]
