"""GAN training of the face model: state, step, schedule, checkpoints."""

from .checkpoint import (find_latest_checkpoint, restore_checkpoint,
                         restore_generator_params, save_checkpoint,
                         save_generator_params)
from .schedule import lr_poly
from .state import GEN_SUBNETS, TrainState, create_train_state
from .step import make_train_step

__all__ = ["find_latest_checkpoint", "lr_poly", "GEN_SUBNETS", "TrainState",
           "create_train_state", "make_train_step", "restore_checkpoint",
           "restore_generator_params", "save_checkpoint",
           "save_generator_params"]
