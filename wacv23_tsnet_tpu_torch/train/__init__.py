"""GAN training of the face model: state, step and schedule."""

from .schedule import lr_poly
from .state import GEN_SUBNETS, TrainState, create_train_state
from .step import make_train_step

__all__ = ["lr_poly", "GEN_SUBNETS", "TrainState", "create_train_state",
           "make_train_step"]
