from .base import TrainConfig, TSNetConfig, face_config, toy_config

__all__ = ["TrainConfig", "TSNetConfig", "face_config", "toy_config"]
