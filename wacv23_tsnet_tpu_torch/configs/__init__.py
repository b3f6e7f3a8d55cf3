from .base import (TrainConfig, TSNetConfig, face_config, pose_config,
                   toy_config, toy_pose_config)

__all__ = ["TrainConfig", "TSNetConfig", "face_config", "pose_config",
           "toy_config", "toy_pose_config"]
