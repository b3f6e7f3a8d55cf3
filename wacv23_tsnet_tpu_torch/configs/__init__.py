from .base import TSNetConfig, face_config, toy_config

__all__ = ["TSNetConfig", "face_config", "toy_config"]
