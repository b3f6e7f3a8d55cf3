from .streaming import RetargetSession

__all__ = ["RetargetSession"]
