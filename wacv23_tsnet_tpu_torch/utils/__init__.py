from .meters import AverageMeter, Logger, StepTimer

__all__ = ["AverageMeter", "Logger", "StepTimer"]
