"""Meters, the run logger, the LR schedule and checkpoints of the port."""

from .logger import CompleteLogger, TextLogger
from .meter import AverageMeter, AverageMeterList, ProgressMeter
from .schedules import multistep_lr

__all__ = ["AverageMeter", "AverageMeterList", "CompleteLogger", "ProgressMeter",
           "TextLogger", "multistep_lr"]
