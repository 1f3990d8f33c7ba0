"""The training step of the port (`jit.trainer.TrainStep`)."""

from .trainer import TrainStep

__all__ = ["TrainStep"]
