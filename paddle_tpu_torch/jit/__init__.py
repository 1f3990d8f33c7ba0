"""The training step of the port (`jit.trainer.TrainStep`) and the
deployment path (`jit.api`: `InputSpec`, `save`, `load`,
`TranslatedLayer`, `not_to_static`)."""

from .api import InputSpec, TranslatedLayer, load, not_to_static, save
from .trainer import TrainStep

__all__ = ["TrainStep", "InputSpec", "save", "load", "TranslatedLayer",
           "not_to_static"]
