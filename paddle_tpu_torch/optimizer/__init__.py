"""Optimizers of the port (the training slice's part of
`paddle_tpu/optimizer/`): the `Optimizer` base, `Adam` / `AdamW`, and
the LR schedulers in `lr`."""

from . import lr
from .optimizer import Optimizer
from .optimizers import Adam, AdamW

__all__ = ["Optimizer", "Adam", "AdamW", "lr"]
