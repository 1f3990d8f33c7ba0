"""Optimizers of the port — `paddle_tpu/optimizer/`: the `Optimizer`
base, the twelve optimizers, and the LR schedulers in `lr`."""

from . import lr
from .optimizer import Optimizer
from .optimizers import (LBFGS, SGD, Adadelta, Adagrad, Adam, Adamax, AdamW,
                         Lamb, Lookahead, ModelAverage, Momentum, RMSProp)

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Adagrad",
           "Adadelta", "Adamax", "RMSProp", "Lamb", "Lookahead",
           "ModelAverage", "LBFGS", "lr"]
