"""Layers of the port with the JAX package's parameter names:
`Linear`, `Embedding`, `Dropout` (`common`), `LayerNorm` (`norm`),
`Conv2D` (`conv`)."""

from .common import Dropout, Embedding, Linear
from .conv import Conv2D
from .norm import LayerNorm

__all__ = ["Linear", "Embedding", "Dropout", "LayerNorm", "Conv2D"]
