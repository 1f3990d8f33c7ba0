"""Layers of the port with the JAX package's parameter names:
`Linear`, `Embedding`, `Dropout` (`common`), `LayerNorm` (`norm`)."""

from .common import Dropout, Embedding, Linear
from .norm import LayerNorm

__all__ = ["Linear", "Embedding", "Dropout", "LayerNorm"]
