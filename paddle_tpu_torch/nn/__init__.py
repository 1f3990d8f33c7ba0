"""Layers and gradient utilities of the port (`nn.clip`)."""

from .clip import ClipGradByGlobalNorm

__all__ = ["ClipGradByGlobalNorm"]
