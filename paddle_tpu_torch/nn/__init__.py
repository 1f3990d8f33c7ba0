"""Layers and gradient utilities of the port (`nn.clip`, `nn.moe`)."""

from .clip import ClipGradByGlobalNorm
from .moe import GShardGate, MoELayer, NaiveGate, SwitchGate

__all__ = ["ClipGradByGlobalNorm", "MoELayer", "NaiveGate", "GShardGate",
           "SwitchGate"]
