"""Layers and gradient utilities of the port (`nn.clip`, `nn.moe`)."""

from .clip import (ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,
                   clip_grad_norm_, clip_grad_value_)
from .moe import GShardGate, MoELayer, NaiveGate, SwitchGate

__all__ = ["ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue",
           "clip_grad_norm_", "clip_grad_value_", "MoELayer", "NaiveGate",
           "GShardGate", "SwitchGate"]
