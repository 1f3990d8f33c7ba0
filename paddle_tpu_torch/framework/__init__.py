"""Checkpoint I/O of the port (`framework.io.save` / `load`)."""

from .io import load, save

__all__ = ["save", "load"]
