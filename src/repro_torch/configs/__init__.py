"""Architecture configs: one module per ported architecture."""
from .base import ArchConfig, DepthCut, depth_cut, get_config

__all__ = ["ArchConfig", "DepthCut", "depth_cut", "get_config"]
