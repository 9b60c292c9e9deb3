"""Architecture configs: one module per ported architecture."""
from .base import ArchConfig, get_config

__all__ = ["ArchConfig", "get_config"]
