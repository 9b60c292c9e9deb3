"""Serving: batched prefill/decode engine."""
from .engine import EngineStats, Request, ServeEngine

__all__ = ["EngineStats", "Request", "ServeEngine"]
