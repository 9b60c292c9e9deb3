"""Sharding: the gradient codec (``sharding/rules.py`` of the reference,
its logical-axis rules, is not ported yet)."""
from .compression import ErrorFeedback, dequantize, quantize, wire_bytes

__all__ = ["ErrorFeedback", "dequantize", "quantize", "wire_bytes"]
