"""Data: token datasets as federation objects (numpy only)."""
from .dataset import DatasetSpec, SyntheticTokens, decode_tokens

__all__ = ["DatasetSpec", "SyntheticTokens", "decode_tokens"]
