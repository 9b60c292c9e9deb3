"""Data: token datasets as federation objects and the federated loader
(numpy only)."""
from .dataset import DatasetSpec, SyntheticTokens, decode_tokens
from .loader import FederatedDataLoader, LoaderStats

__all__ = ["DatasetSpec", "SyntheticTokens", "decode_tokens",
           "FederatedDataLoader", "LoaderStats"]
