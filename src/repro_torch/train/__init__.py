"""Training: the federation-backed checkpointer (the rest of the
reference's ``train`` package is not ported yet)."""
from .checkpoint import FederatedCheckpointer

__all__ = ["FederatedCheckpointer"]
