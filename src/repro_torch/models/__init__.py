"""Decoder LMs of the dense family, with KV decode caches."""
from .convert import params_from_jax
from .model import (decode_step, forward, forward_with_cache,
                    init_decode_cache, init_lm)

__all__ = ["decode_step", "forward", "forward_with_cache",
           "init_decode_cache", "init_lm", "params_from_jax"]
