"""Decoder LMs: the dense (attention) and SSM families, with decode
caches."""
from .convert import param_checksums, params_from_jax
from .model import (decode_step, forward, forward_with_cache,
                    init_decode_cache, init_lm)

__all__ = ["decode_step", "forward", "forward_with_cache",
           "init_decode_cache", "init_lm", "param_checksums",
           "params_from_jax"]
