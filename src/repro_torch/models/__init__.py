"""Decoder LMs: the dense (attention), MoE, SSM, hybrid (SSM and
attention) and VLM (cross-attention) families, with decode caches."""
from .convert import (jax_layout, param_checksums, params_from_jax,
                      state_from_jax)
from .model import (decode_step, forward, forward_with_cache,
                    init_decode_cache, init_lm, lm_loss)

__all__ = ["decode_step", "forward", "forward_with_cache",
           "init_decode_cache", "init_lm", "jax_layout", "lm_loss",
           "param_checksums", "params_from_jax", "state_from_jax"]
