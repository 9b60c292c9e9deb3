"""llama-3.2-vision-90b — dense decoder with cross-attention image layers.

[hf:meta-llama/Llama-3.2-11B-Vision; unverified] 100L d_model=8192 64H
(GQA kv=8) d_ff=28672 vocab=128256.  Every 5th layer cross-attends to
precomputed vision patch embeddings, (batch, 1600, d_model); the vision
encoder is a stub, as in the reference.
"""
from .base import ArchConfig, register

FULL = ArchConfig(
    name="llama-3.2-vision-90b", family="vlm",
    num_layers=100, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=28672, vocab_size=128_256, head_dim=128,
    cross_attn_every=5, cross_attn_offset=4, num_image_tokens=1600,
    rope_theta=500_000.0, tie_embeddings=False,
)

SMOKE = ArchConfig(
    name="llama-3.2-vision-90b-smoke", family="vlm",
    num_layers=5, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=128, vocab_size=256, head_dim=16,
    cross_attn_every=5, cross_attn_offset=4, num_image_tokens=8,
    tie_embeddings=False,
)

register(FULL, SMOKE)
