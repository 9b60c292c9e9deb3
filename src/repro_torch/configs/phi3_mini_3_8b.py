"""phi3-mini-3.8b — dense decoder, RoPE + SwiGLU, MHA (kv=heads).

[arXiv:2404.14219; unverified] 32L d_model=3072 32H (GQA kv=32) d_ff=8192
vocab=32064, head_dim 96, global attention on every layer.
"""
from .base import ArchConfig, register

FULL = ArchConfig(
    name="phi3-mini-3.8b", family="dense",
    num_layers=32, d_model=3072, num_heads=32, num_kv_heads=32,
    d_ff=8192, vocab_size=32064, head_dim=96,
    tie_embeddings=False,
)

SMOKE = ArchConfig(
    name="phi3-mini-3.8b-smoke", family="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=128, vocab_size=256, head_dim=16,
    tie_embeddings=False,
)

register(FULL, SMOKE)
