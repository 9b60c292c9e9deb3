"""mixtral-8x22b — 8-expert top-2 MoE with sliding-window attention.

[arXiv:2401.04088; hf] 56L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=32768, MoE 8e top-2 (capacity factor 1.25), sliding window 4096 on
every layer, head_dim 128, rope theta 1e6, untied embeddings.
"""
from .base import ArchConfig, register

FULL = ArchConfig(
    name="mixtral-8x22b", family="moe",
    num_layers=56, d_model=6144, num_heads=48, num_kv_heads=8,
    d_ff=16384, vocab_size=32768, head_dim=128,
    num_experts=8, experts_per_token=2,
    sliding_window=4096, subquadratic=True,
    rope_theta=1_000_000.0, tie_embeddings=False,
)

SMOKE = ArchConfig(
    name="mixtral-8x22b-smoke", family="moe",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=128, vocab_size=256, head_dim=16,
    num_experts=4, experts_per_token=2,
    sliding_window=16, subquadratic=True,
    tie_embeddings=False,
)

register(FULL, SMOKE)
