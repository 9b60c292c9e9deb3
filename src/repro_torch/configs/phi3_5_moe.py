"""phi3.5-moe-42b-a6.6b — 16-expert top-2 MoE.

[hf:microsoft/Phi-3.5-MoE-instruct; hf] 32L d_model=4096 32H (GQA kv=8)
d_ff=6400 vocab=32064, MoE 16e top-2 (capacity factor 1.25), head_dim
128, global attention on every layer.
"""
from .base import ArchConfig, register

FULL = ArchConfig(
    name="phi3.5-moe-42b-a6.6b", family="moe",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=6400, vocab_size=32064, head_dim=128,
    num_experts=16, experts_per_token=2,
    tie_embeddings=False,
)

SMOKE = ArchConfig(
    name="phi3.5-moe-42b-a6.6b-smoke", family="moe",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=96, vocab_size=256, head_dim=16,
    num_experts=4, experts_per_token=2,
    tie_embeddings=False,
)

register(FULL, SMOKE)
