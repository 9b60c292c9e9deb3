"""jamba-1.5-large-398b — Mamba+attention 1:7 hybrid with 16-expert MoE.

[arXiv:2403.19887; hf] 72L d_model=8192 64H (GQA kv=8) d_ff=24576
vocab=65536, MoE 16e top-2.  One attention layer per 8 (1:7 interleave),
MoE every other layer; the SSM at H 128 heads of P 128, state N 128.
"""
from .base import ArchConfig, register

FULL = ArchConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    num_layers=72, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=24576, vocab_size=65536, head_dim=128,
    num_experts=16, experts_per_token=2, moe_every=2, moe_offset=1,
    attn_every=8, attn_offset=4,
    ssm_state=128, ssm_headdim=128, ssm_expand=2,
    tie_embeddings=False, subquadratic=True,
)

SMOKE = ArchConfig(
    name="jamba-1.5-large-398b-smoke", family="hybrid",
    num_layers=8, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=128, vocab_size=256, head_dim=16,
    num_experts=4, experts_per_token=2, moe_every=2, moe_offset=1,
    attn_every=8, attn_offset=4,
    ssm_state=16, ssm_headdim=16, ssm_expand=2, ssm_chunk=8,
    tie_embeddings=False, subquadratic=True,
)

register(FULL, SMOKE)
