"""qwen2-7b — dense decoder with GQA and QKV bias.

[arXiv:2407.10671; hf] 28L d_model=3584 28H (GQA kv=4) d_ff=18944
vocab=152064.  Pure full attention → long_500k skipped.
"""
from .base import ArchConfig, register

FULL = ArchConfig(
    name="qwen2-7b", family="dense",
    num_layers=28, d_model=3584, num_heads=28, num_kv_heads=4,
    d_ff=18944, vocab_size=152_064, head_dim=128,
    qkv_bias=True, rope_theta=1_000_000.0, tie_embeddings=False,
    padded_heads=32,   # 32 q-heads, 4 of them zero pad heads
)

SMOKE = ArchConfig(
    name="qwen2-7b-smoke", family="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=160, vocab_size=256, head_dim=16,
    qkv_bias=True, tie_embeddings=False,
)

register(FULL, SMOKE)
