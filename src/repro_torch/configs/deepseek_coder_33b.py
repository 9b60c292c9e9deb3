"""deepseek-coder-33b — dense llama-architecture decoder.

[arXiv:2401.14196; hf] 62L d_model=7168 56H (GQA kv=8) d_ff=19200
vocab=32256, head_dim 128.  Its 56 q-heads are padded to 64, so GQA
groups 8 q-heads a KV head.
"""
from .base import ArchConfig, register

FULL = ArchConfig(
    name="deepseek-coder-33b", family="dense",
    num_layers=62, d_model=7168, num_heads=56, num_kv_heads=8,
    d_ff=19200, vocab_size=32256, head_dim=128,
    rope_theta=100_000.0, tie_embeddings=False,
    padded_heads=64,   # 64 q-heads, 8 of them zero pads, over 8 KV
)

SMOKE = ArchConfig(
    name="deepseek-coder-33b-smoke", family="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=160, vocab_size=256, head_dim=16,
    tie_embeddings=False,
)

register(FULL, SMOKE)
