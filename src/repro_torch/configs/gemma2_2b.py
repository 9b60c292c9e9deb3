"""gemma2-2b — local/global alternating attention with logit softcaps.

[arXiv:2408.00118; hf] 26L d_model=2304 8H (GQA kv=4) d_ff=9216
vocab=256000.  Alternating sliding-window(4096)/global layers, attention
logit softcap 50, final logit softcap 30, tied embeddings, head_dim 256.
"""
from .base import ArchConfig, register

FULL = ArchConfig(
    name="gemma2-2b", family="dense",
    num_layers=26, d_model=2304, num_heads=8, num_kv_heads=4,
    d_ff=9216, vocab_size=256_000, head_dim=256,
    sliding_window=4096, local_global_period=2,
    attn_logit_softcap=50.0, final_logit_softcap=30.0,
    tie_embeddings=True, subquadratic=True,
    padded_heads=16,   # 16 q-heads, 8 of them zero pad heads
)

SMOKE = ArchConfig(
    name="gemma2-2b-smoke", family="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=128, vocab_size=512, head_dim=16,
    sliding_window=16, local_global_period=2,
    attn_logit_softcap=50.0, final_logit_softcap=30.0,
    tie_embeddings=True, subquadratic=True,
)

register(FULL, SMOKE)
