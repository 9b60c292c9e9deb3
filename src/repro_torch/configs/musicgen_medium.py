"""musicgen-medium — decoder-only transformer over EnCodec tokens.

[arXiv:2306.05284; hf] 48L d_model=1536 24H (kv=24, i.e. MHA) d_ff=6144
vocab=2048.  The EnCodec tokenizer/delay-pattern front end is a stub, as in the
reference: the model takes precomputed frame token ids over the 2048-entry
codebook.  head_dim 64, global attention on every layer.
"""
from .base import ArchConfig, register

FULL = ArchConfig(
    name="musicgen-medium", family="audio",
    num_layers=48, d_model=1536, num_heads=24, num_kv_heads=24,
    d_ff=6144, vocab_size=2048, head_dim=64,
    tie_embeddings=False,
)

SMOKE = ArchConfig(
    name="musicgen-medium-smoke", family="audio",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=128, vocab_size=128, head_dim=16,
    tie_embeddings=False,
)

register(FULL, SMOKE)
