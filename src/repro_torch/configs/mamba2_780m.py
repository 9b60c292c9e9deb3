"""mamba2-780m — attention-free SSM with state-space duality (SSD).

[arXiv:2405.21060; state-spaces/mamba2-780m] 48L d_model=1536, no
attention, d_ff=0, vocab=50280, ssm_state=128, headdim 64, expand 2
(d_inner 3072, 48 SSM heads), chunk 256, conv width 4, tied embeddings.
The block is the reference's: separate z/x/B/C/dt projections and no
conv bias, not the published checkpoint's fused layout.
"""
from .base import ArchConfig, register

FULL = ArchConfig(
    name="mamba2-780m", family="ssm",
    num_layers=48, d_model=1536, num_heads=0, num_kv_heads=0,
    d_ff=0, vocab_size=50280,
    ssm_state=128, ssm_headdim=64, ssm_expand=2,
    tie_embeddings=True, subquadratic=True,
)

SMOKE = ArchConfig(
    name="mamba2-780m-smoke", family="ssm",
    num_layers=2, d_model=64, num_heads=0, num_kv_heads=0,
    d_ff=0, vocab_size=256,
    ssm_state=16, ssm_headdim=16, ssm_expand=2, ssm_chunk=8,
    tie_embeddings=True, subquadratic=True,
)

register(FULL, SMOKE)
