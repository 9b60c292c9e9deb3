"""Architecture configuration schema and registry.

The port's own copy of the reference's schema: field for field the same
frozen :class:`ArchConfig`, so that a configuration means the same model
in both packages.  The layer stack is ``num_groups`` repetitions of the
config's block *pattern* of (sequence-mixer, channel-mixer) kinds.
Only the architectures the port runs are registered.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List

# Block kinds: sequence mixer × channel mixer.
MIXER_ATTN = "attn"          # causal self attention (full or windowed)
MIXER_ATTN_LOCAL = "attn_local"   # sliding-window self attention
MIXER_SSM = "ssm"            # Mamba2 SSD
MIXER_XATTN = "xattn"        # cross-attention to modality embeddings
FFN_DENSE = "dense"
FFN_MOE = "moe"
FFN_NONE = "none"            # Mamba2 blocks carry no separate FFN


@dataclasses.dataclass(frozen=True)
class BlockSpec_:
    """One position in the repeating layer pattern."""

    mixer: str
    ffn: str


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | hybrid | ssm | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 → d_model // num_heads
    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    moe_every: int = 1             # MoE FFN on layers where i % moe_every == r
    moe_offset: int = 0
    capacity_factor: float = 1.25
    # --- attention flavour ---
    sliding_window: int = 0        # >0 → SWA on MIXER_ATTN_LOCAL layers
    local_global_period: int = 0   # gemma2: alternate local/global
    attn_logit_softcap: float = 0.0
    final_logit_softcap: float = 0.0
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    # --- SSM / hybrid ---
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    ssm_conv_width: int = 4
    attn_every: int = 0            # hybrid: attention on i % attn_every == k
    attn_offset: int = 0
    # --- VLM ---
    cross_attn_every: int = 0      # cross-attn on i % every == offset
    cross_attn_offset: int = 0
    num_image_tokens: int = 0
    # --- misc ---
    # Head padding: q-heads padded to this count with zero-initialised
    # wq/wo rows, so the pad heads contribute nothing at init.
    padded_heads: int = 0
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    subquadratic: bool = False

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.num_heads, 1))

    @property
    def resolved_num_heads(self) -> int:
        return self.padded_heads or self.num_heads

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    def pattern(self) -> List[BlockSpec_]:
        """The repeating unit of the layer stack."""
        period = 1
        if self.attn_every:
            period = _lcm(period, self.attn_every)
        if self.cross_attn_every:
            period = _lcm(period, self.cross_attn_every)
        if self.local_global_period:
            period = _lcm(period, self.local_global_period)
        if self.num_experts and self.moe_every > 1:
            period = _lcm(period, self.moe_every)
        out: List[BlockSpec_] = []
        for i in range(period):
            if self.family == "ssm":
                mixer = MIXER_SSM
            elif self.attn_every:      # hybrid: mostly SSM, sparse attention
                mixer = (MIXER_ATTN if i % self.attn_every == self.attn_offset
                         else MIXER_SSM)
            elif self.cross_attn_every:
                mixer = (MIXER_XATTN
                         if i % self.cross_attn_every == self.cross_attn_offset
                         else MIXER_ATTN)
            elif self.local_global_period:
                mixer = (MIXER_ATTN_LOCAL
                         if i % self.local_global_period == 0 else MIXER_ATTN)
            elif self.sliding_window:
                mixer = MIXER_ATTN_LOCAL
            else:
                mixer = MIXER_ATTN
            if mixer == MIXER_SSM:
                ffn = FFN_NONE if self.family == "ssm" else (
                    FFN_MOE if self.num_experts
                    and i % self.moe_every == self.moe_offset else FFN_DENSE)
            elif self.num_experts and i % self.moe_every == self.moe_offset:
                ffn = FFN_MOE
            else:
                ffn = FFN_DENSE if self.d_ff else FFN_NONE
            out.append(BlockSpec_(mixer, ffn))
        return out

    def num_groups(self) -> int:
        p = len(self.pattern())
        if self.num_layers % p:
            raise ValueError(
                f"{self.name}: {self.num_layers} layers not divisible by "
                f"pattern period {p}")
        return self.num_layers // p

    # ------------------------------------------------------------------
    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks)."""
        d, f = self.d_model, self.d_ff
        hd = self.resolved_head_dim
        n = self.vocab_size * d
        if not self.tie_embeddings:
            n += self.vocab_size * d
        for spec in self.pattern() * self.num_groups():
            if spec.mixer in (MIXER_ATTN, MIXER_ATTN_LOCAL, MIXER_XATTN):
                # padded q-heads allocate real (zero) rows
                n += d * hd * (self.resolved_num_heads
                               + 2 * self.num_kv_heads)
                n += self.resolved_num_heads * hd * d
            elif spec.mixer == MIXER_SSM:
                di, ns, hs = self.d_inner, self.ssm_state, self.ssm_heads
                n += d * (2 * di + 2 * ns + hs)  # in_proj(z,x,B,C,dt)
                n += di * d                       # out_proj
                n += self.ssm_conv_width * (di + 2 * ns) + 2 * hs + di
            if spec.ffn == FFN_DENSE:
                n += 3 * d * f
            elif spec.ffn == FFN_MOE:
                n += d * self.num_experts + 3 * d * f * self.num_experts
            n += 2 * d  # norms
        return n

    def active_param_count(self) -> int:
        """Parameters doing useful work per token (MoE: routed experts
        only; TP padding: zero pad-head rows excluded)."""
        d, f = self.d_model, self.d_ff
        total = self.param_count()
        if self.padded_heads:
            attn_layers = sum(
                1 for s in self.pattern()
                if s.mixer in (MIXER_ATTN, MIXER_ATTN_LOCAL, MIXER_XATTN)) \
                * self.num_groups()
            total -= attn_layers * 2 * d * self.resolved_head_dim * \
                (self.padded_heads - self.num_heads)
        if not self.num_experts:
            return total
        moe_layers = sum(1 for s in self.pattern() if s.ffn == FFN_MOE) \
            * self.num_groups()
        inactive = moe_layers * 3 * d * f * \
            (self.num_experts - self.experts_per_token)
        return total - inactive


def _lcm(a: int, b: int) -> int:
    return a * b // math.gcd(a, b)


@dataclasses.dataclass
class ArchEntry:
    full: ArchConfig
    smoke: ArchConfig


_REGISTRY: Dict[str, ArchEntry] = {}


def register(full: ArchConfig, smoke: ArchConfig) -> ArchConfig:
    _REGISTRY[full.name] = ArchEntry(full, smoke)
    return full


def get_config(name: str, smoke: bool = False) -> ArchConfig:
    _ensure_loaded()
    entry = _REGISTRY.get(name)
    if entry is None:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return entry.smoke if smoke else entry.full


def _ensure_loaded() -> None:
    if _REGISTRY:
        return
    from . import gemma2_2b, mamba2_780m, mixtral_8x22b  # noqa: F401
