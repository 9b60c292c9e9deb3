"""The port's layers and gemma2 model against the JAX reference, on the CPU.

Weights come from ``repro.models.init_lm`` through ``params_from_jax``;
inputs are made with numpy from a seed.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jax_forward
from repro.models import forward_with_cache as jax_forward_with_cache
from repro.models import init_lm as jax_init_lm
from repro.models import layers as jax_layers
from repro_torch.configs import depth_cut, get_config
from repro_torch.models import (decode_step, forward, forward_with_cache,
                                init_lm, jax_layout, layers, params_from_jax)
from repro_torch.models.model import layer_specs


def _rand(*shape, seed=0, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)) \
        .astype(np.float32)


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# layers one by one
# ---------------------------------------------------------------------------
def test_rms_norm():
    x, w = _rand(2, 5, 32), _rand(32, seed=1, scale=0.1)
    _close(layers.rms_norm(torch.from_numpy(x), torch.from_numpy(w)),
           jax_layers.rms_norm(jnp.asarray(x), jnp.asarray(w)))


@pytest.mark.parametrize("cap", [0.0, 30.0])
def test_softcap(cap):
    x = _rand(4, 64, scale=40.0)
    _close(layers.softcap(torch.from_numpy(x), cap),
           jax_layers.softcap(jnp.asarray(x), cap))


def test_swiglu():
    x, w1, w3, w2 = _rand(2, 3, 16), _rand(16, 24, seed=1), \
        _rand(16, 24, seed=2), _rand(24, 16, seed=3)
    got = layers.swiglu(*(torch.from_numpy(a) for a in (x, w1, w3, w2)))
    want = jax_layers.swiglu(*(jnp.asarray(a) for a in (x, w1, w3, w2)))
    _close(got, want, 1e-4)


@pytest.mark.parametrize("positions", [np.arange(7)[None, :],
                                       np.arange(4000, 4007)[None, :]])
def test_apply_rope(positions):
    x = _rand(2, 7, 3, 32)
    got = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(positions))
    want = jax_layers.apply_rope(jnp.asarray(x), jnp.asarray(positions))
    _close(got, want, 1e-4)


@pytest.mark.parametrize("tie", [True, False])
def test_embed_and_logits(tie):
    emb, head = _rand(50, 16), _rand(16, 50, seed=1)
    jp = {"embedding": jnp.asarray(emb)}
    p = {"embedding": torch.from_numpy(emb)}
    if not tie:
        jp["head"], p["head"] = jnp.asarray(head), torch.from_numpy(head)
    tokens = np.array([[3, 0, 49], [7, 7, 1]])
    x = jax_layers.embed_tokens(jp, jnp.asarray(tokens), 16)
    _close(layers.embed_tokens(p, torch.from_numpy(tokens)), x)
    _close(layers.lm_logits(p, torch.from_numpy(np.array(x)), 3.0),
           jax_layers.lm_logits(jp, x, 3.0))


@pytest.mark.parametrize("shape,fan_in", [((256, 64), 256),
                                          ((64, 8, 128), 8)])
def test_dense_init_fan_in_rule(shape, fan_in):
    """Truncated normal at ±2σ scaled by 1/sqrt(fan_in), where a 3-D weight
    takes shape[-2] as its fan-in, as in the reference."""
    gen = torch.Generator().manual_seed(0)
    w = layers.dense_init(gen, shape)
    std = 1.0 / fan_in ** 0.5
    assert w.shape == shape and w.dtype == torch.float32
    assert w.abs().max().item() <= 2 * std
    # a standard normal truncated at ±2 has std 0.8796
    assert abs(w.std().item() / std - 0.8796) < 0.02


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
def _configs(padded_heads):
    kw = dict(dtype="float32", padded_heads=padded_heads)
    return (dataclasses.replace(jax_config("gemma2-2b", smoke=True), **kw),
            dataclasses.replace(get_config("gemma2-2b", smoke=True), **kw))


def _weights(jcfg, cfg):
    jp, _ = jax_init_lm(jax.random.PRNGKey(0), jcfg)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), cfg,
                               device="cpu")


def _check_caches(caches, jax_caches, pattern_len):
    """Port caches are per layer; the reference's per pattern position,
    stacked over groups."""
    for layer, c in enumerate(caches):
        g, pos = divmod(layer, pattern_len)
        for n in "kv":
            _close(c[n], jax_caches[pos][n][g], 1e-4)


@pytest.mark.parametrize("padded_heads", [0, 8])
def test_forward_prefill_decode_match_jax(padded_heads):
    jcfg, cfg = _configs(padded_heads)
    jp, p = _weights(jcfg, cfg)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 40))
    max_seq = 64

    want, _ = jax_forward(jp, jnp.asarray(tokens), jcfg, remat=False)
    got, aux = forward(p, torch.from_numpy(tokens), cfg)
    _close(got, want, 1e-4)
    assert got.dtype == torch.float32 and float(aux) == 0.0

    want, jcache, _ = jax_forward_with_cache(jp, jnp.asarray(tokens), jcfg,
                                             max_seq=max_seq)
    got, cache, _ = forward_with_cache(p, torch.from_numpy(tokens), cfg,
                                       max_seq=max_seq)
    _close(got, want, 1e-4)
    pattern_len = len(cfg.pattern())
    _check_caches(cache, jcache, pattern_len)

    tok = np.array(jnp.argmax(want[:, -1], axis=-1))
    for step in range(6):
        pos = tokens.shape[1] + step
        want, jcache = jax_decode_step(jp, jcache, jnp.asarray(tok, jnp.int32),
                                       jnp.int32(pos), jcfg)
        got, cache = decode_step(p, cache, torch.from_numpy(tok), pos, cfg)
        _close(got, want, 1e-4)
        tok = np.array(jnp.argmax(want, axis=-1))
    _check_caches(cache, jcache, pattern_len)


def _layout(tree):
    """(shape, dtype) of every leaf, in the tree's structure."""
    if isinstance(tree, dict):
        return {k: _layout(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_layout(v) for v in tree]
    return (tuple(tree.shape), tree.dtype)


def test_init_lm_layout_matches_converted():
    jcfg, cfg = _configs(8)
    _, converted = _weights(jcfg, cfg)
    fresh = init_lm(cfg, seed=0, device="cpu")
    assert _layout(fresh) == _layout(converted)
    for bp in fresh["blocks"]:        # pad heads are zero at init
        assert not bp["mixer"]["wq"][:, cfg.num_heads:].any()
        assert not bp["mixer"]["wo"][cfg.num_heads:].any()
        assert bp["mixer"]["wq"][:, :cfg.num_heads].any()


def test_params_from_jax_bfloat16_bit_exact():
    jcfg = jax_config("gemma2-2b", smoke=True)       # bfloat16 weights
    cfg = get_config("gemma2-2b", smoke=True)
    jp, _ = jax_init_lm(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(np.asarray, jp)
    p = params_from_jax(tree, cfg, device="cpu")
    wq = tree["blocks"][1]["mixer"]["wq"][0]          # group 0, position 1
    assert wq.dtype == ml_dtypes.bfloat16
    got = p["blocks"][1]["mixer"]["wq"]
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.view(torch.int16).numpy(), wq.view(np.int16))


def test_partial_groups_and_unequal_lengths_raise():
    """A plain config whose layers are not whole groups still raises, in
    ``num_groups`` and so in ``layer_specs`` and ``init_lm``, as in the
    reference; ``jax_layout`` refuses blocks that are not whole groups or
    not the config's layers.  jamba's depth cut (its first 5 layers, one
    group) runs; its blocks, caches and block kinds must have one length
    everywhere, so that no loop over them stops early."""
    smoke = get_config("jamba-1.5-large-398b", smoke=True)
    partial = dataclasses.replace(smoke, num_layers=5)
    with pytest.raises(ValueError, match="not divisible"):
        dataclasses.replace(jax_config("jamba-1.5-large-398b", smoke=True),
                            num_layers=5).num_groups()
    for fn in (partial.num_groups, lambda: layer_specs(partial),
               lambda: init_lm(partial, device="cpu")):
        with pytest.raises(ValueError, match="not divisible"):
            fn()
    cut = depth_cut(smoke, 5)
    params = init_lm(cut, seed=0, device="cpu")
    with pytest.raises(ValueError, match="not whole groups"):
        jax_layout(params, smoke)
    with pytest.raises(ValueError, match="has 8"):
        jax_layout({**params, "blocks": (params["blocks"] * 4)[:16]}, smoke)
    tokens = torch.zeros((1, 6), dtype=torch.long)
    short = {**params, "blocks": params["blocks"][:4]}
    for fn in (lambda: forward(params, tokens, smoke),
               lambda: forward(short, tokens, cut),
               lambda: forward_with_cache(short, tokens, cut, 16)):
        with pytest.raises(ValueError, match="differ"):
            fn()
    _, cache, _ = forward_with_cache(params, tokens, cut, 16)
    assert len(cache) == 5
    step = torch.zeros((1,), dtype=torch.long)
    for p_, c_ in ((params, cache[:4]), (short, cache),
                   (params, cache + [cache[0]])):
        with pytest.raises(ValueError, match="differ"):
            decode_step(p_, c_, step, 6, cut)
    logits, _ = decode_step(params, cache, step, 6, cut)
    assert logits.shape == (1, cut.vocab_size)


# ---------------------------------------------------------------------------
# the configs that need no new block: deepseek-coder-33b (56 q-heads
# padded to 64 over 8 KV), phi3.5-moe (16 experts, top-2), phi3-mini-3.8b
# (MHA) and musicgen-medium (the audio family, which runs the dense
# decoder over frame ids); their smoke models at head_dim 16
# ---------------------------------------------------------------------------
NEW_ARCHS = ("deepseek-coder-33b", "phi3.5-moe-42b-a6.6b", "phi3-mini-3.8b",
             "musicgen-medium")
ARCHS = NEW_ARCHS + ("gemma2-2b", "mamba2-780m", "mixtral-8x22b",
                     "qwen2-7b", "jamba-1.5-large-398b",
                     "llama-3.2-vision-90b")


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_equals_reference(arch, smoke):
    """Every registered config is the reference's, field for field."""
    assert dataclasses.asdict(get_config(arch, smoke=smoke)) == \
        dataclasses.asdict(jax_config(arch, smoke=smoke))


def _smoke_model(arch, dtype):
    jcfg = dataclasses.replace(jax_config(arch, smoke=True), dtype=dtype)
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype=dtype)
    jp, _ = jax_init_lm(jax.random.PRNGKey(0), jcfg)
    return jcfg, cfg, jp, params_from_jax(jax.tree.map(np.asarray, jp), cfg,
                                          device="cpu")


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}.{k}")
    else:
        yield path, tree


# tokens whose dispatch differs from the reference's, per layer: float32
# routes every token equally; in bfloat16 the layers' inputs differ by the
# attention's roundings (the reference rounds its scores to bf16, see
# ``test_torch_moe.py``), and 2 of the first layer's 80 tokens change
# dispatch.  The count is asserted, not hidden
MOE_FLIPS = {"float32": [0, 0], "bfloat16": [2, 0]}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_new_smoke_models_match_jax(arch, dtype, monkeypatch):
    """``forward``, ``forward_with_cache`` (logits and every cache leaf)
    and 6 ``decode_step``s against the reference: in float32 within 1e-4,
    in bfloat16 held to the reference's own bfloat16 accuracy against its
    float32 run (``test_torch_moe._as_close``).  For phi3.5-moe the first
    30 of row 0's tokens are token 0, as the engine left-pads a wave: they
    route alike and overflow an expert's C = 25 slots; each layer's
    routing is compared to the slot through the reference's dispatch
    tensors, read by the stand-in for ``rules.constrain``."""
    from test_torch_moe import _as_close, _dispatch_of, _Dispatches

    from repro_torch.models import moe
    jcfg, cfg, jp, p = _smoke_model(arch, dtype)
    jcfg32 = dataclasses.replace(jcfg, dtype="float32")
    jp32 = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    tokens = np.random.default_rng(0).integers(1, cfg.vocab_size, (2, 40))
    if cfg.num_experts:
        tokens[0, :30] = 0
    jtokens = jnp.asarray(tokens)
    routings = []
    route = moe.route
    monkeypatch.setattr(moe, "route",
                        lambda *a: routings.append(route(*a)) or routings[-1])
    rec = _Dispatches()
    with jax.disable_jit(cfg.num_experts > 0):
        want, want_aux = jax_forward(jp, jtokens, jcfg, remat=False,
                                     rules=rec if cfg.num_experts else None)
    want32, _ = jax_forward(jp32, jtokens, jcfg32, remat=False)
    got, aux = forward(p, torch.from_numpy(tokens), cfg)
    assert got.dtype == torch.float32
    _as_close(got, want, want32, dtype)
    if cfg.num_experts:
        assert len(routings) == len(rec.tensors) == cfg.num_layers
        flips = [int((_dispatch_of(r) != d).any(axis=(2, 3)).sum())
                 for r, d in zip(routings, rec.tensors)]
        assert flips == MOE_FLIPS[dtype]
        assert all(r.capacity == 25 and not r.kept[0].all()
                   for r in routings)
        if dtype == "float32":
            _close(aux, want_aux, 1e-5)
        else:
            # the aux loss counts dispatches: a token that moves from
            # expert a to b moves it by E (P_b - P_a) / (N k), up to 1/40
            # here, so the 2 changed dispatches above are held to 1e-2,
            # not to the reference's own bf16 error (2.3e-4)
            assert abs(float(aux) - float(want_aux)) <= 1e-2
    else:
        assert not routings and float(aux) == 0.0

    max_seq = 64
    want, jcache, _ = jax_forward_with_cache(jp, jtokens, jcfg,
                                             max_seq=max_seq)
    want32, jcache32, _ = jax_forward_with_cache(jp32, jtokens, jcfg32,
                                                 max_seq=max_seq)
    got, cache, _ = forward_with_cache(p, torch.from_numpy(tokens), cfg,
                                       max_seq=max_seq)
    _as_close(got, want, want32, dtype)

    def kv(port, ref, ref32):
        for layer, c in enumerate(port):
            for n in "kv":
                assert c[n].shape == (2, max_seq, cfg.num_kv_heads,
                                      cfg.head_dim)
                _as_close(c[n].float(), ref[0][n][layer],
                          ref32[0][n][layer], dtype)
    kv(cache, jcache, jcache32)

    # 6 decode steps of the float32 reference's greedy tokens, compared
    # together: in bfloat16 one step's error ratio to the reference's
    # ranges over 0.5-1.6 at these smoke models (an MoE token that changes
    # dispatch in one step), so a step alone says little about accuracy
    tok = np.array(jnp.argmax(want32[:, -1], axis=-1))
    steps = []
    for step in range(6):
        pos = tokens.shape[1] + step
        jtok = jnp.asarray(tok, jnp.int32)
        want, jcache = jax_decode_step(jp, jcache, jtok, jnp.int32(pos), jcfg)
        want32, jcache32 = jax_decode_step(jp32, jcache32, jtok,
                                           jnp.int32(pos), jcfg32)
        got, cache = decode_step(p, cache, torch.from_numpy(tok), pos, cfg)
        steps.append((got.numpy(), np.asarray(want, np.float32),
                      np.asarray(want32, np.float32)))
        tok = np.array(jnp.argmax(want32, axis=-1))
    got, want, want32 = (np.stack(s) for s in zip(*steps))
    if dtype == "float32":
        _close(got, want, 1e-4)
    else:
        _as_close(got, want, want32, dtype)
    kv(cache, jcache, jcache32)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_new_params_from_jax_bit_exact_and_init_layout(arch):
    """``params_from_jax`` of the reference's bfloat16 ``init_lm``: every
    leaf of every layer with the reference's dtype (an MoE router stays
    float32) and bytes; the port's own ``init_lm`` gives the same layout,
    with deepseek's 8 pad q-heads zero."""
    jcfg, cfg, jp, p = _smoke_model(arch, "bfloat16")
    tree = jax.tree.map(np.asarray, jp)

    def same(t, w):                  # dtype and bytes
        bits, view = (np.int16, torch.int16) if w.dtype == ml_dtypes.bfloat16 \
            else (np.int32, torch.int32)
        return str(t.dtype) == f"torch.{w.dtype}" and \
            np.array_equal(t.view(view).numpy(), w.view(bits))
    assert len(p["blocks"]) == cfg.num_layers
    for layer, bp in enumerate(p["blocks"]):
        got = dict(_leaves(bp))
        want = dict(_leaves(tree["blocks"][0]))      # stacked over layers
        assert got.keys() == want.keys()
        assert all(same(got[n], w[layer]) for n, w in want.items())
    got = dict(_leaves({"embed": p["embed"], "final_norm": p["final_norm"]}))
    want = _leaves({"embed": tree["embed"], "final_norm": tree["final_norm"]})
    assert all(same(got[n], w) for n, w in want)

    assert _layout(init_lm(cfg, seed=0, device="cpu")) == _layout(p)
    full = get_config(arch)
    if full.padded_heads:          # deepseek: 56 heads padded to 64
        assert full.resolved_num_heads == 64 and full.num_kv_heads == 8
        padded = dataclasses.replace(cfg, padded_heads=8)
        fresh = init_lm(padded, seed=0, device="cpu")
        for bp in fresh["blocks"]:
            assert not bp["mixer"]["wq"][:, cfg.num_heads:].any()
            assert not bp["mixer"]["wo"][cfg.num_heads:].any()
