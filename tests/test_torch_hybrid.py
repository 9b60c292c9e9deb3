"""The port's hybrid stack (jamba-1.5-large: SSM and attention mixers with
dense and MoE FFNs) and cross-attention layers (llama-3.2-vision-90b)
against the JAX reference, on the CPU, and the depth cut that serves
jamba on one card.

Weights come from the reference's ``init_lm`` through ``params_from_jax``,
with the SSM's float32 leaves drawn away from their init values and
llama's gates set to a nonzero value where a test says so; inputs are
made with numpy from a seed.  float32 is held to 1e-4 elementwise (the
two packages sum in different orders; llama's 5 layers to 1e-4 of each
tensor's largest magnitude, ``_close_to_scale``); bfloat16 to the
reference's own bf16-against-f32 error (``test_torch_moe._as_close``).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from test_torch_moe import _as_close, _dispatch_of, _Dispatches

from repro import models as jax_models
from repro.configs import get_config as jax_config
from repro_torch.configs import DepthCut, depth_cut, get_config
from repro_torch.configs.base import (FFN_DENSE, FFN_MOE, MIXER_ATTN,
                                      MIXER_SSM, MIXER_XATTN, ArchConfig)
from repro_torch.models import (decode_step, forward, forward_with_cache,
                                init_decode_cache, init_lm, jax_layout, moe,
                                params_from_jax)
from repro_torch.models.model import layer_specs

JAMBA, LLAMA = "jamba-1.5-large-398b", "llama-3.2-vision-90b"
TOL = 1e-4
MAX_SEQ = 64


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _close_to_scale(got, want, tol=TOL):
    """Within ``tol`` of the tensor's largest magnitude (at least 1):
    llama's smoke stack is 5 layers deep, and float32's summation-order
    differences grow with depth as the residual stream does (K and V of
    layer 3 reach 21; deepseek-coder-33b's smoke model, held elementwise
    at its 2 layers, is 8.3 times the elementwise bound off at 5)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err = np.abs(got - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), err


def _smoke(arch, dtype, gate=0.0):
    """(jcfg, cfg, reference params, port params) of the smoke config in
    ``dtype``: the SSM's a_log, dt_bias and d_skip drawn away from their
    init values (0, 0, 1), and every cross-attention gate set to
    ``gate``."""
    jcfg = dataclasses.replace(jax_config(arch, smoke=True), dtype=dtype)
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype=dtype)
    jp, _ = jax_models.init_lm(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(np.array, jp)
    rng = np.random.default_rng(7)
    for block in tree["blocks"]:
        mixer = block["mixer"]
        if "a_log" in mixer:
            shape = mixer["a_log"].shape          # (num_groups, H)
            mixer["a_log"] = np.log(rng.uniform(1, 4, shape)) \
                .astype(np.float32)
            mixer["dt_bias"] = rng.uniform(-1, 0, shape).astype(np.float32)
            mixer["d_skip"] = rng.uniform(0.5, 1.5, shape).astype(np.float32)
        if "gate" in mixer:
            mixer["gate"] = np.full_like(mixer["gate"], gate)
    jp = jax.tree.map(jnp.asarray, tree)
    return jcfg, cfg, jp, params_from_jax(tree, cfg, device="cpu")


def _image(cfg, seed=3):
    return np.random.default_rng(seed).standard_normal(
        (2, cfg.num_image_tokens, cfg.d_model)).astype(np.float32)


def _caches(cache, jcache, jcache32, cfg):
    """(name, port, reference, reference in f32) of every cache leaf.  The
    port's caches are per layer; the reference's per pattern position,
    stacked over groups.  A cross-attention layer has none in the port (an
    empty dictionary) and a placeholder in the reference.  Every leaf has
    the reference's dtype."""
    pattern = cfg.pattern()
    assert len(cache) == cfg.num_layers
    out = []
    for layer, c in enumerate(cache):
        g, pos = divmod(layer, len(pattern))
        if pattern[pos].mixer == MIXER_XATTN:
            assert c == {} and set(jcache[pos]) == {"unused"}
            continue
        assert set(c) == set(jcache[pos])
        for name, leaf in c.items():
            want = jcache[pos][name][g]
            assert leaf.dtype == getattr(torch, str(want.dtype))
            # a copy: decode updates the port's caches in place
            out.append((f"layer {layer} {name}", leaf.float().clone(), want,
                        jcache32[pos][name][g]))
    return out


@functools.lru_cache(maxsize=None)
def _reference(jcfg, jit):
    """The reference's forward, forward_with_cache and decode_step at
    ``jcfg``; with ``jit`` each compiled once for all of a test's draws
    (whole, so XLA may order a sum otherwise than the reference's own
    calls do)."""
    wrap = jax.jit if jit else (lambda fn: fn)
    return (wrap(lambda p, t, img: jax_models.forward(
                p, t, jcfg, image_embeds=img, remat=False)),
            wrap(lambda p, t, img: jax_models.forward_with_cache(
                p, t, jcfg, max_seq=MAX_SEQ, image_embeds=img)),
            wrap(lambda p, c, t, pos, img: jax_models.decode_step(
                p, c, t, pos, jcfg, img)))


def _run_both(arch, dtype, gate, image, tokens, routing=False, jit=False,
              close=_close):
    """forward, forward_with_cache and 6 decode steps of the float32
    reference's greedy tokens, on both packages.  Returns every compared
    tensor as (name, port, reference, reference run in float32 on the
    same weights), and the port's and (``routing``: read from its dispatch
    tensors, op by op) the reference's routings of ``forward``.  In
    float32 each tensor is checked here by ``close``."""
    jcfg, cfg, jp, p = _smoke(arch, dtype, gate)
    jcfg32 = dataclasses.replace(jcfg, dtype="float32")
    jp32 = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    jtokens = jnp.asarray(tokens)
    jimg = None if image is None else jnp.asarray(image)
    timg = None if image is None else torch.from_numpy(image)
    fwd, fwc, dec = _reference(jcfg, jit)
    fwd32, fwc32, dec32 = _reference(jcfg32, jit)

    routings = []
    route = moe.route
    moe.route = lambda *a: routings.append(route(*a)) or routings[-1]
    try:
        rec = _Dispatches()
        if routing:
            with jax.disable_jit():
                want, want_aux = jax_models.forward(
                    jp, jtokens, jcfg, image_embeds=jimg, remat=False,
                    rules=rec)
        else:
            want, want_aux = fwd(jp, jtokens, jimg)
        want32, _ = fwd32(jp32, jtokens, jimg)
        got, aux = forward(p, torch.from_numpy(tokens), cfg, timg)
    finally:
        moe.route = route
    assert got.dtype == torch.float32
    compared = [("forward", got, want, want32)]
    if dtype == "float32":
        _close(aux, want_aux, 1e-5)

    want, jcache, _ = fwc(jp, jtokens, jimg)
    want32, jcache32, _ = fwc32(jp32, jtokens, jimg)
    got, cache, got_aux = forward_with_cache(
        p, torch.from_numpy(tokens), cfg, MAX_SEQ, image_embeds=timg)
    compared += [("prefill", got, want, want32),
                 *_caches(cache, jcache, jcache32, cfg)]
    if dtype == "float32":
        _close(got_aux, want_aux, 1e-5)

    # 6 decode steps compared together (see test_torch_models)
    tok = np.array(jnp.argmax(want32[:, -1], axis=-1))
    steps = []
    for step in range(6):
        pos = tokens.shape[1] + step
        jtok = jnp.asarray(tok, jnp.int32)
        want, jcache = dec(jp, jcache, jtok, jnp.int32(pos), jimg)
        want32, jcache32 = dec32(jp32, jcache32, jtok, jnp.int32(pos), jimg)
        got, cache = decode_step(p, cache, torch.from_numpy(tok), pos, cfg,
                                 timg)
        steps.append((got.numpy(), np.asarray(want, np.float32),
                      np.asarray(want32, np.float32)))
        tok = np.array(jnp.argmax(want32, axis=-1))
    compared += [("decode", *(np.stack(s) for s in zip(*steps))),
                 *_caches(cache, jcache, jcache32, cfg)]
    if dtype == "float32":
        for _, got, want, _ in compared:
            close(got, want)
    return compared, routings, rec.tensors


def _mean_errors(compared):
    """The port's and the reference's mean absolute error against the
    reference's float32 run, summed over the compared tensors."""
    got = sum(float(np.abs(np.asarray(g, np.float32)
                           - np.asarray(w32, np.float32)).mean())
              for _, g, _, w32 in compared)
    ref = sum(float(np.abs(np.asarray(w, np.float32)
                           - np.asarray(w32, np.float32)).mean())
              for _, _, w, w32 in compared)
    return got, ref


# ---------------------------------------------------------------------------
# jamba-1.5-large: the hybrid stack
# ---------------------------------------------------------------------------
def _jamba_tokens(seed, pads):
    tokens = np.random.default_rng(seed).integers(
        1, get_config(JAMBA, smoke=True).vocab_size, (2, 40))
    if pads:
        tokens[0, :30] = 0
    return tokens


def test_jamba_smoke_matches_jax():
    """float32, the 8-layer smoke pattern (SSM+dense, SSM+MoE, SSM+dense,
    SSM+MoE, attention+dense, SSM+MoE, SSM+dense, SSM+MoE): ``forward``
    (logits and the sum of the 4 MoE layers' aux losses),
    ``forward_with_cache`` (logits, aux and every SSM and KV cache leaf)
    and 6 decode steps, within 1e-4.  Row 0's first 30 tokens are token
    0, as the engine left-pads a wave, so they overflow an expert's C = 25
    slots; each MoE layer's routing is the reference's to the slot."""
    cfg = get_config(JAMBA, smoke=True)
    assert [(s.mixer, s.ffn) for s in cfg.pattern()] == \
        [(MIXER_SSM, FFN_DENSE), (MIXER_SSM, FFN_MOE)] * 2 + \
        [(MIXER_ATTN, FFN_DENSE), (MIXER_SSM, FFN_MOE),
         (MIXER_SSM, FFN_DENSE), (MIXER_SSM, FFN_MOE)]
    _, routings, dispatches = _run_both(JAMBA, "float32", 0.0, None,
                                        _jamba_tokens(0, pads=True),
                                        routing=True)
    assert len(routings) == len(dispatches) == 4
    assert all(r.capacity == 25 and not r.kept[0].all() for r in routings)
    assert all(np.array_equal(_dispatch_of(r), d)
               for r, d in zip(routings, dispatches))


def test_jamba_bfloat16_within_the_references_own_error():
    """bfloat16, held to the reference's own bf16-against-f32 error: the
    port's mean absolute error against the reference's float32 run (the
    same bf16 weights, upcast), summed over every tensor of
    ``_run_both`` (logits of forward, prefill and 6 decode steps, every
    cache leaf after prefill and after decode) and over 4 prompt draws
    (two with the pad run), at most 1.25 times the reference's bf16
    run's.  The sum over draws is the check because at the smoke model's
    4 experts many routing decisions are near ties: any two bf16 runs
    (the reference's against its own f32 one too) route different tokens
    and drop different pairs, so one draw's ratio to the reference's
    error ranged over 0.35-5.5 per tensor (draws 0-4), while pooled it
    is 1.02."""
    got = ref = 0.0
    for seed in range(4):
        compared, _, _ = _run_both(JAMBA, "bfloat16", 0.0, None,
                                   _jamba_tokens(seed, pads=seed % 2 == 0),
                                   jit=True)
        g, r = _mean_errors(compared)
        got, ref = got + g, ref + r
    assert got <= 1.25 * ref, (got, ref)


@pytest.mark.parametrize("arch", [JAMBA, LLAMA])
def test_teacher_forced_decode_matches_forward(arch):
    """The reference's own invariant (``tests/test_models.py``): after a
    prefill of 8 tokens, decoding tokens 8..11 one at a time gives the
    full-sequence logits at those positions, within the reference's
    2e-3; llama with its image and gates of 0.5.  jamba's experts take
    every pair here (capacity factor E / k = 2): at its own 1.25 the
    12-token forward drops pairs that a one-token decode step keeps, so
    the two differ by design, in the reference too."""
    _, cfg, _, p = _smoke(arch, "float32", gate=0.5)
    if cfg.num_experts:
        cfg = dataclasses.replace(
            cfg, capacity_factor=cfg.num_experts / cfg.experts_per_token)
    tokens = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 12))
    img = torch.from_numpy(_image(cfg)) if cfg.num_image_tokens else None
    full, _ = forward(p, torch.from_numpy(tokens), cfg, img)
    _, cache, _ = forward_with_cache(p, torch.from_numpy(tokens[:, :8]), cfg,
                                     32, image_embeds=img)
    for t in range(8, 12):
        logits, cache = decode_step(p, cache, torch.from_numpy(tokens[:, t]),
                                    t, cfg, img)
        _close(logits, full[:, t], 2e-3)


# ---------------------------------------------------------------------------
# llama-3.2-vision-90b: cross-attention
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype,image", [("float32", True),
                                         ("float32", False),
                                         ("bfloat16", True)])
def test_llama_smoke_matches_jax(dtype, image):
    """4 self-attention layers and a cross-attention layer: ``forward``,
    ``forward_with_cache`` and 6 decode steps, with ``image_embeds``
    (2, 8, 64) and every gate at 0.5; without them (the serving path), the
    cross-attention layer is ungated causal self-attention with RoPE at
    prefill and attention over the current token alone in decode, as in
    the reference.  float32 within 1e-4 of each tensor's largest magnitude
    (``_close_to_scale``)."""
    cfg = get_config(LLAMA, smoke=True)
    assert [s.mixer for s in cfg.pattern()] == [MIXER_ATTN] * 4 + \
        [MIXER_XATTN]
    tokens = np.random.default_rng(5).integers(1, cfg.vocab_size, (2, 40))
    compared, routings, _ = _run_both(LLAMA, dtype, 0.5,
                                      _image(cfg) if image else None, tokens,
                                      close=_close_to_scale)
    assert not routings
    if dtype == "bfloat16":
        for _, got, want, want32 in compared:
            _as_close(got, want, want32, dtype)


def test_gate_scales_cross_attention():
    """At its init of 0 the gate shuts the image out: two different images
    give the same logits bit for bit; at 0.5 they differ.  The gate is a
    scalar leaf in the model's dtype."""
    outs = {}
    for gate in (0.0, 0.5):
        _, cfg, _, p = _smoke(LLAMA, "float32", gate)
        xattn = p["blocks"][4]["mixer"]
        assert xattn["gate"].shape == () and float(xattn["gate"]) == gate
        assert "gate" not in p["blocks"][0]["mixer"]
        tokens = torch.from_numpy(
            np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 10)))
        outs[gate] = [forward(p, tokens, cfg,
                              torch.from_numpy(_image(cfg, seed)))[0]
                      for seed in (1, 2)]
    assert torch.equal(*outs[0.0])
    assert not torch.allclose(*outs[0.5], atol=1e-3)
    fresh = init_lm(get_config(LLAMA, smoke=True), seed=0, device="cpu")
    gate = fresh["blocks"][4]["mixer"]["gate"]
    assert gate.dtype == torch.bfloat16 and gate.shape == () and \
        float(gate) == 0.0


def _attention_f64(q, k, v, causal=True, window=0, softcap=0.0):
    """Causal GQA attention in the inputs' dtype (the plain version
    computes in float32 whatever it is given)."""
    s, hd, g = q.shape[1], q.shape[3], q.shape[2] // k.shape[2]
    k, v = k.repeat_interleave(g, dim=2), v.repeat_interleave(g, dim=2)
    scores = torch.einsum("bshd,bthd->bhst", q, k) / hd ** 0.5
    mask = torch.ones((s, s), dtype=torch.bool).tril()
    scores = torch.where(mask, scores, torch.tensor(-1e30, dtype=q.dtype))
    return torch.einsum("bhst,bthd->bshd", torch.softmax(scores, -1), v)


@pytest.mark.parametrize("arch,floor", [(LLAMA, (1e-4, 2.5e-4)),
                                        ("deepseek-coder-33b", (0, 1e-4))])
def test_float32_noise_floor_of_the_smoke_models(arch, floor, monkeypatch):
    """What the card's smoke check of llama (``chip_smoke.py``,
    ``LLAMA_SMOKE_TOL`` = 1e-3) rests on: the smoke model's float32
    logits on the CPU, from ``init_lm(seed=0)`` and chip_smoke's tokens,
    against the same weights in float64 differ by 2.42e-4 for llama's 5
    layers, above the 1e-4 that the 2-layer deepseek smoke model (2.5e-5)
    meets; 1e-3 is four times llama's."""
    from repro_torch.kernels import ops
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    tokens = torch.as_tensor(
        np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 40)))
    got, _, _ = forward_with_cache(init_lm(cfg, seed=0, device="cpu"),
                                   tokens, cfg, 64)
    cfg64 = dataclasses.replace(cfg, dtype="float64")
    monkeypatch.setattr(ops, "flash_attention", _attention_f64)
    want, _, _ = forward_with_cache(init_lm(cfg64, seed=0, device="cpu"),
                                    tokens, cfg64, 64)
    err = float((got.double() - want).abs().max())
    assert floor[0] < err < floor[1], err


@pytest.mark.parametrize("arch", [JAMBA, LLAMA])
def test_params_from_jax_bit_exact_and_init_layout(arch):
    """``params_from_jax`` of the reference's bfloat16 ``init_lm``: every
    leaf of every layer (a hybrid block's SSM mixer beside its norm2 and
    FFN, the cross-attention gate) with the reference's dtype and bytes;
    the port's ``init_lm`` gives the same layout; ``jax_layout`` gives
    back the reference's tree, and a fresh decode cache has one entry a
    layer, ``{}`` for cross-attention."""
    jcfg = jax_config(arch, smoke=True)
    cfg = get_config(arch, smoke=True)
    jp, _ = jax_models.init_lm(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(np.asarray, jp)
    p = params_from_jax(tree, cfg, device="cpu")

    def leaves(t, path=""):
        if isinstance(t, dict):
            for k, v in t.items():
                yield from leaves(v, f"{path}.{k}")
        else:
            yield path, t

    def same(t, w):                  # dtype and bytes
        bits, view = (np.int16, torch.int16) \
            if w.dtype == ml_dtypes.bfloat16 else (np.int32, torch.int32)
        return str(t.dtype) == f"torch.{w.dtype}" and \
            np.array_equal(t.view(view).numpy(), w.view(bits))
    pattern = cfg.pattern()
    for layer, bp in enumerate(p["blocks"]):
        g, pos = divmod(layer, len(pattern))
        got = dict(leaves(bp))
        want = dict(leaves(tree["blocks"][pos]))
        assert got.keys() == want.keys()
        assert all(same(got[n], w[g]) for n, w in want.items())
        assert ("ffn" in bp) == (pattern[pos].ffn != "none")

    def layout(t):
        if isinstance(t, dict):
            return {k: layout(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [layout(v) for v in t]
        return (tuple(t.shape), str(t.dtype).removeprefix("torch."))
    assert layout(init_lm(cfg, seed=0, device="cpu")) == layout(p)
    back = jax_layout(p, cfg)
    assert layout(back) == layout(jax.tree.map(
        lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(
            torch.float32 if a.dtype == np.float32 else torch.bfloat16),
        tree, is_leaf=lambda a: isinstance(a, np.ndarray)))
    cache = init_decode_cache(cfg, 2, 16, device="cpu")
    assert len(cache) == cfg.num_layers
    assert [c == {} for c in cache] == [s.mixer == MIXER_XATTN
                                        for s in layer_specs(cfg)]


# ---------------------------------------------------------------------------
# the depth cut
# ---------------------------------------------------------------------------
def test_depth_cut_is_the_first_layers():
    """jamba-1.5-large's cut for one card: its first five layers, each
    block kind once (SSM+dense, SSM+MoE, SSM+dense, SSM+MoE,
    attention+dense), 47.98 GB of bf16 with the embeddings, as one group.
    It adds no field; every field but the depth is the model's."""
    full = get_config(JAMBA)
    cut = depth_cut(full, 5)
    assert isinstance(cut, DepthCut)
    assert [f.name for f in dataclasses.fields(cut)] == \
        [f.name for f in dataclasses.fields(ArchConfig)]
    assert {k: v for k, v in dataclasses.asdict(cut).items()
            if k != "num_layers"} == \
        {k: v for k, v in dataclasses.asdict(full).items()
         if k != "num_layers"}
    assert cut.pattern() == full.pattern()[:5] == layer_specs(cut)
    assert cut.num_groups() == 1
    assert 2 * cut.param_count() == 47_975_802_880
    assert 2 * full.param_count() // full.num_groups() > 80e9
    # a cut deeper than a group repeats the pattern, as the stack does
    assert depth_cut(full, 11).pattern() == \
        full.pattern() + full.pattern()[:3]
    for layers in (0, 73):
        with pytest.raises(ValueError, match="cannot cut"):
            depth_cut(full, layers)
    smoke = depth_cut(get_config(JAMBA, smoke=True), 5)
    params = init_lm(smoke, seed=0, device="cpu")
    assert len(params["blocks"]) == 5
    assert [("ffn" in bp, "a_log" in bp["mixer"])
            for bp in params["blocks"]] == [(True, True)] * 4 + \
        [(True, False)]
    logits, aux = forward(params, torch.zeros((1, 9), dtype=torch.long),
                          smoke)
    assert logits.shape == (1, 9, smoke.vocab_size) and \
        bool(torch.isfinite(logits).all()) and float(aux) > 0
