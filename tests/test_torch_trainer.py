"""The port's training path against the JAX reference, on the CPU.

``lm_loss`` and its gradients against ``jax.value_and_grad`` of the
reference's, ``Trainer`` steps against the reference ``Trainer`` from the
same converted state (``models.state_from_jax``) and the same batches,
the fault tolerance of the reference's own tests (restart replay, the
restart storm through the pod cache, elastic rescale, a falling loss),
and the launcher's line.  All in float32 at qwen2-7b's smoke widths, and
with 6 q-heads over its 2 KV heads (``padded_heads``: qwen2-7b's full
config pads 28 to 32; the pad heads train from step 2, as in the
reference).  Inputs are the federation's token shards, equal on both
sides (``test_torch_loader.py``).
"""
import dataclasses
import re
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import AnalyticPlane, build_fleet_federation
from repro_torch.data import DatasetSpec, FederatedDataLoader, SyntheticTokens
from repro_torch.models import jax_layout, lm_loss, state_from_jax
from repro_torch.train import (AdamWConfig, FailureInjector,
                               FederatedCheckpointer, Trainer)
from repro_torch.train.optimizer import get, walk

# 10 free-running steps (lr 1e-3): (loss atol, parameter atol).  float32
# moments: the two frameworks sum the same float32 products in other
# orders (measured: 3.8e-6 and 2.9e-5); bf16 moments round those
# differences to bf16 now and then (5.8e-5, 2.7e-4); int8_ef sends a
# gradient element that lies near a rounding boundary of its block's int8
# grid one quantum (1/127 of the block's largest) apart, which Adam's
# normalised step turns into up to lr on that element (1.1e-3, 3.4e-3)
FREE_TOL = {("none", "float32"): (2e-5, 1e-4),
            ("none", "bfloat16"): (5e-4, 2e-3),
            ("int8_ef", "float32"): (5e-3, 1e-2)}
# a step from the reference's state: loss (relative above 1: the int8
# moments' runs reach losses of 100 and more), grad norm (relative), each
# element's difference over the largest change of its leaf in the step,
# and the share of all elements that differ by more than 1e-2 of it.  An
# int8 code (a moment's or a sent gradient's) one quantum apart changes an
# element's normalised step by up to a whole step (measured: 0.88 of it,
# on 0.10% of the elements)
STEP_TOL = {"loss": 1e-5, "grad_norm": 1e-3, "of_update": 1.0,
            "share": 1e-2}


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax", reason="the JAX reference is not installed")
    import jax

    from repro import models as jmodels
    from repro.configs import get_config as jcfg
    from repro.core import AnalyticPlane as JPlane
    from repro.core import build_fleet_federation as jfleet
    from repro.data import DatasetSpec as JSpec
    from repro.data import FederatedDataLoader as JLoader
    from repro.data import SyntheticTokens as JTokens
    from repro.train import AdamWConfig as JAdam
    from repro.train import FederatedCheckpointer as JCkpt
    from repro.train import Trainer as JTrainer
    return types.SimpleNamespace(
        jax=jax, models=jmodels, config=jcfg, Plane=JPlane, fleet=jfleet,
        Spec=JSpec, Loader=JLoader, Tokens=JTokens, Adam=JAdam, Ckpt=JCkpt,
        Trainer=JTrainer)


def _cfg(pad=0):
    return dataclasses.replace(get_config("qwen2-7b", smoke=True),
                               dtype="float32", padded_heads=pad)


def _stack(vocab=256, batch=4, seq=16, shards=8):
    fed = build_fleet_federation(num_pods=2, hosts_per_pod=4, device="cpu")
    spec = DatasetSpec("toy", vocab_size=vocab, tokens_per_shard=1 << 12,
                       num_shards=shards)
    SyntheticTokens(spec).publish(fed.origins[0])
    loader = FederatedDataLoader(AnalyticPlane(fed), spec,
                                 global_batch=batch, seq_len=seq,
                                 site="pod0", worker=0)
    return fed, spec, loader


def _jstack(jx, vocab=256, batch=4, seq=16, shards=8):
    fed = jx.fleet(num_pods=2, hosts_per_pod=4)
    spec = jx.Spec("toy", vocab_size=vocab, tokens_per_shard=1 << 12,
                   num_shards=shards)
    jx.Tokens(spec).publish(fed.origins[0])
    return fed, jx.Loader(jx.Plane(fed), spec, global_batch=batch,
                          seq_len=seq, site="pod0", worker=0)


def _numpy(jx, tree):
    return jx.jax.tree.map(np.asarray, tree)


def _pair(jx, mode="none", moments="float32", pad=0, lr=1e-3, wd=0.1):
    """The reference trainer and the port's, the port's state converted
    from the reference's init."""
    cfg = _cfg(pad)
    jcfg = dataclasses.replace(jx.config("qwen2-7b", smoke=True),
                               dtype="float32", padded_heads=pad)
    _, jloader = _jstack(jx)
    jt = jx.Trainer(jcfg, jloader, jx.Adam(lr=lr, warmup_steps=2,
                                           total_steps=100, weight_decay=wd,
                                           moment_dtype=moments),
                    grad_compression=mode)
    _, _, loader = _stack()
    pt = Trainer(cfg, loader, AdamWConfig(lr=lr, warmup_steps=2,
                                          total_steps=100, weight_decay=wd,
                                          moment_dtype=moments),
                 grad_compression=mode, device="cpu")
    pt.state = state_from_jax(_numpy(jx, jt.state), cfg, device="cpu")
    return cfg, jt, pt


def _param_diffs(cfg, jx, pt, jt):
    want = state_from_jax(_numpy(jx, jt.state), cfg, device="cpu")["params"]
    return {path: (got.detach() - get(want, path)).abs().max().item()
            for path, got in walk(pt.state["params"])}


# ---------------------------------------------------------------------------
# the ten configs' smoke models; qwen2-7b's also with 6 q-heads over its 2
# KV heads, llama-3.2-vision's also with image states through its gated
# cross-attention (gates at 0.5: at their init of 0 no gradient reaches
# the image side)
LOSS_CASES = [pytest.param("qwen2-7b", 0, False, id="0"),
              pytest.param("qwen2-7b", 6, False, id="6"),
              *[pytest.param(arch, 0, False, id=arch) for arch in (
                  "gemma2-2b", "mamba2-780m", "mixtral-8x22b",
                  "deepseek-coder-33b", "phi3.5-moe-42b-a6.6b",
                  "phi3-mini-3.8b", "musicgen-medium",
                  "jamba-1.5-large-398b", "llama-3.2-vision-90b")],
              pytest.param("llama-3.2-vision-90b", 0, True,
                           id="llama-3.2-vision-90b-image")]


@pytest.mark.parametrize("arch,pad,image", LOSS_CASES)
def test_lm_loss_and_grads_match_jax(jx, arch, pad, image):
    """The loss, its ce and aux, and every parameter's gradient, against
    ``jax.value_and_grad(repro.models.lm_loss)``, with remat on both
    sides, f32, at each config's smoke widths (local windows, softcaps,
    MoE routing and its aux loss, SSM layers, cross-attention): loss
    within 1e-5, the MoE aux loss within 1e-6 (exactly 0 without MoE),
    each gradient within 2e-4 of its leaf's largest magnitude, 5e-4 with
    image states (float32 sums in other orders; an embedding row sums its
    token's positions, and cancels).  Labels of -1 are masked."""
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              dtype="float32", padded_heads=pad)
    jcfg = dataclasses.replace(jx.config(arch, smoke=True),
                               dtype="float32", padded_heads=pad)
    jparams, _ = jx.models.init_lm(jx.jax.random.PRNGKey(3), jcfg)
    rng = np.random.default_rng(0)
    vocab = cfg.vocab_size
    tokens = rng.integers(0, vocab, (3, 20)).astype(np.int32)
    labels = rng.integers(0, vocab, (3, 20)).astype(np.int32)
    labels[1, :5] = -1
    img = None
    if image:
        jparams = jx.jax.tree_util.tree_map_with_path(
            lambda path, x: np.full_like(x, 0.5) if "gate" in
            jx.jax.tree_util.keystr(path) else x, jparams)
        img = np.random.default_rng(3).standard_normal(
            (3, cfg.num_image_tokens, cfg.d_model)).astype(np.float32)

    def jloss(p):
        return jx.models.lm_loss(p, tokens, labels, jcfg, image_embeds=img)
    (jl, (jce, jaux)), jgrads = jx.jax.value_and_grad(jloss, has_aux=True)(
        jparams)
    params = state_from_jax({"params": _numpy(jx, jparams),
                             "opt": {"mu": {}, "nu": {}, "step": 0}},
                            cfg, device="cpu")["params"]
    leaves = [t.requires_grad_() for _, t in walk(params)]
    loss, (ce, aux) = lm_loss(
        params, torch.from_numpy(tokens), torch.from_numpy(labels), cfg,
        image_embeds=None if img is None else torch.from_numpy(img))
    # a leaf the loss does not reach (the gate of a cross-attention layer
    # run without an image) gets zeros
    grads = [torch.zeros_like(t) if g is None else g for t, g in zip(
        leaves, torch.autograd.grad(loss, leaves, allow_unused=True))]
    assert abs(loss.item() - float(jl)) <= 1e-5
    assert abs(ce.item() - float(jce)) <= 1e-5
    assert abs(aux.item() - float(jaux)) <= 1e-6 * abs(float(jaux))
    if not cfg.num_experts:
        assert aux.item() == float(jaux) == 0.0
    want = state_from_jax({"params": _numpy(jx, jgrads),
                           "opt": {"mu": {}, "nu": {}, "step": 0}},
                          cfg, device="cpu")["params"]
    paths = [path for path, _ in walk(want)]

    def off(got, ref):
        """|got - ref| over ref's largest magnitude (exact where ref is
        all zeros)."""
        top = ref.abs().max()
        diff = (got.double() - ref.double()).abs().max()
        return (diff / top).item() if top > 0 else diff.item()
    # with image states, five float32 layers of self- and gated
    # cross-attention put each framework's gradients up to 2.2e-4 of a
    # leaf's largest magnitude from the port's float64 ones (the gates' up
    # to 1.6e-3 for the reference), and the two frameworks up to 3.3e-4
    # apart (blocks[1].ffn.w1; the gates 2.4e-4)
    bound = 5e-4 if image else 2e-4
    worst = {path: off(g, get(want, path)) for path, g in zip(paths, grads)}
    assert max(worst.values()) <= bound, worst
    if pad:      # the pad rows of wo get a gradient at step 1
        assert get(want, ("blocks", 0, "mixer", "wo"))[4:].abs().max() > 0


@pytest.mark.parametrize("mode,moments,pad", [
    ("none", "float32", 0), ("none", "float32", 6),
    ("none", "bfloat16", 0), ("int8_ef", "float32", 6)])
def test_ten_trainer_steps_match_reference(jx, mode, moments, pad):
    """10 steps of both trainers on the same batches from the same state:
    every loss and every parameter within ``FREE_TOL``."""
    cfg, jt, pt = _pair(jx, mode, moments, pad)
    rj, rp = jt.run(10), pt.run(10)
    loss_tol, param_tol = FREE_TOL[(mode, moments)]
    np.testing.assert_allclose(rp.losses, rj.losses, rtol=0, atol=loss_tol)
    worst = max(_param_diffs(cfg, jx, pt, jt).values())
    assert worst <= param_tol, worst
    if pad:      # the pad heads came alive: their wq rows moved off 0
        wq = pt.state["params"]["blocks"][0]["mixer"]["wq"]
        assert wq[:, 4:].abs().max().item() > 0


@pytest.mark.parametrize("mode,moments", [
    ("none", "int8"), ("int8_ef", "int8"), ("int8_ef", "float32")])
def test_ten_steps_from_the_reference_state(jx, mode, moments):
    """Each of 10 steps from the reference's state of that step (converted
    by ``state_from_jax``), on its batch, within ``STEP_TOL``; int8 moment
    codes within two quanta (one of its own, one carried from a sent
    gradient one quantum apart under int8_ef) on at most ``share`` of
    them, their scales (a block's largest moment over
    127) within 1e-4 relative: a gradient's float32 sums differ by up to
    ~1e-5 of it, squared in the second moment; under int8_ef within 1e-2,
    where a block's largest element may take a sent gradient one quantum
    (1/127 of its block's largest) apart.  The
    reference's int8 moments quantize small second moments to 0 and its
    run blows up from step 3 (loss 34.9 there at lr 1e-3, ~2,800 by step
    10), so free-running runs of the two frameworks part: the comparison
    is of the step itself."""
    cfg, jt, pt = _pair(jx, mode, moments, pad=6)
    for step in range(10):
        batch = jt.loader.batch(step)
        before = state_from_jax(_numpy(jx, jt.state), cfg, device="cpu")
        pt.state = state_from_jax(_numpy(jx, jt.state), cfg, device="cpu")
        metrics = pt.train_step(batch)
        jt.state, jm = jt._jit_step(jt.state, batch)
        want = state_from_jax(_numpy(jx, jt.state), cfg, device="cpu")
        assert abs(metrics["loss"].item() - float(jm["loss"])) <= \
            STEP_TOL["loss"] * max(1.0, float(jm["loss"]))
        assert abs(metrics["grad_norm"].item() / float(jm["grad_norm"])
                   - 1) <= STEP_TOL["grad_norm"]
        worst, off, total = 0.0, 0, 0
        for path, got in walk(pt.state["params"]):
            w, b = get(want["params"], path), get(before["params"], path)
            update = (w - b).abs().max().item() + 1e-12
            diff = (got.detach() - w).abs() / update
            worst = max(worst, diff.max().item())
            off += int((diff > 1e-2).sum())
            total += diff.numel()
        assert worst <= STEP_TOL["of_update"], (step, worst)
        assert off <= STEP_TOL["share"] * total, (step, off, total)
        if moments == "int8":
            for name in ("mu", "nu"):
                for path, got in walk(pt.state["opt"][name]):
                    w = get(want["opt"][name], path)
                    if path[-1] == "q":
                        codes = (got.int() - w.int()).abs()
                        assert codes.max() <= 2 and (codes > 0).float(
                        ).mean() <= STEP_TOL["share"], (step, path)
                    else:
                        torch.testing.assert_close(
                            got, w, atol=1e-12,
                            rtol=1e-4 if mode == "none" else 1e-2)
        assert int(pt.state["opt"]["step"]) == step + 1


# ---------------------------------------------------------------------------
# The reference's fault-tolerance tests, on the port
# ---------------------------------------------------------------------------
def _trainer(loader, cfg, every=4, mode="none"):
    ck = FederatedCheckpointer("run1", loader.plane, site="pod0", worker=2)
    return Trainer(cfg, loader,
                   AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=100),
                   checkpointer=ck, checkpoint_every=every,
                   grad_compression=mode, device="cpu")


def test_loss_decreases():
    _, _, loader = _stack(batch=8, seq=32)
    tr = Trainer(_cfg(), loader, AdamWConfig(lr=3e-3, warmup_steps=2,
                                             total_steps=100), device="cpu")
    report = tr.run(30)
    assert report.steps_run == 30
    assert np.mean(report.losses[-3:]) < np.mean(report.losses[:3]) - 0.05


@pytest.mark.parametrize("mode", ["none", "int8_ef"])
def test_checkpoint_restart_replays_exactly(mode):
    """Failure at step 6 → restore from the step-4 checkpoint → the final
    parameters, moments and residuals equal an uninterrupted run's within
    the reference test's rtol 1e-5, atol 1e-6."""
    cfg = _cfg(6)
    _, _, loader = _stack()
    tr = _trainer(loader, cfg, mode=mode)
    report = tr.run(10, failure=FailureInjector(fail_at=[6]))
    assert report.restarts == 1 and report.restored_from == [4]
    assert tr.step == 10
    _, _, loader2 = _stack()
    tr2 = _trainer(loader2, cfg, mode=mode)
    tr2.run(10)
    got, want = tr.checkpoint_state(), tr2.checkpoint_state()
    pairs = list(zip(walk(got), walk(want), strict=True))
    for (pa, a), (pb, b) in pairs:
        assert pa == pb
        np.testing.assert_allclose(a.detach().float().numpy(),
                                   b.detach().float().numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=str(pa))


def test_restart_storm_hits_pod_cache(jx):
    """After one host restores, sibling hosts restore from cache: the
    reference's test on the port, whose checkpoint holds the reference's
    objects (the same leaves, names and sizes), so each restore's bytes,
    chunks, hits and misses equal the reference's."""
    cfg = _cfg()
    fed, _, loader = _stack()
    tr = _trainer(loader, cfg, every=2)
    tr.run(2)
    jfed, jloader = _jstack(jx)
    jcfg = dataclasses.replace(jx.config("qwen2-7b", smoke=True),
                               dtype="float32")
    jt = jx.Trainer(jcfg, jloader, jx.Adam(lr=1e-3, warmup_steps=2,
                                           total_steps=100),
                    checkpointer=jx.Ckpt("run1", jloader.plane, site="pod0",
                                         worker=2), checkpoint_every=2)
    jt.run(2)
    rows = []
    for f, ck_cls, like in ((fed, FederatedCheckpointer,
                             tr.checkpoint_state()),
                            (jfed, jx.Ckpt, jt.state)):
        origin_before = f.origins[0].stats.egress_bytes
        kw = {"device": "cpu"} if ck_cls is FederatedCheckpointer else {}
        _, st1 = ck_cls("run1", type(loader.plane)(f) if f is fed else
                        jx.Plane(f), site="pod0", worker=5).restore(
            2, like=like, **kw)
        mid = f.origins[0].stats.egress_bytes
        _, st2 = ck_cls("run1", type(loader.plane)(f) if f is fed else
                        jx.Plane(f), site="pod0", worker=6).restore(
            2, like=like, **kw)
        rows.append([(s.bytes, s.chunks, s.cache_hits, s.cache_misses)
                     for s in (st1, st2)]
                    + [mid - origin_before,
                       f.origins[0].stats.egress_bytes - mid])
    assert rows[0][1][3] == 0 and rows[0][3] == 0     # all from the pod cache
    assert rows[0] == rows[1]


def test_elastic_rescale():
    _, _, loader = _stack()
    tr = Trainer(_cfg(), loader, AdamWConfig(warmup_steps=2,
                                             total_steps=100), device="cpu")
    tr.run(2)
    tr.rescale(world=2, rank=0)
    report = tr.run(2)
    assert report.steps_run == 2 and tr.loader.world == 2
    assert tr.loader.batch(4)["tokens"].shape == (2, 16)


def test_trainer_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    _, _, loader = _stack()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(_cfg(), loader)


def test_launcher_line_is_the_references(capsys):
    """``repro_torch.launch.train`` at the reference's defaults (qwen2-7b
    smoke, float32, 30 steps of batch 8 by 64) and with int8_ef and a
    failure at step 20: the reference's one line, ``restarts=1`` in the
    second."""
    from repro_torch.launch.train import main
    pattern = (r"arch=qwen2-7b-smoke steps=30 loss (\d+\.\d{3})→"
               r"(\d+\.\d{3}) restarts=%d hit_rate=(\d\.\d\d)")
    for argv, restarts in (([], 0), (["--grad-compression", "int8_ef",
                                      "--fail-at", "20"], 1)):
        assert main(argv + ["--device", "cpu"]) == 0
        line = capsys.readouterr().out.strip()
        m = re.fullmatch(pattern % restarts, line)
        assert m, line
        assert float(m.group(2)) < float(m.group(1))


def test_zero_d_leaf_keeps_its_shape():
    """The optimizer's step is a 0-d leaf: stored with shape [] (as the
    reference's ``np.asarray`` keeps it) and restored 0-d."""
    _, _, loader = _stack()
    ck = FederatedCheckpointer("zero-d", loader.plane, site="pod0", worker=3)
    state = {"step": torch.tensor(7, dtype=torch.int32),
             "w": torch.ones(3)}
    ck.save(1, state)
    manifest = ck._fetch(f"{ck.prefix(1)}/manifest.json").data.decode()
    assert '"name": "step", "path": "/ckpt/zero-d/step_00000001/step.npy", ' \
        '"dtype": "int32", "shape": []' in manifest
    back, _ = ck.restore(1, like=state, device="cpu")
    assert back["step"].shape == () and int(back["step"]) == 7


def test_checkpoint_state_is_the_references_layout(jx):
    """``checkpoint_state`` stacks the parameters as ``jax_layout`` does and
    keeps the moments' stacked layout: the leaf paths and shapes of the
    reference trainer's state."""
    cfg = _cfg()
    _, _, loader = _stack()
    tr = Trainer(cfg, loader, grad_compression="int8_ef", device="cpu")
    _, jloader = _jstack(jx)
    jcfg = dataclasses.replace(jx.config("qwen2-7b", smoke=True),
                               dtype="float32")
    jt = jx.Trainer(jcfg, jloader, grad_compression="int8_ef")
    jflat = jx.jax.tree_util.tree_flatten_with_path(jt.state)[0]
    want = {tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path):
            tuple(np.shape(v)) for path, v in jflat}
    got = {path: tuple(t.shape) for path, t in walk(tr.checkpoint_state())}
    assert got == want
    assert torch.equal(
        tr.checkpoint_state()["params"]["blocks"][0]["norm1"],
        jax_layout(tr.state["params"], cfg)["blocks"][0]["norm1"])
