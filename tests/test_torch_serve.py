"""The port's serving engine against ``repro.serve`` on the CPU: gemma2
(attention), mamba2 (SSM) and mixtral (MoE) smoke models, those of
deepseek-coder-33b, phi3.5-moe, phi3-mini-3.8b and musicgen-medium, and
of jamba-1.5-large (the hybrid stack) and llama-3.2-vision-90b
(cross-attention layers, served with no image as the reference's engine
serves them)."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import init_lm as jax_init_lm
from repro.serve import Request as JaxRequest
from repro.serve import ServeEngine as JaxServeEngine
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import KERNEL
from repro_torch.kernels.ssd_scan import KERNEL as SSD_KERNEL
from repro_torch.models import (init_decode_cache, init_lm, moe,
                                params_from_jax)
from repro_torch.serve import Request, ServeEngine


def _weights(arch):
    jcfg = dataclasses.replace(jax_config(arch, smoke=True), dtype="float32")
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    jp, _ = jax_init_lm(jax.random.PRNGKey(0), jcfg)
    return jcfg, cfg, jp, params_from_jax(jax.tree.map(np.asarray, jp), cfg,
                                          device="cpu")


@pytest.fixture(scope="module")
def weights():
    return _weights("gemma2-2b")


@pytest.fixture(scope="module")
def mamba_weights():
    return _weights("mamba2-780m")


@pytest.fixture(scope="module")
def mixtral_weights():
    return _weights("mixtral-8x22b")


def _requests(cls, eos_ids, vocab=512, lengths=(5, 11, 8)):
    """Three prompts of different lengths (left-padded in a wave of 2),
    then a third request alone in a wave with a pad slot."""
    rng = np.random.default_rng(0)
    return [cls(rid=i, prompt=rng.integers(1, vocab, size=n),
                max_new_tokens=m, eos_id=eos)
            for i, (n, m, eos) in enumerate(zip(lengths, (7, 5, 6),
                                                eos_ids))]


def _serve(jcfg, cfg, jp, p, eos_ids, lengths=(5, 11, 8)):
    vocab = min(cfg.vocab_size, 512)
    ref = JaxServeEngine(jcfg, jp, batch_size=2, max_seq=48)
    ref_out = ref.generate(_requests(JaxRequest, eos_ids, vocab, lengths))
    port = ServeEngine(cfg, p, batch_size=2, max_seq=48, device="cpu")
    port_out = port.generate(_requests(Request, eos_ids, vocab, lengths))
    return ref, ref_out, port, port_out


def test_generate_matches_jax(weights):
    jcfg, cfg, jp, p = weights
    _, free_run, _, _ = _serve(jcfg, cfg, jp, p, (-1, -1, -1))
    # stop request 0 at the third token it produced when running freely
    eos = free_run[0].output[2]
    assert eos not in free_run[0].output[:2]
    before = KERNEL.launches
    ref, ref_out, port, port_out = _serve(jcfg, cfg, jp, p, (eos, -1, -1))
    assert [r.output for r in port_out] == [r.output for r in ref_out]
    assert [r.done for r in port_out] == [r.done for r in ref_out]
    assert len(port_out[0].output) == 3          # stopped at its eos_id
    assert dataclasses.asdict(port.stats) == dataclasses.asdict(ref.stats)
    assert port.stats.prefills == 4              # pad slot counted
    assert KERNEL.launches == before             # the CPU path is plain


def test_mamba2_generate_matches_jax(mamba_weights):
    """The SSM model through the engine: the first wave left-pads prompt 0
    from 5 to 11 tokens with token 0 and no pad mask (the SSM state takes
    the pads in, as the reference's does), in chunks of 8 with the last
    one padded by 5 rows; the second wave carries a pad slot."""
    jcfg, cfg, jp, p = mamba_weights
    _, free_run, _, _ = _serve(jcfg, cfg, jp, p, (-1, -1, -1))
    eos = free_run[1].output[1]
    assert eos not in free_run[1].output[:1]
    before = SSD_KERNEL.launches
    ref, ref_out, port, port_out = _serve(jcfg, cfg, jp, p, (-1, eos, -1))
    assert [r.output for r in port_out] == [r.output for r in ref_out]
    assert len(port_out[1].output) == 2          # stopped at its eos_id
    assert dataclasses.asdict(port.stats) == dataclasses.asdict(ref.stats)
    assert SSD_KERNEL.launches == before         # the CPU path is plain


def test_mixtral_generate_matches_jax(mixtral_weights, monkeypatch):
    """The MoE model through the engine: the first wave left-pads prompt 0
    from 3 to 20 tokens with token 0 and no pad mask.  The 17 pads route
    alike and take capacity as the reference's do: C = 13 slots an expert
    at S = 20, so pairs drop in that wave; decode routes with S = 1 (C =
    4, nothing drops)."""
    jcfg, cfg, jp, p = mixtral_weights
    lengths = (3, 20, 9)
    _, free_run, _, _ = _serve(jcfg, cfg, jp, p, (-1, -1, -1), lengths)
    eos = free_run[2].output[3]
    assert eos not in free_run[2].output[:3]
    routings = []
    route = moe.route
    monkeypatch.setattr(moe, "route",
                        lambda *a: routings.append(route(*a)) or routings[-1])
    before = KERNEL.launches
    ref, ref_out, port, port_out = _serve(jcfg, cfg, jp, p, (-1, -1, eos),
                                          lengths)
    assert [r.output for r in port_out] == [r.output for r in ref_out]
    assert len(port_out[2].output) == 4          # stopped at its eos_id
    assert dataclasses.asdict(port.stats) == dataclasses.asdict(ref.stats)
    first_wave = routings[:cfg.num_layers]
    assert all(r.capacity == 13 and not r.kept.all() for r in first_wave)
    decode = [r for r in routings if r.probs.shape[1] == 1]
    assert decode and all(r.capacity == 4 and r.kept.all() for r in decode)
    assert KERNEL.launches == before             # the CPU path is plain


NEW_ARCHS = ("deepseek-coder-33b", "phi3.5-moe-42b-a6.6b", "phi3-mini-3.8b",
             "musicgen-medium")


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_new_configs_generate_matches_jax(arch, monkeypatch):
    """The four configs that need no new block, through the engine: greedy
    tokens and EngineStats equal to the reference engine's, one request
    stopped at its eos_id.  phi3.5-moe's first wave left-pads prompt 0
    from 3 to 20 tokens, so its pads overflow an expert's C = 13 slots as
    mixtral's do; decode routes with C = 4 and drops nothing."""
    jcfg, cfg, jp, p = _weights(arch)
    lengths = (3, 20, 9) if cfg.num_experts else (5, 11, 8)
    _, free_run, _, _ = _serve(jcfg, cfg, jp, p, (-1, -1, -1), lengths)
    # stop request 2 at the first token it produced, past its first, that
    # it had not produced before
    out = free_run[2].output
    stop = next(j for j in range(1, len(out)) if out[j] not in out[:j])
    eos = out[stop]
    routings = []
    route = moe.route
    monkeypatch.setattr(moe, "route",
                        lambda *a: routings.append(route(*a)) or routings[-1])
    before = KERNEL.launches
    ref, ref_out, port, port_out = _serve(jcfg, cfg, jp, p, (-1, -1, eos),
                                          lengths)
    assert [r.output for r in port_out] == [r.output for r in ref_out]
    assert [r.done for r in port_out] == [r.done for r in ref_out]
    assert len(port_out[2].output) == stop + 1   # stopped at its eos_id
    assert dataclasses.asdict(port.stats) == dataclasses.asdict(ref.stats)
    if cfg.num_experts:
        first_wave = routings[:cfg.num_layers]
        assert all(r.capacity == 13 and not r.kept.all() for r in first_wave)
        decode = [r for r in routings if r.probs.shape[1] == 1]
        assert decode and all(r.capacity == 4 and r.kept.all()
                              for r in decode)
    else:
        assert not routings
    assert KERNEL.launches == before             # the CPU path is plain


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b",
                                  "llama-3.2-vision-90b"])
def test_hybrid_and_cross_attention_generate_matches_jax(arch, monkeypatch):
    """jamba's hybrid stack and llama's cross-attention layers through the
    engine: greedy tokens and EngineStats equal to the reference engine's,
    one request stopped at its eos_id.  Neither engine passes image
    embeddings, so llama's cross-attention layers run as causal
    self-attention at prefill and over the current token in decode.
    jamba routes its 4 MoE layers once each a prefill wave and a decode
    step; its first wave left-pads prompt 0 from 3 to 20 tokens."""
    jcfg, cfg, jp, p = _weights(arch)
    lengths = (3, 20, 9) if cfg.num_experts else (5, 11, 8)
    _, free_run, _, _ = _serve(jcfg, cfg, jp, p, (-1, -1, -1), lengths)
    out = free_run[2].output
    stop = next(j for j in range(1, len(out)) if out[j] not in out[:j])
    routings = []
    route = moe.route
    monkeypatch.setattr(moe, "route",
                        lambda *a: routings.append(route(*a)) or routings[-1])
    before = KERNEL.launches, SSD_KERNEL.launches
    ref, ref_out, port, port_out = _serve(jcfg, cfg, jp, p,
                                          (-1, -1, out[stop]), lengths)
    assert [r.output for r in port_out] == [r.output for r in ref_out]
    assert [r.done for r in port_out] == [r.done for r in ref_out]
    assert len(port_out[2].output) == stop + 1   # stopped at its eos_id
    assert dataclasses.asdict(port.stats) == dataclasses.asdict(ref.stats)
    moe_layers = sum(s.ffn == "moe" for s in cfg.pattern()) * \
        cfg.num_groups()
    passes = 2 + port.stats.decode_steps         # two prefill waves
    assert len(routings) == moe_layers * passes
    assert (KERNEL.launches, SSD_KERNEL.launches) == before   # plain on CPU


def test_sampling_is_seeded(weights):
    _, cfg, _, p = weights

    def run(seed):
        eng = ServeEngine(cfg, p, batch_size=2, max_seq=48, greedy=False,
                          seed=seed, device="cpu")
        return [r.output for r in eng.generate(_requests(Request,
                                                         (-1, -1, -1)))]
    assert run(3) == run(3)


def test_entry_points_default_to_cuda(weights, monkeypatch):
    """Without ``device=`` the entry points ask for the card, and raise
    when there is none instead of running on the CPU."""
    _, cfg, _, p = weights
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(cfg, p)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_lm(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_decode_cache(cfg, 1, 16)
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_jax({}, cfg)


# ---------------------------------------------------------------------------
# The weight leg: weights through the federation (``from_federation``,
# ``fetch_shard``), as the reference's ``tests/test_train_traffic.py``
# serves qwen2-7b's smoke model from a one-pod fleet of 4 hosts
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def qwen_weights():
    return _weights("qwen2-7b")


def _published(jcfg, cfg, jp, p, run="srv"):
    """The reference's and the port's fleets, each holding step 0 of
    ``run`` saved by worker 0 (the port's in the reference's layout,
    its bytes digested on the CPU)."""
    import repro.core as RC
    from repro.train import FederatedCheckpointer as JaxCheckpointer

    import repro_torch.core as TC
    from repro_torch.models import jax_layout
    from repro_torch.train import FederatedCheckpointer
    ref_plane = RC.AnalyticPlane(RC.build_fleet_federation(
        num_pods=1, hosts_per_pod=4))
    plane = TC.AnalyticPlane(TC.build_fleet_federation(
        num_pods=1, hosts_per_pod=4, device="cpu"))
    JaxCheckpointer(run, ref_plane, site="pod0", worker=0).save(0, jp)
    FederatedCheckpointer(run, plane, site="pod0", worker=0).save(
        0, jax_layout(p, cfg))
    return ref_plane, plane


def test_from_federation_serves_the_references_tokens(qwen_weights):
    jcfg, cfg, jp, p = qwen_weights
    ref_plane, plane = _published(jcfg, cfg, jp, p)
    ref = JaxServeEngine.from_federation(jcfg, ref_plane, "srv", step=0,
                                         site="pod0", worker=1, like=jp,
                                         batch_size=2, max_seq=48)
    port = ServeEngine.from_federation(cfg, plane, "srv", site="pod0",
                                       worker=1, like=p, device="cpu",
                                       batch_size=2, max_seq=48)
    assert port.data_stats.fetches > 0
    assert dataclasses.asdict(port.data_stats) == \
        dataclasses.asdict(ref.data_stats)
    assert port.device.type == "cpu" and port.plane is plane
    for name, t in port.params["blocks"][1]["mixer"].items():
        assert torch.equal(t, p["blocks"][1]["mixer"][name]), name
    ref_out = ref.generate(_requests(JaxRequest, (-1, -1, -1), 256))
    port_out = port.generate(_requests(Request, (-1, -1, -1), 256))
    assert [r.output for r in port_out] == [r.output for r in ref_out]
    assert dataclasses.asdict(port.stats) == dataclasses.asdict(ref.stats)


def test_from_federation_template_and_missing_run(qwen_weights):
    """Without ``like`` the template is ``init_lm`` at the engine's seed:
    only its structure counts, so the restored weights are the saved
    ones; a run with no checkpoint raises."""
    jcfg, cfg, jp, p = qwen_weights
    _, plane = _published(jcfg, cfg, jp, p)
    eng = ServeEngine.from_federation(cfg, plane, "srv", site="pod0",
                                      worker=3, device="cpu", seed=5)
    assert torch.equal(eng.params["embed"]["head"], p["embed"]["head"])
    assert torch.equal(eng.params["blocks"][0]["ffn"]["w2"],
                       p["blocks"][0]["ffn"]["w2"])
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        ServeEngine.from_federation(cfg, plane, "other", site="pod0",
                                    device="cpu")


def test_fetch_shard_folds_into_data_stats(qwen_weights):
    jcfg, cfg, jp, p = qwen_weights
    ref_plane, plane = _published(jcfg, cfg, jp, p)
    path = "/ckpt/srv/step_00000000/manifest.json"
    ref = JaxServeEngine(jcfg, jp, batch_size=1, max_seq=64,
                         plane=ref_plane, site="pod0", worker=2)
    port = ServeEngine(cfg, p, batch_size=1, max_seq=64, plane=plane,
                       site="pod0", worker=2, device="cpu")
    want = ref.fetch_shard(path, method="cvmfs")
    got = port.fetch_shard(path, method="cvmfs")
    assert got.ok and got.bytes == want.bytes > 0
    assert port.data_stats.fetches == 1
    assert port.data_stats.by_method.get("cvmfs")
    assert dataclasses.asdict(port.data_stats) == \
        dataclasses.asdict(ref.data_stats)
    with pytest.raises(RuntimeError, match="without a data plane"):
        ServeEngine(cfg, p, device="cpu").fetch_shard(path)


def test_launcher_prints_the_references_lines(capsys):
    """``python -m repro_torch.launch.serve --device cpu`` against the
    reference's launcher at its defaults: both lines, character for
    character."""
    from repro.launch.serve import main as jax_main

    from repro_torch.launch.serve import main
    assert jax_main([]) == 0
    want = capsys.readouterr().out
    assert main(["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert got == want
    assert got.startswith("weights via federation: ") and \
        got.count("\n") == 2
