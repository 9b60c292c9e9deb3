"""The port's serving engine against ``repro.serve`` on the CPU: gemma2
(attention) and mamba2 (SSM) smoke models."""
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
from repro_torch.models import init_decode_cache, init_lm, params_from_jax
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


def _requests(cls, eos_ids, vocab=512):
    """Three prompts of different lengths (left-padded in a wave of 2),
    then a third request alone in a wave with a pad slot."""
    rng = np.random.default_rng(0)
    return [cls(rid=i, prompt=rng.integers(1, vocab, size=n),
                max_new_tokens=m, eos_id=eos)
            for i, (n, m, eos) in enumerate(zip((5, 11, 8), (7, 5, 6),
                                                eos_ids))]


def _serve(jcfg, cfg, jp, p, eos_ids):
    vocab = min(cfg.vocab_size, 512)
    ref = JaxServeEngine(jcfg, jp, batch_size=2, max_seq=48)
    ref_out = ref.generate(_requests(JaxRequest, eos_ids, vocab))
    port = ServeEngine(cfg, p, batch_size=2, max_seq=48, device="cpu")
    port_out = port.generate(_requests(Request, eos_ids, vocab))
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
