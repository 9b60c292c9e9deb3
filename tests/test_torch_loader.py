"""The port's ``FederatedDataLoader`` against the reference's, on the CPU.

Both packages build the same fleet, publish the same synthetic token
shards and read them through their own analytic planes: the batches are
equal byte for byte, and the loaders' ``FetchRollup`` counters (fetches,
bytes, hits, misses, chunks, hedges, per method) equal, including the
hedged refetches that avoid a straggling cache.  Then the reference's own
loader tests on the port: restart safety, shifted labels, rank
partitioning, prefetch, and the deprecation shim for a bare
``StashClient``.
"""
import dataclasses
import types

import numpy as np
import pytest

from repro_torch.core import AnalyticPlane, ClientPlane, build_fleet_federation
from repro_torch.data import (DatasetSpec, FederatedDataLoader, LoaderStats,
                              SyntheticTokens)
from repro_torch.core.monitoring import FetchRollup

COUNTERS = ("fetches", "stores", "steps", "bytes_fetched", "bytes_stored",
            "cache_hits", "cache_misses", "local_hits", "chunks", "hedged",
            "sheds", "errors")


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax", reason="the JAX reference is not installed")
    from repro.core import AnalyticPlane as JPlane
    from repro.core import build_fleet_federation as jfleet
    from repro.data import DatasetSpec as JSpec
    from repro.data import FederatedDataLoader as JLoader
    from repro.data import SyntheticTokens as JTokens
    return types.SimpleNamespace(Plane=JPlane, fleet=jfleet, Spec=JSpec,
                                 Loader=JLoader, Tokens=JTokens)


def _stack(pods=2, hosts=4, per_shard=1 << 12, shards=8, vocab=256):
    fed = build_fleet_federation(num_pods=pods, hosts_per_pod=hosts,
                                 device="cpu")
    spec = DatasetSpec("toy", vocab_size=vocab, tokens_per_shard=per_shard,
                       num_shards=shards)
    SyntheticTokens(spec).publish(fed.origins[0])
    return fed, spec


def _jstack(jx, pods=2, hosts=4, per_shard=1 << 12, shards=8, vocab=256):
    fed = jx.fleet(num_pods=pods, hosts_per_pod=hosts)
    spec = jx.Spec("toy", vocab_size=vocab, tokens_per_shard=per_shard,
                   num_shards=shards)
    jx.Tokens(spec).publish(fed.origins[0])
    return fed, spec


def _rollup(stats):
    return ({k: getattr(stats, k) for k in COUNTERS},
            {m: {k: v for k, v in b.items() if k != "seconds"}
             for m, b in stats.by_method.items()})


@pytest.mark.parametrize("per_shard,batch,seq,world,steps,hedges", [
    # the trainer tests' stack, into the second shard: after 60 steps of
    # worker-local hits (0 s), the second shard's first (cache) fetch is a
    # straggler against that median and hedges through FetchRequest.avoid
    (1 << 12, 4, 16, 1, 70, True),
    (256, 8, 64, 1, 12, False),      # a step spans shards
    (300, 6, 33, 2, 10, True)])      # two ranks, slices off the shard grid
def test_batches_and_rollup_equal_the_references(jx, per_shard, batch, seq,
                                                 world, steps, hedges):
    """Tokens and labels equal byte for byte (int32) for every rank and
    step; every counter of the rollups equal, and the accounted seconds
    within 1e-9 relative."""
    fed, spec = _stack(per_shard=per_shard)
    jfed, jspec = _jstack(jx, per_shard=per_shard)
    for rank in range(world):
        loader = FederatedDataLoader(AnalyticPlane(fed), spec, batch, seq,
                                     rank=rank, world=world,
                                     site=f"pod{rank}", worker=rank)
        jloader = jx.Loader(jx.Plane(jfed), jspec, batch, seq, rank=rank,
                            world=world, site=f"pod{rank}", worker=rank)
        for step in range(steps):
            got, want = loader.batch(step), jloader.batch(step)
            for key in ("tokens", "labels"):
                assert got[key].dtype == np.int32
                assert got[key].tobytes() == np.asarray(want[key]).tobytes()
            assert loader.slices_for_step(step) == \
                jloader.slices_for_step(step)
        assert _rollup(loader.stats) == _rollup(jloader.stats)
        assert loader.stats.fetch_seconds == pytest.approx(
            jloader.stats.fetch_seconds, rel=1e-9)
        assert loader.stats.hit_rate == pytest.approx(
            jloader.stats.hit_rate, rel=1e-12)
    assert (loader.stats.hedged > 0) == hedges    # the hedging path ran


def test_deterministic_and_restart_safe():
    fed, spec = _stack()
    b3 = FederatedDataLoader(AnalyticPlane(fed), spec, 4, 16,
                             site="pod0").batch(3)
    fed2, spec2 = _stack()
    b3b = FederatedDataLoader(AnalyticPlane(fed2), spec2, 4, 16,
                              site="pod0").batch(3)
    np.testing.assert_array_equal(b3["tokens"], b3b["tokens"])


def test_labels_are_shifted_tokens_with_the_extra_row():
    """The +1 token: each row holds seq_len + 1 tokens, labels the inputs
    shifted by one."""
    fed, spec = _stack()
    loader = FederatedDataLoader(AnalyticPlane(fed), spec, 4, 16,
                                 site="pod0")
    assert loader.tokens_per_step == 4 * 17
    b = loader.batch(0)
    assert b["tokens"].shape == b["labels"].shape == (4, 16)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_prefetch_fills_the_buffer_and_the_cache_warms():
    fed, spec = _stack()
    loader = FederatedDataLoader(AnalyticPlane(fed), spec, 4, 16,
                                 site="pod0", prefetch=3)
    loader.batch(0)
    assert sorted(loader._buffer) == [1, 2, 3]
    for s in range(1, 4):
        loader.batch(s)
    assert loader.stats.hit_rate > 0.3
    assert isinstance(loader.stats, FetchRollup) and LoaderStats is FetchRollup


def test_rank_partitioning_disjoint():
    fed, spec = _stack()
    plane = AnalyticPlane(fed)
    l0 = FederatedDataLoader(plane, spec, 4, 16, rank=0, world=2,
                             site="pod0", worker=1)
    l1 = FederatedDataLoader(plane, spec, 4, 16, rank=1, world=2,
                             site="pod1", worker=1)
    b0, b1 = l0.batch(0), l1.batch(0)
    assert b0["tokens"].shape == (2, 16)
    assert not np.array_equal(b0["tokens"], b1["tokens"])
    full = FederatedDataLoader(plane, spec, 4, 16, site="pod0",
                               worker=2).batch(0)
    np.testing.assert_array_equal(
        np.concatenate([b0["tokens"], b1["tokens"]]), full["tokens"])


def test_bare_client_is_wrapped_with_a_warning():
    """The deprecation shim: a bare ``StashClient`` becomes a
    ``ClientPlane`` with a ``DeprecationWarning``, and reads the same
    batch as the plane path."""
    fed, spec = _stack()
    with pytest.warns(DeprecationWarning, match="DataPlane"):
        loader = FederatedDataLoader(fed.client("pod0", 0), spec,
                                     global_batch=4, seq_len=16)
    assert isinstance(loader.plane, ClientPlane)
    b = loader.batch(0)
    fed2, spec2 = _stack()
    want = FederatedDataLoader(AnalyticPlane(fed2), spec2, 4, 16,
                               site="pod0").batch(0)
    np.testing.assert_array_equal(b["tokens"], want["tokens"])
    assert loader.stats.fetches > 0


def test_a_plane_without_bytes_is_refused():
    """A plane that returns no bytes (the simulated engine's) raises: the
    loader needs a byte-bearing plane."""
    fed, spec = _stack()
    plane = AnalyticPlane(fed)
    real_fetch = plane.fetch
    plane.fetch = lambda req: dataclasses.replace(real_fetch(req), data=None)
    loader = FederatedDataLoader(plane, spec, 4, 16, site="pod0")
    with pytest.raises(RuntimeError, match="byte-bearing"):
        loader.batch(0)
