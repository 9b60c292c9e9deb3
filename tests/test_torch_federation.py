"""The port's federation (``repro_torch.core``) against the reference's.

The federation's state machines are exact: digests, ring placement,
cache rankings, eviction order, the writeback queue and every report
counter must equal the reference's.  Inputs are made from seeds (numpy
or the modules' own seeded generators).  The scenario family
(``test_torch_fed_family.py``) runs here on the analytic engine, whose
``canonical_report_bytes`` must be equal byte for byte; the simulated
engine's cases are in ``test_torch_simulator.py``.  No field of a report
names its package, so the bytes are compared as they are.

JAX is imported through the ``ref`` fixture (the reference's package
imports it), so that on the machine with the card, which has no JAX,
the port's own tests still run.
"""
import dataclasses
import random

import numpy as np
import pytest

import repro_torch.core as T
from repro_torch.analysis.sanitize import canonical_report_bytes

import test_torch_fed_family as fam


@pytest.fixture(scope="module")
def ref():
    pytest.importorskip("jax", reason="the JAX reference is not installed")
    import repro.core
    return repro.core


@pytest.fixture(scope="module")
def ref_bytes(ref):
    from repro.analysis.sanitize import canonical_report_bytes as cb
    return cb


# ---------------------------------------------------------------------------
# Chunks, digests, the ring and rankings
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", [0, 1, 7, 4096, 100_003])
def test_fnv1a64_and_chunking_equal(ref, n):
    data = np.random.default_rng(n).integers(0, 256, n, np.uint8).tobytes()
    assert T.fnv1a64(data) == ref.fnv1a64(data)
    assert T.fnv1a64(data, seed=12345) == ref.fnv1a64(data, seed=12345)
    for chunk in (1000, 4096, T.DEFAULT_CHUNK_SIZE):
        meta, payloads = T.chunk_object("/d/f", data, chunk_size=chunk)
        want_meta, want_payloads = ref.chunk_object("/d/f", data,
                                                    chunk_size=chunk)
        assert dataclasses.asdict(meta) == dataclasses.asdict(want_meta)
        assert [(p.digest, p.size, p.data) for p in payloads] == \
            [(p.digest, p.size, p.data) for p in want_payloads]
        assert [dataclasses.asdict(r) for r in meta.chunk_refs()] == \
            [dataclasses.asdict(r) for r in want_meta.chunk_refs()]
    meta, _ = T.synthetic_object("/s", 3 * n + 1, chunk_size=4096)
    want, _ = ref.synthetic_object("/s", 3 * n + 1, chunk_size=4096)
    assert dataclasses.asdict(meta) == dataclasses.asdict(want)


def test_ring_placement_and_failover_order(ref):
    members = [f"pod{i}/cache{j}" for i in range(6) for j in range(3)]
    ring, want = T.HashRing(members), ref.HashRing(members)
    keys = [f"/data/{i}/file{i * 7919 % 1000}" for i in range(400)]
    for key in keys:
        assert ring.owner(key) == want.owner(key)
        assert ring.successors(key) == want.successors(key)
    for gone in members[::4]:
        ring.remove(gone)
        want.remove(gone)
    ring.add("late/cache")
    want.add("late/cache")
    assert [ring.successors(k, 3) for k in keys] == \
        [want.successors(k, 3) for k in keys]


@pytest.mark.parametrize("ranking", ["static", "probe"])
def test_ranked_caches_order(ref, ranking):
    """Every worker's ranking for many paths, with groups of 2 replicas,
    a dead member, and (``probe``) latency observations fed in."""
    def ranked(core):
        fed = core.FederationSpec.osg(workers_per_site=2,
                                      cache_replicas=2).build()
        groups = list(fed.groups.values())
        next(iter(fed.caches.values())).available = False
        policy = core.make_ranking_policy(ranking)
        rng = random.Random(0)
        out = []
        for name in sorted(fed.caches):
            policy.observe(name, rng.uniform(0.01, 2.0))
        for site in sorted(s.name for s in fed.sites):
            node = fed.client(site, 1).node.name
            for i in range(30):
                out.append([c.name for c in core.ranked_caches(
                    node, fed.caches, groups, fed.geoip, policy=policy,
                    path=f"/osg/{site}/{i}", limit=None if i % 2 else 3)])
            out.append([c.name for c in core.ranked_caches(
                node, fed.caches, [], fed.geoip, policy=policy)])
        return out, {g: dataclasses.asdict(fed.groups[g].stats)
                     for g in fed.groups}
    assert ranked(T) == ranked(ref)


# ---------------------------------------------------------------------------
# Eviction and the writeback queue
# ---------------------------------------------------------------------------
def _eviction_trace(core, policy: str):
    topo = core.Topology()
    topo.add_site("s")
    node = topo.add_node("c", core.Coord("s"), 1e10)
    cache = core.CacheServer("c", node, 12_000, policy=policy,
                             ttl_seconds=40.0)
    victims = []
    remove = cache._remove

    def spy(key):
        victims.append(key)
        return remove(key)
    cache._remove = spy
    trace = core.generate_workload(["s"], 400, duration=400.0, seed=11,
                                   working_set=30, zipf_a=1.1)
    hits = []
    for req in trace:
        cache.tick(req.time)
        size = 500 + req.size % 2500
        if cache.lookup(req.path, 0) is not None:
            hits.append(True)
            continue
        hits.append(False)
        cache.admit(req.path, 0, core.Payload.synthetic(size, req.path, 0),
                    object_size=size)
    return victims, hits, dataclasses.asdict(cache.stats), \
        sorted(cache._lru)


@pytest.mark.parametrize("policy", sorted(T.EVICTION_POLICIES))
def test_eviction_sequence_equal(ref, policy):
    assert sorted(T.EVICTION_POLICIES) == sorted(ref.EVICTION_POLICIES)
    got = _eviction_trace(T, policy)
    assert got[2]["evictions"] > 20
    assert got == _eviction_trace(ref, policy)


def test_writeback_queue_equal(ref):
    def run(core):
        fed = core.FederationSpec.osg().build()
        wb = fed.writeback("nebraska/cache", drain_rate=5e7)
        wb.max_inflight = 2
        node = fed.client("nebraska", 0).node.name
        log = []
        for i in range(7):
            data = (bytes([i]) * (30_000 + 997 * i) if i % 2
                    else 2_000_000 * (i + 1))
            meta, st = wb.write(node, f"/nova/out/{i}", data)
            log.append((meta.size, meta.chunk_digests, st.bytes, st.seconds))
        log.append(wb.dirty_paths())
        for budget in (3, None):
            st = wb.drain(max_objects=budget)
            log.append((st.bytes, st.seconds, st.chunks, wb.dirty_paths()))
        log.append(dataclasses.asdict(wb.stats))
        log.append(sorted(o.name for o in fed.origins
                          if o.has("/nova/out/3")))
        return log
    assert run(T) == run(ref)


# ---------------------------------------------------------------------------
# Scenarios on the analytic engine
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", fam.CASES, ids=lambda c: c.id)
def test_analytic_scenario_report_equal(ref, ref_bytes, case):
    got = T.run_scenario(fam.spec(T, case, "analytic"))
    want = ref.run_scenario(fam.spec(ref, case, "analytic"))
    assert len(got.results) == len(want.results) > 0
    assert canonical_report_bytes(got) == ref_bytes(want)


def test_from_model_config_equal(ref):
    from repro.configs import get_config as ref_config

    from repro_torch.configs import get_config
    for name in ("gemma2-2b", "mamba2-780m", "mixtral-8x22b"):
        cfg, want_cfg = get_config(name), ref_config(name)
        assert cfg.param_count() == want_cfg.param_count()
        assert cfg.active_param_count() == want_cfg.active_param_count()
        for kind in ("restart", "serve", "dataloader"):
            got = T.WorkloadSpec.from_model_config(cfg, kind,
                                                   workers_per_site=2)
            want = ref.WorkloadSpec.from_model_config(want_cfg, kind,
                                                      workers_per_site=2)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
            assert got.object_bytes() == want.object_bytes()


def test_sanitizer_quick_passes_on_the_cpu():
    from repro_torch.analysis.sanitize import run_sanitizer
    rows = run_sanitizer(quick=True, device="cpu")
    assert [r[0] for r in rows].count("double-replay") == 6
    assert any(r[0] == "shuffled-insertion" for r in rows)


def test_sanitizer_catches_hidden_state(monkeypatch):
    """The double-replay check must fail when a run leaks state into the
    next: here the workload seed drifts between the two runs."""
    from repro_torch.analysis import sanitize
    spec = T.ScenarioSpec(
        name="drift", federation=T.FederationSpec.fleet(1, 4),
        workload=T.WorkloadSpec(kind="zipf", n_requests=20, seed=0),
        engine="analytic")
    calls = []
    run = sanitize.run_scenario

    def drifting(s):
        calls.append(1)
        return run(dataclasses.replace(
            s, workload=dataclasses.replace(s.workload, seed=len(calls))))
    monkeypatch.setattr(sanitize, "run_scenario", drifting)
    with pytest.raises(sanitize.SanitizeFailure):
        sanitize.check_double_replay(spec)


def test_exports_match_the_reference(ref):
    """The port exports what the reference's ``core`` exports, except the
    planner's and the sweeps' names, which are not ported yet."""
    not_ported = {"PlannerSpec", "PlanReport", "apply_capacities",
                  "groups_for_federation", "plan_capacity", "predict",
                  "verify_plan", "SweepCell", "SweepReport", "SweepSpec",
                  "run_sweep", "planner"}
    want = {n for n in ref.__all__ if n not in not_ported}
    assert want - set(T.__all__) == set()
