"""Workload generation from the paper's production measurements.

Table 2 gives the file-size percentiles of six months of StashCache
monitoring (Oct 2018 – Apr 2019); the evaluation dataset is one file per
percentile plus a forward-looking 10 GB probe.  Table 1 gives the byte mix
by experiment, which we reuse for utilisation benchmarks.
"""
from __future__ import annotations

import bisect
import dataclasses
import random
from typing import Dict, List, Sequence, Tuple

KB = 1000
MB = 1000**2
GB = 1000**3
TB = 1000**4
PB = 1000**5

# Paper Table 2: StashCache file-size percentiles.
FILESIZE_PERCENTILES: List[Tuple[int, int]] = [
    (1, int(5.797 * KB)),
    (5, int(22.801 * MB)),
    (25, int(170.131 * MB)),
    (50, int(467.852 * MB)),
    (75, int(493.337 * MB)),
    (95, int(2.335 * GB)),
    (99, int(2.335 * GB)),
]

# The forward-looking large-file probe used throughout §4.1/§5.
PROBE_10GB = 10 * GB

# Paper Table 1: top StashCache users over 6 months (bytes moved).
USAGE_BY_EXPERIMENT: Dict[str, int] = {
    "osg-gravitational-wave": int(1.079 * PB),
    "des": int(709.051 * TB),
    "minerva": int(514.794 * TB),
    "ligo": int(228.324 * TB),
    "continuous-testing": int(184.773 * TB),
    "nova": int(24.317 * TB),
    "lsst": int(18.966 * TB),
    "bioinformatics": int(17.566 * TB),
    "dune": int(11.677 * TB),
}

# Paper Table 3: measured %Δ download time (StashCache vs HTTP proxy);
# negative = StashCache faster.  Used to validate our simulator's signs.
PAPER_TABLE3: Dict[str, Dict[str, float]] = {
    "bellarmine": {"2.3GB": -68.5, "10GB": -10.0},
    "syracuse": {"2.3GB": +0.9, "10GB": -26.3},
    "colorado": {"2.3GB": +506.5, "10GB": +245.9},
    "nebraska": {"2.3GB": -12.1, "10GB": -2.1},
    "chicago": {"2.3GB": +30.6, "10GB": -7.7},
}


def evaluation_fileset(include_probe: bool = True) -> List[Tuple[str, int]]:
    """One test file per distinct percentile (the paper skipped the 99th
    because it equals the 95th) plus the 10 GB probe."""
    files: List[Tuple[str, int]] = []
    seen = set()
    for pct, size in FILESIZE_PERCENTILES:
        if size in seen:
            continue
        seen.add(size)
        files.append((f"/testing/percentile_p{pct:02d}", size))
    if include_probe:
        files.append(("/testing/probe_10gb", PROBE_10GB))
    return files


class PercentileSampler:
    """Sample file sizes from the piecewise-linear Table 2 distribution."""

    def __init__(self, seed: int = 0) -> None:
        self._rng = random.Random(seed)
        pts = [(0.0, 512.0)] + [(p / 100.0, float(s))
                                for p, s in FILESIZE_PERCENTILES]
        pts.append((1.0, float(PROBE_10GB)))
        self._ps = [p for p, _ in pts]
        self._ss = [s for _, s in pts]

    def sample(self) -> int:
        u = self._rng.random()
        i = bisect.bisect_right(self._ps, u) - 1
        i = min(i, len(self._ps) - 2)
        p0, p1 = self._ps[i], self._ps[i + 1]
        s0, s1 = self._ss[i], self._ss[i + 1]
        frac = (u - p0) / (p1 - p0) if p1 > p0 else 0.0
        # Log-linear interpolation: sizes span 7 decades.
        import math
        return max(1, int(math.exp(math.log(max(s0, 1.0)) * (1 - frac)
                                   + math.log(max(s1, 1.0)) * frac)))


@dataclasses.dataclass
class AccessRequest:
    """One client file access in a generated workload."""

    time: float
    site: str
    worker: int
    path: str
    size: int
    experiment: str
    tenant: str = ""  # fair-share accounting unit; defaults to experiment


def split_bytes(total: int, n: int) -> List[int]:
    """``n`` shard sizes summing *exactly* to ``total`` (the remainder is
    spread one byte each over the first ``total % n`` shards) — the
    canonical sizing every model-traffic generator uses, so request sizes
    always reconcile against the checkpoint/dataset byte total."""
    if n <= 0:
        raise ValueError(f"need at least one shard, got {n}")
    base, rem = divmod(int(total), n)
    return [base + (1 if i < rem else 0) for i in range(n)]


def checkpoint_restart_workload(sites: Sequence[str], prefix: str,
                                total_bytes: int, n_shards: int,
                                workers_per_site: int = 1,
                                tp_degree: int = 1,
                                at: float = 0.0, jitter: float = 0.0,
                                seed: int = 0,
                                manifest_bytes: int = 64 * KB,
                                tenant: str = "restart"
                                ) -> List[AccessRequest]:
    """A training restart storm over a *sharded* checkpoint.

    After a preemption every worker re-fetches the shard manifest, then
    the parameter shards its model-parallel rank owns (shard ``i`` is
    owned by rank ``i % tp_degree``; worker ``w`` holds rank
    ``w % tp_degree``).  With ``tp_degree=1`` every worker re-reads the
    whole checkpoint — the classic every-pod-refetches-a-33B-checkpoint
    storm; with ``tp_degree=k`` each shard is pulled ``workers/k`` times
    per site, the fan-in a pod cache collapses to one origin read.
    """
    if tp_degree <= 0:
        raise ValueError(f"tp_degree must be positive, got {tp_degree}")
    rng = random.Random(seed)
    sizes = split_bytes(total_bytes, n_shards)
    out: List[AccessRequest] = []
    for s in sites:
        for w in range(workers_per_site):
            t = at + (rng.uniform(0.0, jitter) if jitter > 0 else 0.0)
            out.append(AccessRequest(
                time=t, site=s, worker=w,
                path=f"{prefix}/manifest.json", size=manifest_bytes,
                experiment="checkpoint-restart", tenant=tenant))
            rank = w % tp_degree
            for i in range(rank, n_shards, tp_degree):
                out.append(AccessRequest(
                    time=t, site=s, worker=w,
                    path=f"{prefix}/shard_{i:05d}", size=sizes[i],
                    experiment="checkpoint-restart", tenant=tenant))
    out.sort(key=lambda r: r.time)
    return out


def shard_serving_workload(sites: Sequence[str], prefix: str,
                           total_bytes: int, n_shards: int,
                           n_requests: int = 256,
                           duration: float = 3600.0,
                           zipf_a: float = 1.2, seed: int = 0,
                           tenant: str = "serving"
                           ) -> List[AccessRequest]:
    """Model-shard serving traffic: Zipf-popular reads over the shards of
    one model (hot layers / embedding shards dominate), sized so the
    shard set sums exactly to the model's byte total."""
    rng = random.Random(seed)
    sizes = split_bytes(total_bytes, n_shards)
    ranks = [1.0 / (k + 1) ** zipf_a for k in range(n_shards)]
    site_list = list(sites)
    out: List[AccessRequest] = []
    for _ in range(n_requests):
        k = rng.choices(range(n_shards), weights=ranks)[0]
        out.append(AccessRequest(
            time=rng.uniform(0.0, duration),
            site=rng.choice(site_list),
            worker=rng.randrange(0, 1 << 16),
            path=f"{prefix}/shard_{k:05d}", size=sizes[k],
            experiment="shard-serving", tenant=tenant))
    out.sort(key=lambda r: r.time)
    return out


def dataloader_workload(sites: Sequence[str], prefix: str,
                        total_bytes: int, n_shards: int,
                        workers_per_site: int = 1, epochs: int = 1,
                        at: float = 0.0, step_gap: float = 1.0,
                        tenant: str = "dataloader"
                        ) -> List[AccessRequest]:
    """Sequential striped dataset reads: worker ``w`` of each site walks
    shards ``w, w+W, w+2W, ...`` in order (one shard per ``step_gap``
    seconds), so a site's workers collectively sweep the whole dataset
    once per epoch — the training data path's access pattern.
    Deterministic (no randomness): restart-safe like the loader itself."""
    sizes = split_bytes(total_bytes, n_shards)
    stride = max(workers_per_site, 1)
    per_worker = -(-n_shards // stride)  # ceil: epoch length in steps
    out: List[AccessRequest] = []
    for e in range(epochs):
        for s in sites:
            for w in range(workers_per_site):
                owned = range(w % stride, n_shards, stride)
                for k, i in enumerate(owned):
                    out.append(AccessRequest(
                        time=at + (e * per_worker + k) * step_gap,
                        site=s, worker=w,
                        path=f"{prefix}/shard_{i:05d}", size=sizes[i],
                        experiment="dataloader", tenant=tenant))
    out.sort(key=lambda r: r.time)
    return out


def storm_workload(sites: Sequence[str], path: str = "/ckpt/step/params",
                   size: int = 2 * GB, at: float = 0.0,
                   workers_per_site: int = 1, jitter: float = 0.0,
                   seed: int = 0) -> List[AccessRequest]:
    """A restart storm: every worker on every site requests the *same*
    object at (nearly) the same instant — the checkpoint fan-in that
    follows a preemption or rolling restart.  ``jitter`` spreads the
    arrivals uniformly over [at, at+jitter); zero keeps them exactly
    simultaneous, the worst case for the bandwidth solver."""
    rng = random.Random(seed)
    out = [AccessRequest(
        time=at + (rng.uniform(0.0, jitter) if jitter > 0 else 0.0),
        site=s, worker=w, path=path, size=size, experiment="restart-storm")
        for s in sites for w in range(workers_per_site)]
    out.sort(key=lambda r: r.time)
    return out


def generate_workload(sites: Sequence[str], n_requests: int,
                      duration: float = 3600.0, seed: int = 0,
                      working_set: int = 64,
                      zipf_a: float = 1.2,
                      tenants: Dict[str, float] = None
                      ) -> List[AccessRequest]:
    """A production-shaped trace: Table 2 sizes, Table 1 experiment mix,
    Zipf-popular working set (caching only helps if there is reuse).

    ``tenants`` optionally maps tenant name → weight; each request is
    then tagged with a tenant drawn from that mix (on a separate RNG
    stream so the trace itself is unchanged).  Without it the tenant
    defaults to the owning experiment downstream."""
    rng = random.Random(seed)
    sampler = PercentileSampler(seed)
    experiments = list(USAGE_BY_EXPERIMENT)
    weights = [USAGE_BY_EXPERIMENT[e] for e in experiments]
    # Working set: file k of an experiment has Zipf popularity ~ 1/k^a.
    files: List[Tuple[str, int, str]] = []
    for e in experiments:
        for k in range(working_set):
            files.append((f"/{e}/data/file_{k:04d}", sampler.sample(), e))
    ranks = [1.0 / (k + 1) ** zipf_a for k in range(working_set)]
    trng = random.Random(seed ^ 0x7E9A97) if tenants else None
    tnames = list(tenants) if tenants else []
    tweights = [tenants[t] for t in tnames] if tenants else []
    out: List[AccessRequest] = []
    for i in range(n_requests):
        e_idx = rng.choices(range(len(experiments)), weights=weights)[0]
        k = rng.choices(range(working_set), weights=ranks)[0]
        path, size, exp = files[e_idx * working_set + k]
        out.append(AccessRequest(
            time=rng.uniform(0.0, duration),
            site=rng.choice(list(sites)),
            worker=rng.randrange(0, 1 << 16),
            path=path, size=size, experiment=exp,
            tenant=trng.choices(tnames, weights=tweights)[0]
            if trng else ""))
    out.sort(key=lambda r: r.time)
    return out


def herd_workload(sites: Sequence[str], path: str = "/hot/object",
                  size: int = 2 * GB, at: float = 0.0,
                  workers_per_site: int = 1, jitter: float = 0.0,
                  n_objects: int = 1, waves: int = 1,
                  wave_gap: float = 30.0, seed: int = 0,
                  tenant: str = "herd") -> List[AccessRequest]:
    """Thundering herd: repeated synchronized waves of every worker
    hitting one hot object.  Unlike :func:`storm_workload` (one burst),
    the herd re-fires every ``wave_gap`` seconds for ``waves`` rounds,
    optionally rotating through ``n_objects`` distinct hot objects — the
    load shape that keeps an admission queue saturated rather than
    merely spiking it."""
    rng = random.Random(seed)
    out: List[AccessRequest] = []
    for wave in range(waves):
        p = (f"{path}_{wave % max(n_objects, 1):03d}"
             if n_objects > 1 else path)
        t0 = at + wave * wave_gap
        for s in sites:
            for w in range(workers_per_site):
                out.append(AccessRequest(
                    time=t0 + (rng.uniform(0.0, jitter) if jitter > 0
                               else 0.0),
                    site=s, worker=w, path=p, size=size,
                    experiment="thundering-herd", tenant=tenant))
    out.sort(key=lambda r: r.time)
    return out


def flash_crowd_workload(sites: Sequence[str], hot_sites: Sequence[str],
                         n_requests: int, duration: float = 3600.0,
                         seed: int = 0, working_set: int = 64,
                         zipf_a: float = 1.2,
                         crowd_factor: float = 3.0,
                         crowd_at: float = 0.0,
                         crowd_duration: float = 120.0,
                         hot_objects: int = 4,
                         hot_size: int = 493 * MB) -> List[AccessRequest]:
    """A regional flash crowd over a production-shaped background.

    The background is :func:`generate_workload` across every site; on
    top, the workers of ``hot_sites`` (one region's edge sites) fire
    ``crowd_factor × n_requests`` reads of a tiny ``hot_objects``-file
    set compressed into [``crowd_at``, ``crowd_at + crowd_duration``) —
    the release-day / trigger-alert shape where one region suddenly
    hammers a handful of objects.  In a tiered federation the first miss
    per edge fills the regional parent and every sibling edge then fills
    cache-to-cache, so origin egress stays near ``hot_objects ×
    hot_size`` instead of scaling with the crowd."""
    out = generate_workload(sites, n_requests, duration=duration,
                            seed=seed, working_set=working_set,
                            zipf_a=zipf_a)
    rng = random.Random(seed ^ 0xF1A54)
    hot_list = list(hot_sites)
    for _ in range(int(crowd_factor * n_requests)):
        k = rng.randrange(0, max(hot_objects, 1))
        out.append(AccessRequest(
            time=crowd_at + rng.uniform(0.0, crowd_duration),
            site=rng.choice(hot_list),
            worker=rng.randrange(0, 1 << 16),
            path=f"/flash/hot_{k:03d}", size=hot_size,
            experiment="flash-crowd", tenant="flash-crowd"))
    out.sort(key=lambda r: r.time)
    return out


def abusive_workload(sites: Sequence[str], n_requests: int,
                     duration: float = 3600.0, seed: int = 0,
                     working_set: int = 64, zipf_a: float = 1.2,
                     tenants: Dict[str, float] = None,
                     abusive_tenant: str = "abuser",
                     abuse_factor: float = 4.0,
                     abuse_at: float = 0.0,
                     abuse_duration: float = 60.0,
                     abuse_size: int = 512 * MB) -> List[AccessRequest]:
    """A well-behaved Zipf background trace plus one abusive tenant.

    The abuser fires ``abuse_factor × n_requests`` cache-busting reads
    (every path distinct, so each one misses) compressed into
    ``abuse_duration`` seconds — the workload whose damage per-tenant
    quotas exist to contain."""
    out = generate_workload(sites, n_requests, duration=duration,
                            seed=seed, working_set=working_set,
                            zipf_a=zipf_a, tenants=tenants)
    rng = random.Random(seed ^ 0xABB0)
    site_list = list(sites)
    for i in range(int(abuse_factor * n_requests)):
        out.append(AccessRequest(
            time=abuse_at + rng.uniform(0.0, abuse_duration),
            site=rng.choice(site_list),
            worker=rng.randrange(0, 1 << 16),
            path=f"/abuse/blob_{i:05d}", size=abuse_size,
            experiment=abusive_tenant, tenant=abusive_tenant))
    out.sort(key=lambda r: r.time)
    return out
