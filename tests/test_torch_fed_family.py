"""The scenario family the port's federation is held to, built in either
package (``repro.core`` or ``repro_torch.core``) from the same knobs.
A helper module: it holds no test of its own.

Federations: the paper's OSG deployment, a 4-pod fleet (also with
small LFU caches that evict) and a 2-region OSDF tier.  Workloads:
``zipf``, ``storm``, ``herd``, ``flash_crowd`` and ``restart``, some
under an ``OutageSchedule`` or a ``ControlPlaneSpec``.
Shared by ``test_torch_federation.py`` (the analytic engine) and
``test_torch_simulator.py`` (the simulated engine, both solvers).
"""
import dataclasses


def federation(core, kind: str):
    if kind == "osg":
        return core.FederationSpec.osg(workers_per_site=2)
    if kind == "fleet":
        return core.FederationSpec.fleet(num_pods=4, hosts_per_pod=4)
    if kind == "fleet_small":          # caches that evict (LFU, 3 GB)
        return core.FederationSpec.fleet(num_pods=4, hosts_per_pod=4,
                                         cache_capacity=3e9,
                                         eviction_policy="lfu")
    return core.FederationSpec.osdf(regions=("us-east", "us-west"),
                                    edges_per_region=2, workers_per_edge=2)


def workload(core, kind: str, fed_kind: str):
    per_site = 4 if fed_kind.startswith("fleet") else 2
    if kind == "zipf":
        return core.WorkloadSpec(kind="zipf", n_requests=48, working_set=24,
                                 duration=600.0, seed=3)
    if kind == "storm":
        return core.WorkloadSpec(kind="storm", size=int(2e9),
                                 workers_per_site=per_site, jitter=2.0,
                                 seed=5)
    if kind == "herd":
        return core.WorkloadSpec(kind="herd", size=int(5e8), waves=2,
                                 wave_gap=20.0, n_objects=2,
                                 workers_per_site=per_site, jitter=1.0,
                                 seed=2)
    if kind == "flash_crowd":
        return core.WorkloadSpec(kind="flash_crowd", n_requests=48,
                                 working_set=24, duration=600.0,
                                 size=int(4e8), n_objects=2, crowd_at=60.0,
                                 crowd_duration=120.0, seed=4)
    return core.WorkloadSpec(kind="restart", path="/ckpt/m/step_00000100",
                             total_bytes=int(6e9), n_objects=6,
                             workers_per_site=2, tp_degree=2, jitter=0.5,
                             seed=1)


@dataclasses.dataclass(frozen=True)
class Case:
    fed: str
    work: str
    outage: str = ""        # "" | "storm" (cold restarts) | "rolling"
    control: bool = False

    @property
    def id(self) -> str:
        extra = (f"-{self.outage}-outage" if self.outage else "") + \
            ("-control" if self.control else "")
        return f"{self.fed}-{self.work}{extra}"


CASES = [
    Case("osg", "zipf"), Case("osg", "storm"), Case("osg", "herd"),
    Case("osg", "flash_crowd"), Case("osg", "restart"),
    Case("fleet", "storm"), Case("fleet", "zipf"), Case("fleet", "restart"),
    Case("fleet", "storm", outage="storm"),
    Case("fleet", "zipf", control=True),
    Case("fleet", "herd", outage="rolling", control=True),
    Case("fleet_small", "zipf"), Case("fleet_small", "herd"),
    Case("osdf", "zipf"), Case("osdf", "storm"), Case("osdf", "herd"),
    Case("osdf", "flash_crowd", outage="storm"),
]


def outages(core, fed_spec, kind: str):
    if not kind:
        return None
    caches = sorted(fed_spec.build().caches)
    if kind == "storm":
        return core.OutageSchedule.restart_storm(caches[:2], at=1.0,
                                                 downtime=4.0)
    return core.OutageSchedule.rolling_upgrade(caches, start=2.0,
                                               downtime=3.0, gap=5.0)


def spec(core, case: Case, engine: str, solver: str = "auto", **extra):
    fed = federation(core, case.fed)
    control = (core.ControlPlaneSpec(max_concurrent=2, queue_depth=3,
                                     tenant_quota=0.5)
               if case.control else None)
    return core.ScenarioSpec(
        name=case.id, federation=fed,
        workload=workload(core, case.work, case.fed),
        outages=outages(core, fed, case.outage), engine=engine,
        solver=solver, control=control, **extra)
