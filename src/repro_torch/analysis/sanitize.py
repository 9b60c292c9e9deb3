"""Determinism sanitizer: replay-twice byte equality for both engines.

The static checkers (``repro_torch.analysis.checkers``) prove the *code*
keeps its invariants; this module proves the *runtime* does.  Three
properties, all cheap enough for per-push CI:

1. **Double replay** — the same seeded :class:`ScenarioSpec` executed
   twice on the same engine must produce byte-identical reports
   including the per-request result rows *in order* (the event
   ordering of the run).  Any drift means hidden global state: an
   unseeded RNG, a shared mutable default, dict-order dependence.

2. **Engine coverage** — property 1 holds on both the analytic and
   the simulated engine, for a scenario family that exercises storms,
   Zipf traces, and outage schedules.

3. **Insertion-order independence** — the fluid-flow simulator
   coalesces same-timestamp events into one waterfill solve;
   that coalescing must not depend on the order the events were
   *inserted*.  We materialize a same-timestamp storm workload,
   shuffle the request list with a seeded RNG, and require the
   canonical (order-normalized) report — totals, ``sim_seconds``,
   solver telemetry, and every per-request row keyed by identity — to
   be byte-identical to the unshuffled run.

The simulated specs run their max-min solver on ``device`` (``None``
means ``cuda``, which raises without a card).  Run it::

    PYTHONPATH=src python -m repro_torch.analysis.sanitize          # full
    PYTHONPATH=src python -m repro_torch.analysis.sanitize --quick  # CI smoke
    PYTHONPATH=src python -m repro_torch.analysis.sanitize --quick --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import random
import sys
from typing import Dict, List, Optional, Sequence, Tuple

from ..core import (
    FederationSpec,
    OutageSchedule,
    ScenarioSpec,
    WorkloadSpec,
    run_scenario,
)

__all__ = [
    "SanitizeFailure",
    "canonical_report_bytes",
    "check_double_replay",
    "check_shuffled_insertion",
    "default_specs",
    "run_sanitizer",
]


class SanitizeFailure(AssertionError):
    """A determinism property failed; the message carries the first
    differing field so the drift is debuggable without a bisect."""


def _encode(obj) -> bytes:
    return json.dumps(obj, sort_keys=True, separators=(",", ":"),
                      default=str).encode()


def canonical_report_bytes(rep, ordered: bool = True) -> bytes:
    """Serialize a :class:`ScenarioReport` deterministically.

    ``ordered=True`` keeps the per-request rows in execution order —
    the event ordering of the run, which double replay must reproduce
    exactly.  ``ordered=False`` sorts rows by request identity
    (path, site, worker, start time) for comparisons across runs that
    legitimately permute *insertion* order.
    """
    d = dataclasses.asdict(rep)
    rows = d.pop("results")
    if not ordered:
        rows = sorted(rows, key=lambda r: _encode(r))
    d["results"] = rows
    return _encode(d)


def close_reports(got, want, rtol: float, path: str = "") -> None:
    """Hold two report dicts (``dataclasses.asdict`` of a report) to
    each other: every int, str and bool equal, every float within
    ``rtol`` relative.  Raises ``AssertionError`` at the first field
    that differs."""
    if type(got) is not type(want):
        raise AssertionError(f"{path}: {got!r} vs {want!r}")
    if isinstance(want, dict):
        if sorted(got) != sorted(want):
            raise AssertionError(f"{path}: keys differ")
        for k in want:
            close_reports(got[k], want[k], rtol, f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        if len(got) != len(want):
            raise AssertionError(f"{path}: {len(got)} vs {len(want)} items")
        for i, (g, w) in enumerate(zip(got, want)):
            close_reports(g, w, rtol, f"{path}[{i}]")
    elif isinstance(want, float):
        if not math.isclose(got, want, rel_tol=rtol, abs_tol=1e-12):
            raise AssertionError(f"{path}: {got!r} vs {want!r}")
    elif got != want:
        raise AssertionError(f"{path}: {got!r} vs {want!r}")


def _first_diff(a: bytes, b: bytes) -> str:
    if len(a) != len(b):
        note = f"lengths differ ({len(a)} vs {len(b)}); "
    else:
        note = ""
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            lo, hi = max(0, i - 60), i + 60
            return (f"{note}first divergence at byte {i}: "
                    f"...{a[lo:hi]!r} vs ...{b[lo:hi]!r}")
    return note + "one serialization is a prefix of the other"


def check_double_replay(spec: ScenarioSpec) -> Dict[str, int]:
    """Run ``spec`` twice from scratch; byte-identical or raise."""
    rep1 = run_scenario(spec)
    rep2 = run_scenario(spec)
    b1 = canonical_report_bytes(rep1, ordered=True)
    b2 = canonical_report_bytes(rep2, ordered=True)
    if b1 != b2:
        raise SanitizeFailure(
            f"double replay of {spec.name!r} on engine={spec.engine!r} "
            f"diverged — hidden global state in the {spec.engine} path: "
            f"{_first_diff(b1, b2)}")
    return {"requests": len(rep1.results), "bytes": len(b1)}


def check_shuffled_insertion(spec: ScenarioSpec, seed: int = 0,
                             rounds: int = 3) -> Dict[str, int]:
    """Same-timestamp insertion-order independence on the simulator.

    Materializes the spec's workload into an explicit request list,
    then runs ``rounds`` seeded shuffles of that list and requires the
    order-normalized report bytes to match the unshuffled run — the
    coalesced solve must not care who arrived first *in the queue*
    when everyone arrived at the same simulated instant.
    """
    if spec.engine != "sim":
        raise ValueError("shuffled-insertion check drives the simulator; "
                         f"got engine={spec.engine!r}")
    fed = spec.federation.build()
    reqs = spec.requests(fed)
    stamps = {r.at for r in reqs}
    if len(stamps) >= len(reqs):
        raise ValueError(
            f"workload of {spec.name!r} has no same-timestamp requests "
            f"({len(reqs)} requests, {len(stamps)} distinct timestamps) — "
            f"the shuffle would prove nothing")
    base_spec = dataclasses.replace(spec, workload=tuple(reqs))
    want = canonical_report_bytes(run_scenario(base_spec), ordered=False)
    rng = random.Random(seed)
    for rnd in range(rounds):
        shuffled = list(reqs)
        rng.shuffle(shuffled)
        got = canonical_report_bytes(
            run_scenario(dataclasses.replace(spec,
                                             workload=tuple(shuffled))),
            ordered=False)
        if got != want:
            raise SanitizeFailure(
                f"shuffled insertion round {rnd} of {spec.name!r} "
                f"diverged — same-timestamp coalescing is insertion-"
                f"order dependent: {_first_diff(want, got)}")
    return {"requests": len(reqs), "rounds": rounds,
            "timestamps": len(stamps)}


def default_specs(quick: bool = False,
                  device: Optional[str] = None) -> List[ScenarioSpec]:
    """The sanitized scenario family: storm (same-timestamp fan-in),
    Zipf trace (seeded randomness), storm+outages (coalescing under a
    schedule) — each on both engines, the simulator's on ``device``."""
    pods, hosts, n_req = (1, 4, 40) if quick else (2, 8, 160)
    fed = FederationSpec.fleet(num_pods=pods, hosts_per_pod=hosts)
    caches = [f"pod{p}/cache" for p in range(pods)]
    storm = WorkloadSpec(kind="storm", path="/ckpt/step/params",
                         size=int(2e8), workers_per_site=hosts)
    zipf = WorkloadSpec(kind="zipf", n_requests=n_req, working_set=16,
                        seed=7)
    specs: List[ScenarioSpec] = []
    for engine in ("analytic", "sim"):
        specs.append(ScenarioSpec(name="sanitize-storm", federation=fed,
                                  workload=storm, engine=engine,
                                  device=device))
        specs.append(ScenarioSpec(name="sanitize-zipf", federation=fed,
                                  workload=zipf, engine=engine,
                                  device=device))
        specs.append(ScenarioSpec(
            name="sanitize-storm-outage", federation=fed, workload=storm,
            engine=engine, device=device,
            outages=OutageSchedule.restart_storm(caches, at=5.0,
                                                 downtime=10.0)))
    return specs


def run_sanitizer(quick: bool = False,
                  specs: Optional[Sequence[ScenarioSpec]] = None,
                  device: Optional[str] = None
                  ) -> List[Tuple[str, str, Dict[str, int]]]:
    """Run every check; returns ``(check, scenario, stats)`` rows or
    raises :class:`SanitizeFailure` on the first drift.  ``device``
    applies to the default specs."""
    rows: List[Tuple[str, str, Dict[str, int]]] = []
    for spec in (specs if specs is not None
                 else default_specs(quick, device=device)):
        stats = check_double_replay(spec)
        rows.append(("double-replay", f"{spec.name}/{spec.engine}", stats))
        if spec.engine == "sim" and spec.outages is None \
                and isinstance(spec.workload, WorkloadSpec) \
                and spec.workload.kind == "storm":
            stats = check_shuffled_insertion(spec, seed=13,
                                             rounds=2 if quick else 4)
            rows.append(("shuffled-insertion", spec.name, stats))
    return rows


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch.analysis.sanitize",
        description="determinism sanitizer: double-replay byte equality "
                    "on both engines + shuffled same-timestamp insertion")
    ap.add_argument("--quick", action="store_true",
                    help="small federation / short traces (CI smoke)")
    ap.add_argument("--device", default=None,
                    help="the simulator's device (default: cuda)")
    args = ap.parse_args(argv)
    try:
        rows = run_sanitizer(quick=args.quick, device=args.device)
    except SanitizeFailure as exc:
        print(f"FAIL: {exc}", file=sys.stderr)
        return 1
    for check, scenario, stats in rows:
        detail = ", ".join(f"{k}={v}" for k, v in stats.items())
        print(f"ok {check:<20} {scenario:<28} {detail}")
    print(f"sanitizer: {len(rows)} determinism checks passed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
