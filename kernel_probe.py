#!/usr/bin/env python3
"""Time four kernels of the port on synthetic inputs that isolate their
parts, and two of its paths, on one CUDA card:

    python3 kernel_probe.py [cache_sim] [fifo] [waterfill] [distances]
                            [paths] [plan] [--parent DIR]

(all six when none is named).

* ``sd_cache_sim`` over 8 problems of 32,768 steps (Kp 16,384, the
  ``smem`` design), LRU and FIFO: a stream that admits nothing, one that
  hits one key, one of distinct keys that never evicts, ones of unit
  sizes that evict one slot an insert, ones where every 64th key is 64
  times larger (walks of 64 slots, and inserts that need none), and a
  skewed stream of mixed sizes with hits and evictions both.  The steps
  without an eviction give a step's cost; the rest add a walk's.

* ``sd_fifo_replay`` over 64 problems of 16,384 steps (unit sizes, Kp
  16,384): a stream that admits nothing, one that hits one key, one of
  distinct keys that never evicts, and three that evict on every insert
  with the frontier 10, 1,000 and 6,000 steps behind the stream (the
  last beyond the kernel's shared history of 4,096 steps).  The steps
  without an eviction give a step's cost; the rest add a search's.
* ``maxmin_waterfill``: an all-padding problem (the launch, set-up and
  list building, no round), one like storm H's (512 flows over 487
  links, 4 links a flow) and one like sweep I's (5,500 flows over 20
  links), seeded random capacities; each launch alone through a CUDA
  graph of 20 launches.
* ``sd_distances`` on sweep I's largest bucket, recorded from a run of
  ``chip_smoke.py``'s sweep: a call through ``ops.stack_distances`` by
  CUDA events around a loop of 20 calls (as ``chip_smoke.py`` times it),
  in a CUDA graph of calls (the device alone), and the host's time of a
  call and of its C entry alone.  Then over 16 problems of 32,768
  references and 16 of 262,144, on four streams: every gap 32, every gap
  1,000, cyclic over N/2 keys (every gap N/2) and zipf (exponent 0.9 over
  N/2 keys), each key's size a random integer below 2^20 bytes, a call
  alone: in a CUDA graph of 20 calls, or, where one takes over 5 ms, by
  CUDA events around two after a warm-up.  With ``--parent DIR`` (an
  unpacked tree of another version of the port, ``DIR/src/repro_torch``),
  that version's ``ops.stack_distances`` is imported and built too and
  timed in turns with this one, old, new, new, old, on every case, and
  their distances must be equal.
* ``paths``: ``chip_smoke.py``'s storm H (250 pods, every solve on the
  card) and sweep I (32 cells, all batched) by the host's clock around
  the run, and ``maxmin_rates_sparse``'s whole call (packing, copies,
  launch and read) on a problem like storm H's (512 flows over 487
  links) by the host's clock around 200 calls, and the waterfill
  wrapper's design lookup (one ``ctypes`` call a solve) by the host's
  clock around 10,000 calls.  With ``--parent DIR``
  that tree's port runs the same in turns, old, new, new, old, and the
  counters of both versions must be equal.
* ``plan``: ``plan_solve`` at ``chip_smoke.py``'s J2 plan (28 caches x 64
  buckets, from its fit sweep) and on J2's models tiled to 252 caches:
  CUDA events around 20 calls and a CUDA graph of 20 launches.  With
  ``--parent DIR`` that tree's ``ops.plan_solve`` in turns, old, new,
  new, old, its outputs required equal bit for bit.

Prints one line a case with the card's name and power limit.  Imports
nothing of JAX.
"""
from __future__ import annotations

import importlib
import importlib.util
import pathlib
import sys
import time
from typing import Optional

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "src"))

from chip_smoke import card_label, graph_ms, time_ms  # noqa: E402
from repro_torch.kernels import maxmin, ops  # noqa: E402
from repro_torch.kernels import stack_distance as sd  # noqa: E402


def probe_cache_sim(card: str) -> None:
    dev = torch.device("cuda")
    num, n, kp = 8, 32768, 16384
    rng = np.random.default_rng(0)
    distinct = np.arange(n) % kp
    unit = np.ones(kp)
    bursts = np.where(np.arange(kp) % 64 == 63, 64.0, 1.0)
    weights = 1.0 / np.arange(1, kp + 1) ** 0.9
    skewed = rng.choice(kp, n, p=weights / weights.sum())
    mixed = rng.integers(1, 2000, kp).astype(np.float64)
    cases = [("admits nothing", distinct, unit, False, 1e18),
             ("hits one key", np.zeros(n), unit, True, 1e18),
             ("never evicts", distinct, unit, True, 1e18),
             ("evicts one slot an insert", distinct, unit, True, 1000.0),
             ("evicts in bursts of 64 slots", distinct, bursts, True,
              2000.0),
             ("skewed, mixed sizes", skewed, mixed, True, 2e6)]
    for label, keys, ksz, admit, cap in cases:
        for fifo in (False, True):
            args = (torch.tensor(np.tile(keys, (num, 1)), dtype=torch.int32,
                                 device=dev),
                    torch.full((num, n), admit, dtype=torch.bool,
                               device=dev),
                    torch.zeros(num, n, dtype=torch.bool, device=dev),
                    torch.tensor(np.tile(ksz, (num, 1)), dtype=torch.float64,
                                 device=dev),
                    torch.full((num,), cap, dtype=torch.float64, device=dev),
                    torch.full((num,), fifo, dtype=torch.bool, device=dev),
                    torch.full((num,), n, dtype=torch.int32, device=dev))
            ms = time_ms(lambda: ops.cache_sim(*args), 3)
            hits, ev, _ = ops.cache_sim(*args)
            print(f"cache_sim {'fifo' if fifo else 'lru'}, {label}: "
                  f"{ms:.4f} ms a launch, {1e3 * ms / n:.4f} us a step, "
                  f"{int(ev[0])} evictions and {int(hits[0].sum())} hits a "
                  f"problem  [{card}]", flush=True)


def probe_fifo(card: str) -> None:
    dev = torch.device("cuda")
    num, n, kp = 64, 16384, 16384
    distinct = np.arange(n) % kp
    cases = [("admits nothing", distinct, False, 1e18),
             ("hits one key", np.zeros(n), True, 1e18),
             ("never evicts", distinct, True, 1e18),
             ("evicts, frontier 10 steps behind", distinct, True, 10.0),
             ("evicts, frontier 1000 steps behind", distinct, True, 1000.0),
             ("evicts, frontier 6000 steps behind", distinct, True, 6000.0)]
    for label, keys, admit, cap in cases:
        args = (torch.tensor(np.tile(keys, (num, 1)), dtype=torch.int32,
                             device=dev),
                torch.ones(num, n, dtype=torch.float64, device=dev),
                torch.full((num, n), admit, dtype=torch.bool, device=dev),
                torch.zeros(num, n, dtype=torch.bool, device=dev),
                torch.zeros(num, kp, dtype=torch.float64, device=dev),
                torch.full((num,), cap, dtype=torch.float64, device=dev),
                torch.full((num,), n, dtype=torch.int32, device=dev))
        ms = time_ms(lambda: ops.fifo_replay(*args), 3)
        evictions = int(ops.fifo_replay(*args)[1][0])
        print(f"fifo_replay, {label}: {ms:.4f} ms a launch, "
              f"{1e3 * ms / n:.4f} us a step, {evictions} evictions a "
              f"problem  [{card}]", flush=True)


def probe_waterfill(card: str) -> None:
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    for label, flows, links, per_flow in (("all padding", 0, 500, 0),
                                          ("like storm H's", 512, 487, 4),
                                          ("like sweep I's", 5500, 20, 5)):
        caps = rng.uniform(1e8, 1e10, links).tolist()
        rows = [rng.choice(links, per_flow, replace=False).tolist()
                for _ in range(flows)]
        fcaps = rng.uniform(1e7, 5e9, flows).tolist()
        Fp, Lp = maxmin._next_pow2(flows), maxmin._next_pow2(links + 1)
        staging = maxmin.Staging(1, Fp, Lp, 8, dev)
        staging.caps.fill(np.inf)
        staging.ids.fill(Lp - 1)
        staging.fcaps.fill(0.0)
        if flows:
            maxmin.pad_problem(caps, rows, fcaps, Fp, Lp, 8,
                               out=staging.problem(0))
        args = staging.views(staging.upload())
        ms = graph_ms(lambda: maxmin.WATERFILL(*args))
        rounds = int(maxmin.WATERFILL(*args)[0, -1])
        print(f"maxmin_waterfill, {label} (Fp {Fp}, Lp {Lp}, width 8): "
              f"{ms:.4f} ms a launch (CUDA graph), {rounds} rounds  "
              f"[{card}]", flush=True)


def _prev(keys: np.ndarray) -> np.ndarray:
    """Each reference's previous reference to its key (-1: none)."""
    order = np.argsort(keys, kind="stable")
    prev = np.full(len(keys), -1, np.int64)
    same = keys[order[1:]] == keys[order[:-1]]
    prev[order[1:][same]] = order[:-1][same]
    return prev


def _ms(times) -> str:
    return ", ".join(f"{t:.4f}" for t in times)


def _call_ms(fn) -> float:
    """One call's device time: a CUDA graph of 20, or two calls between
    CUDA events after a warm-up where one takes over 5 ms."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    if start.elapsed_time(end) < 5.0:
        return graph_ms(fn)
    return time_ms(fn, 2)


def _host_us(fn, calls: int = 20) -> float:
    """The host's time of one call, µs: ``calls`` calls queued without a
    wait between them (the card runs behind)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e6 * (t1 - t0) / calls


def _parent_module(parent: str, name: str = "kernels.ops"):
    """The module ``name`` of the port in an unpacked tree ``DIR``
    (``DIR/src/repro_torch``), imported as a package of another name; its
    kernels build into that tree."""
    if "parent_repro_torch" not in sys.modules:
        root = pathlib.Path(parent).resolve() / "src" / "repro_torch"
        spec = importlib.util.spec_from_file_location(
            "parent_repro_torch", root / "__init__.py",
            submodule_search_locations=[str(root)])
        package = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = package
        spec.loader.exec_module(package)
    return importlib.import_module(f"parent_repro_torch.{name}")


def _recorded_bucket():
    """The inputs of sweep I's largest ``sd_distances`` call, recorded from
    a run of ``chip_smoke.py``'s sweep on the card."""
    import repro_torch.core as core
    from chip_smoke import _SweepRecorder, _largest, _sweep_spec
    with _SweepRecorder() as rec:
        core.run_sweep(_sweep_spec(core, None))
    torch.cuda.synchronize()
    return rec.calls["stack_distance"][_largest(rec, "stack_distance")][0]


def probe_distances(card: str, parent: Optional[str] = None) -> None:
    dev = torch.device("cuda")
    impls = {"new": ops.stack_distances}
    if parent:
        impls["old"] = _parent_module(parent).stack_distances
    order = ["old", "new", "new", "old"] if parent else ["new"]

    def same(outs, label):
        if parent and not torch.equal(outs["old"], outs["new"]):
            raise AssertionError(f"distances {label}: the two versions "
                                 f"differ")

    # sweep I's largest bucket, timed as chip_smoke.py times it (CUDA
    # events around a loop of 20 calls) and alone (a CUDA graph of calls)
    args = _recorded_bucket()
    label = (f"sweep I's largest bucket {tuple(args[0].shape)} "
             f"({int(args[-1].sum())} references)")
    times = {w: {"loop": [], "graph": [], "host": []} for w in impls}
    outs = {}
    for which in order:
        fn = impls[which]
        outs[which] = fn(*args)
        times[which]["loop"].append(time_ms(lambda: fn(*args), 20))
        times[which]["graph"].append(graph_ms(lambda: fn(*args)))
        times[which]["host"].append(_host_us(lambda: fn(*args)))
    same(outs, label)
    work = torch.empty(int(sd.LIB.load().sd_distances_work_bytes(
        *args[0].shape)), dtype=torch.uint8, device=dev)
    out = torch.empty(args[0].shape, dtype=torch.float64, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    entry = _host_us(lambda: sd.LIB.load().sd_distances(
        args[0].data_ptr(), args[1].data_ptr(), args[2].data_ptr(),
        *args[0].shape, work.data_ptr(), out.data_ptr(), stream))
    for which in impls:
        t = times[which]
        print(f"sd_distances, {label}, {which}: {_ms(t['loop'])} ms a call "
              f"by CUDA events around 20 calls; {_ms(t['graph'])} ms in a "
              f"CUDA graph of calls; host {_ms(t['host'])} us a call"
              + (f" (its C entry alone {entry:.1f} us)"
                 if which == "new" else "") + f"  [{card}]", flush=True)
    if parent:
        loop, graph = ({w: sum(times[w][kind]) for w in impls}
                       for kind in ("loop", "graph"))
        print(f"sd_distances, {label}: old / new by CUDA events around 20 "
              f"calls {loop['old'] / loop['new']:.2f}, in a CUDA graph "
              f"{graph['old'] / graph['new']:.2f}  [{card}]", flush=True)

    rng = np.random.default_rng(0)
    num = 16
    for n in (32768, 262144):
        weights = 1.0 / np.arange(1, n // 2 + 1) ** 0.9
        streams = [("every gap 32", [np.arange(n) % 32] * num),
                   ("every gap 1,000", [np.arange(n) % 1000] * num),
                   ("cyclic over N/2 keys", [np.arange(n) % (n // 2)] * num),
                   ("zipf 0.9 over N/2 keys",
                    [rng.choice(n // 2, n, p=weights / weights.sum())
                     for _ in range(num)])]
        for label, rows in streams:
            ksz = rng.integers(1, 1 << 20, n // 2).astype(np.float64)
            prev = torch.tensor(np.stack([_prev(r) for r in rows]),
                                device=dev)
            sizes = torch.tensor(np.stack([ksz[r % (n // 2)] for r in rows]),
                                 device=dev)
            lengths = torch.full((num,), n, dtype=torch.int32, device=dev)
            gaps = float((torch.arange(n, device=dev) - prev - 1)[prev >= 0]
                         .double().sum())
            times = {w: [] for w in impls}
            outs = {}
            for which in order:
                fn = impls[which]
                outs[which] = fn(prev, sizes, lengths)
                times[which].append(_call_ms(lambda: fn(prev, sizes,
                                                        lengths)))
            same(outs, f"{label}, {num} x {n}")
            line = (f"sd_distances, {label}, {num} x {n} ({gaps:.3e} gap "
                    f"references in all): new {_ms(times['new'])} ms")
            if parent:
                ratio = sum(times["old"]) / sum(times["new"])
                line += f"; old {_ms(times['old'])} ms; old / new {ratio:.2f}"
            print(f"{line}  [{card}]", flush=True)


def probe_paths(card: str, parent: Optional[str] = None) -> None:
    import repro_torch.core as core
    from chip_smoke import _storm_spec, _sweep_spec
    impls = {"new": (core, maxmin)}
    if parent:
        impls["old"] = (_parent_module(parent, "core"),
                        _parent_module(parent, "kernels.maxmin"))
    order = ["old", "new", "new", "old"] if parent else ["new"]
    rng = np.random.default_rng(0)
    caps = rng.uniform(1e8, 1e10, 487).tolist()
    rows = [rng.choice(487, 4, replace=False).tolist() for _ in range(512)]
    fcaps = rng.uniform(1e7, 5e9, 512).tolist()
    for c, _ in impls.values():                      # builds and warms
        c.run_scenario(_storm_spec(c, "vector", "cuda", pods=4))
        c.run_sweep(_sweep_spec(c, "cuda", n_requests=200))
    times = {w: {"storm": [], "sweep": [], "call": []} for w in impls}
    counters = {}
    for which in order:
        c, mm = impls[which]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rep = c.run_scenario(_storm_spec(c, "vector", "cuda"))
        times[which]["storm"].append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        sweep = c.run_sweep(_sweep_spec(c, None))
        torch.cuda.synchronize()
        times[which]["sweep"].append(time.perf_counter() - t0)
        times[which]["call"].append(_host_us(
            lambda: mm.maxmin_rates_sparse(caps, rows, fcaps, device="cuda"),
            200) / 1e3)
        counters[which] = ((rep.cache_hits, rep.cache_misses,
                            rep.origin_egress_bytes, rep.reallocations),
                           [cell.summary for cell in sweep.cells])
    if parent and counters["old"] != counters["new"]:
        raise AssertionError("paths: the two versions' counters differ")
    t0 = time.perf_counter()
    for _ in range(10000):
        maxmin.WATERFILL.design(512, 512, 8)
    lookup_us = 1e6 * (time.perf_counter() - t0) / 10000
    for which in impls:
        t = times[which]
        print(f"paths, {which}: storm H {_ms(t['storm'])} s, sweep I "
              f"{_ms(t['sweep'])} s (host clock around the run); "
              f"maxmin_rates_sparse like storm H's (512 flows, 487 links) "
              f"{_ms(t['call'])} ms a call (host clock, 200 calls)"
              + (f"; of it the waterfill wrapper's design lookup "
                 f"{lookup_us:.3f} us (host clock, 10,000 calls)"
                 if which == "new" else "") + f"  [{card}]", flush=True)
    if parent:
        ratio = {k: sum(times["old"][k]) / sum(times["new"][k])
                 for k in ("storm", "sweep", "call")}
        print(f"paths: old / new storm H {ratio['storm']:.3f}, sweep I "
              f"{ratio['sweep']:.3f}, the whole call {ratio['call']:.3f}; "
              f"counters equal  [{card}]", flush=True)


def probe_plan(card: str, parent: Optional[str] = None) -> None:
    import repro_torch.core as core
    from chip_smoke import PLAN_TARGET, PLAN_TILE, _osdf_spec, _plan_args
    impls = {"new": ops.plan_solve}
    if parent:
        impls["old"] = _parent_module(parent).plan_solve
    order = ["old", "new", "new", "old"] if parent else ["new"]
    base = _osdf_spec(core, "cuda")
    models = core.run_sweep(core.SweepSpec(name="j2", base=base, axes={}),
                            fit=True).fitted_models()
    spec = core.PlannerSpec(models=models, target_hit_rate=PLAN_TARGET,
                            groups=core.groups_for_federation(
                                base.federation.build(), models))
    for label, tiled in (("J2", 1), ("252 caches", PLAN_TILE)):
        args, _ = _plan_args(spec, tiled)
        times = {w: {"loop": [], "graph": []} for w in impls}
        outs = {}
        for which in order:
            fn = impls[which]
            outs[which] = fn(*args, spec.steps)
            times[which]["loop"].append(time_ms(lambda: fn(*args, spec.steps),
                                                20))
            times[which]["graph"].append(graph_ms(
                lambda: fn(*args, spec.steps)))
        if parent and not torch.equal(outs["old"], outs["new"]):
            raise AssertionError(f"plan_solve {label}: the two versions "
                                 f"differ")
        for which in impls:
            t = times[which]
            print(f"plan_solve, {label} ({args[0].shape[2]} caches), "
                  f"{which}: {_ms(t['loop'])} ms a call by CUDA events "
                  f"around 20 calls; {_ms(t['graph'])} ms in a CUDA graph "
                  f"of 20 launches  [{card}]", flush=True)
        if parent:
            loop = {w: sum(times[w]["loop"]) for w in impls}
            print(f"plan_solve, {label}: old / new "
                  f"{loop['old'] / loop['new']:.3f}; outputs equal  "
                  f"[{card}]", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_probe: no CUDA device", file=sys.stderr)
        return 1
    card = card_label()
    args = sys.argv[1:]
    parent = None
    if "--parent" in args:
        at = args.index("--parent")
        parent = args[at + 1]
        del args[at:at + 2]
    probes = {"cache_sim": probe_cache_sim, "fifo": probe_fifo,
              "waterfill": probe_waterfill,
              "distances": lambda c: probe_distances(c, parent),
              "paths": lambda c: probe_paths(c, parent),
              "plan": lambda c: probe_plan(c, parent)}
    for name in args or probes:
        probes[name](card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
