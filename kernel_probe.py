#!/usr/bin/env python3
"""Time the port's kernels on synthetic inputs that isolate their parts,
and two of its paths, on one CUDA card:

    python3 kernel_probe.py [cache_sim] [fifo] [waterfill] [distances]
                            [paths] [plan] [mix] [fnv] [train] [saturated]
                            [bwd] [ssm] [--parent DIR]

(all twelve when none is named).

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
  links, 4 links a flow), one like sweep I's (5,500 flows over 20 links,
  5 a flow; both on the design ``smem``), one like J2's pricing bucket
  (14,571 flows over 255 links, 8 a flow, design ``global``) and one of
  Fp 32768 (20,000 flows over 200 links, 8 a flow, design
  ``global_flows``), seeded random
  capacities; each launch alone through a CUDA graph of 20 launches.
  With ``--parent DIR`` that tree's kernel in turns, old, new, new, old,
  on every case it serves, its rates required equal.
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
  CUDA events around 20 calls and a CUDA graph of 20 launches, and the
  cluster it takes.  With ``--parent DIR`` that tree's ``ops.plan_solve``
  in turns, old, new, new, old, its outputs required equal bit for bit.
  Then, from the probe build (``PROBE_LIB``: the same source with
  ``-DCM_PROBE=1``, whose own entry points take a cluster size and an
  output for clock64() stamps between a stage's parts), the plan on
  every cluster size, the phase split of a stage, each with its outputs
  required equal to the ordinary build's, and the float64 instructions
  of the probe build's terms in its SASS (``cuobjdump -sass``) with the
  FP64 issue time they need.
* ``mix``: ``mixture_fit`` on one of J2's histograms, on all 28 in one
  launch, and J3's whole fit sweep (host clock, and CUDA events around
  its calls); with ``--parent DIR`` in turns, old, new, new, old, the
  fits and the sweep's models required equal bit for bit.  Then the
  probe build's phase split of a step and the SASS counts.

* ``fnv``: ``fnv1a64_chunks`` on a 24 MiB chunk and on an object of
  three chunks (the last 24 MiB - 1 B) of seeded random bytes: CUDA
  events around 20 calls (3 for a version over 50 ms a call); with
  ``--parent DIR`` that tree's ``ops.fnv1a64_chunks`` in turns, old,
  new, new, old, its digests required equal.  Then, from probe builds
  (the same source with ``-DFNV_PROBE=1``, whose ``fnv1a_stage_probe``
  launches one stage alone), the whole call and each stage of the split
  alone (a CUDA graph of 20 launches, so the host stays out) on both
  inputs, the alternative table stage (all
  256 start values' full 64-bit partials, a thread a start value) on the
  24 MiB chunk, a whole call at other segment and group sizes, and the
  table and partial kernels' instructions by mnemonic in their SASS (the
  whole SASS written to ``chiprun_out/fnv1a.sass``).

* ``train``: the conditioning of ``chip_smoke.py``'s training steps
  (``TRAIN_PHASES``: qwen2-7b's first 8 layers, gemma2-2b's first 16,
  phi3-mini-3.8b and musicgen-medium whole, at full width, random bf16
  weights from seed 0, the loader's first batch).  Each step's loss and
  gradient norm with the attention through the kernels, through
  ``attention_ref`` (the plain version), through it with each dot
  product summed in reverse and in four permuted orders of the head dim,
  in float64, and through autograd of ``scaled_dot_product_attention``
  (without window or softcap); each gradient's elements whose sign
  agrees with the plain version's, in all and in the leaf where fewest
  agree.
* ``saturated``: the backward at the first two layers' own q, k, v of
  each of those models (the first KV head and its q-heads), as drawn
  (rows saturated on one key) and with ``chip_smoke.py``'s
  ``ConditionedAttention`` (the projections at their true fan-in), on
  a random dO: the kernel's dq, dk, dv, the plain version's, the plain
  version summed in reverse and the plain version whose row pass and
  dK/dV pass sum in two orders, each against the float64 backward and
  the plain float32 one by ``ref.err_over_tolerance``; the scores'
  spread and the share of rows whose top two scores nearly tie.
* ``bwd``: flash attention's backward at the four training shapes
  (qwen2-7b's B4 S1024 H32 KV4 hd 128, gemma2-2b's B1 S8192 H16 KV4 hd
  256 with window 4096 and softcap 50, phi3-mini's B4 S1024 H32 KV32 hd
  96, musicgen's B4 S1024 H24 KV24 hd 64), CUDA events around 10 calls,
  each against the plain version; with ``--parent DIR`` that tree's
  backward (there the ``simt`` design at hd 128) in turns with this one
  at qwen2-7b's shape, old, new, new, old; then each ``wgmma`` backward
  kernel's registers and spills from ptxas and its HGMMA instructions
  from the SASS.
* ``ssm``: the conditioning of an SSM training step's gradients:
  mamba2-780m (48 layers at 4 x 1,024 tokens, and its first 4 at 1 x
  256) at random weights from seed 0, in bf16 and copied to float32, with
  ``ssd_intra`` through the kernels, the plain version, the plain version
  with the scores summed in reverse and the intra-chunk term in float64:
  each SSM layer's in_x, in_b, in_c, in_dt and a_log gradient against the
  plain version's, the loss and the grad norm; then one mamba2-780m
  training step (forward and backward) under ``torch.profiler``: its
  wall, the device's busy time and the operations with most device time.

Prints one line a case with the card's name and power limit.  Imports
nothing of JAX.
"""
from __future__ import annotations

import ctypes
import importlib
import importlib.util
import math
import pathlib
import re
import subprocess
import sys
import time
from typing import Dict, Optional

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "src"))

from chip_smoke import card_label, graph_ms, time_ms  # noqa: E402
from repro_torch.kernels import cache_model as cm  # noqa: E402
from repro_torch.kernels import fnv1a, maxmin, ops  # noqa: E402
from repro_torch.kernels import stack_distance as sd  # noqa: E402
from repro_torch.kernels._build import CudaLibrary, cuda_tool  # noqa: E402


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


def probe_waterfill(card: str, parent: Optional[str] = None) -> None:
    dev = torch.device("cuda")
    kernels = {"new": maxmin.WATERFILL}
    if parent:
        kernels["old"] = _parent_module(parent, "kernels.maxmin").WATERFILL
    rng = np.random.default_rng(0)
    for label, flows, links, per_flow in (
            ("all padding", 0, 500, 0), ("like storm H's", 512, 487, 4),
            ("like sweep I's", 5500, 20, 5),
            ("like J2's pricing", 14571, 255, 8),
            ("Fp 32768", 20000, 200, 8)):
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
        design = maxmin.WATERFILL.design(Fp, Lp, 8)
        # the parent's kernel refuses what it has no design for
        served = [w for w in kernels
                  if w == "new" or kernels[w].design(Fp, Lp, 8) == design]
        order = ["old", "new", "new", "old"] if "old" in served else ["new"]
        times = {w: [] for w in served}
        outs = {}
        for which in order:
            kernel = kernels[which]
            outs[which] = kernel(*args)
            times[which].append(graph_ms(lambda: kernel(*args)))
        if "old" in outs and not torch.equal(outs["old"], outs["new"]):
            raise AssertionError(f"maxmin_waterfill {label}: the two "
                                 f"versions differ")
        rounds = int(outs["new"][0, -1])
        line = (f"maxmin_waterfill, {label} (Fp {Fp}, Lp {Lp}, width 8, "
                f"design {design}): new {_ms(times['new'])} ms a launch "
                f"(CUDA graph of 20), {rounds} rounds")
        if "old" in times:
            line += (f"; old {_ms(times['old'])} ms; old / new "
                     f"{sum(times['old']) / sum(times['new']):.3f}; rates "
                     f"equal")
        print(f"{line}  [{card}]", flush=True)


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


# float64 instructions of the SASS: the FP64 pipe's (H100: 64 lanes an SM,
# two warp instructions a clock)
FP64_OPS = re.compile(r"\b(DADD|DMUL|DFMA|DSETP|DMNMX|DSET)\b")
FP64_WARP_INSTR_PER_CLOCK = 2
SMS = 132


def _sass_fp64(lib) -> Dict[str, int]:
    """Each kernel's count of float64 instructions in ``lib``'s SASS, by
    its own name (``lib`` built first if it is not)."""
    lib.load()
    sass = subprocess.run([cuda_tool("cuobjdump"), "-sass", str(lib.path)],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    counts: Dict[str, int] = {}
    current = None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            # the function's own name out of its mangled one
            short = re.search(r"probe_[a-z_]+|[a-z_]+_kernel", name)
            current = short.group(0) if short else name
            counts[current] = 0
        elif current:
            counts[current] += len(FP64_OPS.findall(line))
    return counts


def _count(counts: Dict[str, int], name: str) -> int:
    return next(v for k, v in counts.items() if name in k)


# The planner's kernels built with -DCM_PROBE=1: thread 0 of the first
# block sums clock64() stamps by part (PLAN_PARTS, MIXTURE_PARTS), then
# writes the count of stages or steps; entry points of that build alone.
PROBE_PARTS = 8
PLAN_PARTS = {6: "stage's block barrier", 0: "evaluate and send",
              1: "transaction barrier", 2: "totals", 3: "group steps",
              4: "block barrier after the steps", 5: "bias table",
              7: "set-up"}
MIXTURE_PARTS = {0: "per-point terms", 1: "ct and warp sums",
                 2: "barrier", 3: "update", 6: "broadcast",
                 4: "barrier after", 5: "bias table", 7: "set-up"}
_vp, _ci = ctypes.c_void_p, ctypes.c_int
PROBE_LIB = CudaLibrary("cache_model", {
    "plan_solve_probe": ([_vp] * 5 + [_ci] * 6 + [_vp] * 3, _ci),
    "plan_solve_threads_at": ([_ci] * 2, _ci),
    "mixture_fit_probe": ([_vp] * 3 + [_ci] * 4 + [ctypes.c_double]
                          + [_vp] * 4, _ci)},
    defines={**cm.DEFINES, "CM_PROBE": 1}, flags=cm.FLAGS)


def _probe_call(fn: str, *args) -> None:
    err = getattr(PROBE_LIB.load(), fn)(
        *args, torch.cuda.current_stream().cuda_stream)
    PROBE_LIB.check(err, fn)


def plan_probe(args, steps: int, cluster: int,
               clocks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``plan_solve`` of the probe build on ``cluster`` CTAs a plan, with
    ``chip_smoke._plan_args``'s inputs (its stamps' sums into ``clocks``)."""
    stacked, per_cache, gidx, gsize, scalars = args
    plans, _, n, bk = stacked.shape
    g = gsize.shape[1]
    out = torch.empty(plans, g + 4, dtype=torch.float64, device="cuda")
    _probe_call("plan_solve_probe", stacked.data_ptr(), per_cache.data_ptr(),
                gidx.data_ptr(), gsize.data_ptr(), scalars.data_ptr(), plans,
                n, bk, g, max(steps // cm.PLAN_ROUNDS, 1), cluster,
                out.data_ptr(), None if clocks is None else clocks.data_ptr())
    return out


def mix_probe(args, steps: int, lr: float,
              clocks: Optional[torch.Tensor] = None) -> tuple:
    """``mixture_fit`` of the probe build (its stamps' sums into
    ``clocks``)."""
    params0, grid, target = args
    fits, _, k = params0.shape
    params = torch.empty_like(params0)
    loss = torch.empty(fits, dtype=torch.float64, device="cuda")
    _probe_call("mixture_fit_probe", params0.data_ptr(), grid.data_ptr(),
                target.data_ptr(), fits, grid.shape[1], k, steps, float(lr),
                params.data_ptr(), loss.data_ptr(),
                None if clocks is None else clocks.data_ptr())
    return params, loss


def _split(clocks: torch.Tensor, parts: Dict[int, str], what: str) -> str:
    """The probe build's clock sums as each part's clocks a stage (or
    step) and share."""
    c = clocks.cpu().tolist()
    count, total = c[PROBE_PARTS], sum(c[:PROBE_PARTS])
    return (f"{count} {what}s, {total} clocks in all: " + ", ".join(
        f"{name} {c[i] / max(count, 1):.0f} a {what} "
        f"({100 * c[i] / max(total, 1):.1f}%)" for i, name in parts.items()))


def _probe_run(launch) -> tuple:
    """One probe-build launch, ``launch(clocks)``: its output, its clock
    sums and its time (CUDA events around one launch after a warm-up)."""
    clocks = torch.zeros(PROBE_PARTS + 1, dtype=torch.int64, device="cuda")
    launch(clocks)
    clocks.zero_()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = launch(clocks)
    end.record()
    end.synchronize()
    return out, clocks, start.elapsed_time(end)


def plan_fp64(counts: Dict[str, int], n: int, bk: int, g: int, steps: int,
              csize: int, threads: int, budget: bool) -> dict:
    """The solve's float64 warp instructions from the SASS counts of the
    probe build's terms, and the FP64 issue time they need: on the SMs the
    cluster design uses (the busiest CTA: its caches, every warp's totals
    and every group's step, replicated) and spread over all 132 SMs (each
    term once), at two warp instructions a clock an SM."""
    term = _count(counts, "probe_bucket_term") - 8   # without its 4 sums
    head = _count(counts, "probe_cache_head")
    step = _count(counts, "probe_group_step")
    div = _count(counts, "probe_division")
    inner = max(steps // 8, 1)
    # (stages, sums on in the evaluation, bytes in the totals, Adam steps)
    kinds = [(64, 1 + budget, budget, False), (8 * inner, 2 + 2 * budget,
                                               budget, True),
             (8, 1 + budget, budget, False), (64, 1 + budget, budget, False),
             (1, 3, True, False)]
    lanes = math.ceil(bk / 32)
    warps = threads // 32
    busiest = all_sms = 0
    for stages, sums, nbytes, adam in kinds:
        cache = lanes * (term + 2 * sums) + head
        totals = math.ceil(n / 32) * (1 + 3 * nbytes) + 10 + div
        groups = math.ceil(g / 32) * step if adam else 0
        busiest += stages * (math.ceil(n / csize) * cache + warps * totals
                             + groups)
        all_sms += stages * (n * cache + totals + groups)
    return {"term": term, "head": head, "step": step, "division": div,
            "busiest_sm_warp_instr": busiest, "all_warp_instr": all_sms,
            "design_clocks": busiest / FP64_WARP_INSTR_PER_CLOCK,
            "all_sms_clocks": all_sms / (FP64_WARP_INSTR_PER_CLOCK * SMS)}


def probe_plan(card: str, parent: Optional[str] = None) -> None:
    import repro_torch.core as core
    from chip_smoke import (PLAN_TARGET, PLAN_TILE, _max_sm_clock_hz,
                            _osdf_spec, _plan_args)
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
    counts = _sass_fp64(PROBE_LIB)
    clock_hz = _max_sm_clock_hz()
    print(f"plan_solve SASS (probe build): float64 instructions "
          f"{ {k: v for k, v in counts.items() if 'mixture' not in k} }"
          f"  [{card}]", flush=True)
    for label, tiled in (("J2", 1), ("252 caches", PLAN_TILE)):
        args, _ = _plan_args(spec, tiled)
        n, bk, g = args[0].shape[2], args[0].shape[3], args[3].shape[1]
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
        csize = cm.PLAN_SOLVE.cluster(n, g)
        threads = cm.PLAN_SOLVE.threads(n, g)
        for which in impls:
            t = times[which]
            print(f"plan_solve, {label} ({n} caches, {g} groups), {which}"
                  + (f" (a cluster of {csize} CTAs of {threads} threads)"
                     if which == "new" else "")
                  + f": {_ms(t['loop'])} ms a call by CUDA events "
                  f"around 20 calls; {_ms(t['graph'])} ms in a CUDA graph "
                  f"of 20 launches  [{card}]", flush=True)
        if parent:
            loop = {w: sum(times[w]["loop"]) for w in impls}
            print(f"plan_solve, {label}: old / new "
                  f"{loop['old'] / loop['new']:.3f}; outputs equal  "
                  f"[{card}]", flush=True)
        sizes = []
        for c in (1, 2, 4, 8, 16):
            if c > n:
                continue
            try:
                got = plan_probe(args, spec.steps, c)
                ms = time_ms(lambda: plan_probe(args, spec.steps, c), 20)
            except RuntimeError as exc:
                sizes.append(f"{c}: refused ({exc})")
                continue
            if not torch.equal(got, outs["new"]):
                raise AssertionError(f"plan_solve {label}: a cluster of {c} "
                                     f"gives other bits")
            at = PROBE_LIB.load().plan_solve_threads_at(n, c)
            sizes.append(f"{c} CTAs of {at} threads {ms:.4f} ms")
        print(f"plan_solve {label} by cluster size (the probe build without "
              f"stamps, CUDA events around 20 calls, outputs equal to the "
              f"ordinary build's): {'; '.join(sizes)}  [{card}]", flush=True)
        got, clocks, probe_ms = _probe_run(
            lambda clk: plan_probe(args, spec.steps, csize, clk))
        if not torch.equal(got, outs["new"]):
            raise AssertionError(f"plan_solve {label}: the probe build's "
                                 f"output differs")
        stamped = int(clocks[:PROBE_PARTS].sum())
        print(f"plan_solve {label}, the probe build (CTA 0's thread 0, "
              f"{probe_ms:.4f} ms a launch, {stamped / probe_ms / 1e3:.0f} "
              f"MHz of stamped clocks): "
              + _split(clocks, PLAN_PARTS, "stage") + f"  [{card}]",
              flush=True)
        f = plan_fp64(counts, n, bk, g, spec.steps, csize, threads,
                      budget=False)
        pow_count = _count(counts, "probe_pow")
        old_threads = 32 * min(n, 32)
        one_block = plan_fp64(counts, n, bk, g, spec.steps, 1, old_threads,
                              budget=False)["design_clocks"] + (
            8 * max(spec.steps // 8, 1) * (old_threads // 32) * 2
            * pow_count / FP64_WARP_INSTR_PER_CLOCK)
        print(f"plan_solve {label}, FP64 issue from the SASS: a bucket term "
              f"{f['term']} + 2 a sum, a cache's log-capacity {f['head']}, "
              f"a group's step {f['step']}, a division {f['division']} "
              f"instructions; the busiest SM of the cluster "
              f"{f['busiest_sm_warp_instr']} warp instructions, "
              f"{1e3 * f['design_clocks'] / clock_hz:.4f} ms at "
              f"{clock_hz / 1e6:.0f} MHz; spread over {SMS} SMs "
              f"{f['all_warp_instr']} warp instructions, "
              f"{1e3 * f['all_sms_clocks'] / clock_hz:.6f} ms; the one-block "
              f"design before it on its SM {1e3 * one_block / clock_hz:.4f} "
              f"ms (its two pows a warp a step, {pow_count} instructions "
              f"each, included)  [{card}]", flush=True)


def probe_mix(card: str, parent: Optional[str] = None) -> None:
    """``mixture_fit``: one fit, J2's 28 fits in one launch, and J3's whole
    fit sweep (``run_sweep(fit="mixture")``: the host's clock around it,
    and CUDA events around each of its ``mixture_fit`` calls); with
    ``--parent`` that tree's version in turns, old, new, new, old, the
    fits and the sweep's models required equal bit for bit.  Then the
    probe build's phase split and the SASS counts."""
    import repro_torch.core as core
    from chip_smoke import MIX_LR, MIX_STEPS, _max_sm_clock_hz, _osdf_spec
    impls = {"new": (ops, core)}
    if parent:
        impls["old"] = (_parent_module(parent),
                        _parent_module(parent, "core"))
    order = ["old", "new", "new", "old"] if parent else ["new"]
    base = _osdf_spec(core, "cuda")
    hists = core.run_sweep(core.SweepSpec(name="j2", base=base, axes={}),
                           fit=True).reuse_histograms()
    problems = [cm.mixture_problem(cm.ReuseHistogram.from_dict(hists[n]))
                for n in sorted(hists)]
    batch = [torch.from_numpy(np.stack([p[i] for p in problems])).cuda()
             for i in range(3)]
    one = [t[:1].contiguous() for t in batch]
    for label, args in (("one fit", one), (f"{len(problems)} fits", batch)):
        times = {w: [] for w in impls}
        outs = {}
        for which in order:
            fn = impls[which][0].mixture_fit
            outs[which] = fn(*args, MIX_STEPS, MIX_LR)
            times[which].append(time_ms(
                lambda: fn(*args, MIX_STEPS, MIX_LR), 20))
        if parent and not all(torch.equal(a, b) for a, b in
                              zip(outs["old"], outs["new"])):
            raise AssertionError(f"mixture_fit {label}: the two versions "
                                 f"differ")
        line = (f"mixture_fit, {label} ({MIX_STEPS} steps): new "
                f"{_ms(times['new'])} ms a launch (CUDA events around 20)")
        if parent:
            line += (f"; old {_ms(times['old'])} ms; old / new "
                     f"{sum(times['old']) / sum(times['new']):.3f}; outputs "
                     f"equal")
        print(f"{line}  [{card}]", flush=True)
    # J3's whole fit sweep
    wall = {w: [] for w in impls}
    kernel = {w: [] for w in impls}
    launches = {}
    models = {}
    for which in order:
        o, c = impls[which]
        sweep_base = _osdf_spec(c, None)
        real = o.mixture_fit
        events = []

        def timed(*a, _real=real, _events=events):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = _real(*a)
            end.record()
            _events.append((start, end))
            return out
        o.mixture_fit = timed
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rep = c.run_sweep(c.SweepSpec(name="j3", base=sweep_base,
                                          axes={}), fit="mixture")
            torch.cuda.synchronize()
            wall[which].append(time.perf_counter() - t0)
        finally:
            o.mixture_fit = real
        kernel[which].append(sum(s.elapsed_time(e) for s, e in events))
        launches[which] = len(events)
        models[which] = {n: (m.mix_logits.tobytes(), m.mix_mu.tobytes(),
                             m.mix_log_sigma.tobytes(), m.fit_loss)
                         for n, m in rep.fitted_models().items()}
    if parent and models["old"] != models["new"]:
        raise AssertionError("J3's sweep: the two versions' models differ")
    for which in impls:
        print(f"mixture_fit, J3's fit sweep, {which}: {launches[which]} "
              f"mixture_fit calls, {_ms(kernel[which])} ms of them by CUDA "
              f"events; the sweep {_ms(wall[which])} s (host clock)  "
              f"[{card}]", flush=True)
    if parent:
        print(f"mixture_fit, J3's fit sweep: old / new kernel "
              f"{sum(kernel['old']) / sum(kernel['new']):.2f}, wall "
              f"{sum(wall['old']) / sum(wall['new']):.3f}; models equal  "
              f"[{card}]", flush=True)
    got, clocks, probe_ms = _probe_run(
        lambda clk: mix_probe(one, MIX_STEPS, MIX_LR, clk))
    if not all(torch.equal(a, b) for a, b in
               zip(got, ops.mixture_fit(*one, MIX_STEPS, MIX_LR))):
        raise AssertionError("mixture_fit: the probe build's output differs")
    stamped = int(clocks[:PROBE_PARTS].sum())
    print(f"mixture_fit one fit, the probe build (thread 0, {probe_ms:.4f} "
          f"ms a launch, {stamped / probe_ms / 1e3:.0f} MHz of stamped "
          f"clocks): " + _split(clocks, MIXTURE_PARTS, "step")
          + f"  [{card}]", flush=True)
    counts = _sass_fp64(PROBE_LIB)
    term = _count(counts, "probe_mixture_term")
    update = _count(counts, "probe_mixture_update")
    m, k = batch[1].shape[1], batch[0].shape[2]
    warps = math.ceil(m / 32)
    # a step: every warp's points and components and its 3K + 1 trees of
    # 5 additions; the update warp's step
    per_step = warps * (k * term + 5 * (3 * k + 1) + 4) + update
    clock_hz = _max_sm_clock_hz()
    fit_clocks = per_step / FP64_WARP_INSTR_PER_CLOCK
    print(f"mixture_fit FP64 issue from the SASS: a point's component "
          f"{term}, a parameter's update {update} instructions; a step "
          f"{per_step} warp instructions on its SM, "
          f"{1e3 * MIX_STEPS * fit_clocks / clock_hz:.4f} ms a fit of {MIX_STEPS} steps at {clock_hz / 1e6:.0f} MHz; "
          f"{len(problems)} fits over {SMS} SMs the same (a block an SM)  "
          f"[{card}]", flush=True)


# The digest's probe builds: the same source with -DFNV_PROBE=1 at the
# wrapper's sizes and at others (bytes a segment, segments a group)
_cll = ctypes.c_longlong
FNV_SIGNATURES = {
    "fnv1a_chunks_launch": ([_vp, _cll, _cll, _cll, _vp, _vp, _vp], _ci),
    "fnv1a_work_bytes": ([_cll, _cll, _cll], _cll),
    "fnv1a_stage_probe": ([_ci, _vp, _cll, _cll, _cll, _vp, _vp, _vp, _vp],
                          _ci)}
FNV_SIZES = [(fnv1a.SEG, fnv1a.GROUP), (1024, 32), (4096, 32), (2048, 64),
             (2048, 128)]
FNV_STAGES = {1: "tables", 2: "walk", 3: "partials", 4: "combine",
              5: "alternative tables (64-bit, a thread a start value)"}


def _fnv_lib(seg: int, group: int) -> CudaLibrary:
    return CudaLibrary("fnv1a", FNV_SIGNATURES, defines={
        "FNV_SEG": seg, "FNV_GROUP": group, "FNV_PROBE": 1})


class _FnvCall:
    """A probe build's whole call on ``buf`` with its own workspace and
    output, and each of its stages alone on them."""

    def __init__(self, lib: CudaLibrary, buf: torch.Tensor, chunk: int):
        self.lib, self.buf, self.chunk = lib.load(), buf, chunk
        self.check = lib.check
        self.n = buf.numel()
        self.chunks = fnv1a.num_chunks(self.n, chunk)
        self.out = torch.empty(self.chunks, dtype=torch.int64,
                               device=buf.device)
        self.work = torch.empty(int(self.lib.fnv1a_work_bytes(
            self.n, chunk, self.chunks)), dtype=torch.uint8,
            device=buf.device)
        self.out64 = None

    def __call__(self) -> None:
        self.check(self.lib.fnv1a_chunks_launch(
            self.buf.data_ptr(), self.n, self.chunk, self.chunks,
            self.work.data_ptr(), self.out.data_ptr(),
            torch.cuda.current_stream().cuda_stream), "fnv1a probe")

    def stage(self, k: int) -> None:
        if k == 5 and self.out64 is None:
            self.out64 = torch.empty(-(-self.n // fnv1a.SEG) * 256,
                                     dtype=torch.int64,
                                     device=self.buf.device)
        self.check(self.lib.fnv1a_stage_probe(
            k, self.buf.data_ptr(), self.n, self.chunk, self.chunks,
            self.work.data_ptr(), self.out.data_ptr(),
            0 if self.out64 is None else self.out64.data_ptr(),
            torch.cuda.current_stream().cuda_stream), "fnv1a stage")


def _sass_opcodes(sass: str, kernel: str, loop: str = "") -> Dict[str, int]:
    """The instructions of ``kernel``'s SASS, counted by mnemonic
    (modifiers included), most frequent first: all of them, or with
    ``loop`` those from the first instruction of that mnemonic to the
    next branch (the unrolled body of the kernel's main loop)."""
    counts: Dict[str, int] = {}
    inside = counting = False
    for line in sass.splitlines():
        if "Function :" in line:
            # the mangled name holds the kernel's length and name
            inside = f"{len(kernel)}{kernel}E" in line
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)",
                     line)
        if not (inside and m):
            continue
        op = m.group(1)
        if loop:
            if op == loop and not counts:
                counting = True
            elif counting and op.startswith("BRA"):
                break
        if counting or not loop:
            counts[op] = counts.get(op, 0) + 1
    return dict(sorted(counts.items(), key=lambda kv: -kv[1]))


def probe_fnv(card: str, parent: Optional[str] = None) -> None:
    from chip_smoke import HBM_BYTES_PER_S
    C = 24 * 2 ** 20
    gen = torch.Generator(device="cuda").manual_seed(0)
    big = torch.randint(0, 256, (3 * C - 1,), generator=gen,
                        dtype=torch.uint8, device="cuda")
    inputs = {"a 24 MiB chunk": big[:C], "3 chunks (72 MiB - 1 B)": big}
    impls = {"new": ops.fnv1a64_chunks}
    if parent:
        impls["old"] = _parent_module(parent).fnv1a64_chunks
    order = ["old", "new", "new", "old"] if parent else ["new"]
    for label, buf in inputs.items():
        times = {w: [] for w in impls}
        digests = {}
        for who in order:
            fn = impls[who]
            digests[who] = fnv1a.unsigned(fn(buf, C))
            torch.cuda.synchronize()
            iters = 3 if who == "old" else 20
            times[who].append(time_ms(lambda: fn(buf, C), iters))
        if parent and digests["old"] != digests["new"]:
            raise AssertionError(f"fnv {label}: the two versions differ")
        new = min(times["new"])
        bound = 1e3 * buf.numel() / HBM_BYTES_PER_S
        line = (f"fnv {label}: new {_ms(times['new'])} ms "
                f"({1e6 * new / buf.numel():.5f} ns a byte; bytes bound "
                f"{bound:.5f} ms, {bound / new:.4f} of it)")
        if parent:
            line += (f"; old {_ms(times['old'])} ms, "
                     f"{min(times['old']) / new:.1f}x")
        print(f"{line}  [{card}]", flush=True)
    # the stages alone, from the probe build at the wrapper's sizes
    libs = {size: _fnv_lib(*size) for size in FNV_SIZES}
    from repro_torch.kernels._build import build
    build(*libs.values())
    for label, buf in inputs.items():
        call = _FnvCall(libs[FNV_SIZES[0]], buf, C)
        call()
        if fnv1a.unsigned(call.out) != fnv1a.unsigned(ops.fnv1a64_chunks(
                buf, C)):
            raise AssertionError(f"fnv probe build {label}: digests differ")
        whole = graph_ms(call)
        stages = [1, 2, 3, 4] + ([5] if buf.numel() == C else [])
        split = {k: graph_ms(lambda k=k: call.stage(k)) for k in stages}
        print(f"fnv stages, {label} (SEG {FNV_SIZES[0][0]}, GROUP "
              f"{FNV_SIZES[0][1]}): whole call {whole:.5f} ms; "
              + "; ".join(f"{FNV_STAGES[k]} {ms:.5f}" for k, ms in
                          split.items())
              + f" ms (a CUDA graph of 20 launches each)  [{card}]",
              flush=True)
    for size in FNV_SIZES[1:]:
        for label, buf in inputs.items():
            call = _FnvCall(libs[size], buf, C)
            call()
            if fnv1a.unsigned(call.out) != fnv1a.unsigned(
                    ops.fnv1a64_chunks(buf, C)):
                raise AssertionError(f"fnv SEG {size[0]} GROUP {size[1]}: "
                                     f"digests differ")
            print(f"fnv SEG {size[0]}, GROUP {size[1]}, {label}: whole call "
                  f"{graph_ms(call):.5f} ms, tables "
                  f"{graph_ms(lambda: call.stage(1)):.5f} ms, partials "
                  f"{graph_ms(lambda: call.stage(3)):.5f} ms (CUDA graphs)"
                  f"  [{card}]", flush=True)
    sass = subprocess.run(
        [cuda_tool("cuobjdump"), "-sass", str(libs[FNV_SIZES[0]].path)],
        capture_output=True, text=True, check=True, timeout=120).stdout
    path = pathlib.Path("chiprun_out") / "fnv1a.sass"
    path.parent.mkdir(exist_ok=True)
    path.write_text(sass)
    print(f"fnv SASS of the probe build written to {path}", flush=True)
    for kernel, loop, what in (
            ("fnv_tables", "", "all"),
            ("fnv_tables", "LDS.128", "the main loop's body (16 bytes of "
             "two segments a warp)"),
            ("fnv_partials", "", "all")):
        counts = _sass_opcodes(sass, kernel, loop)
        print(f"{kernel} SASS, {what}: {sum(counts.values())} "
              f"instructions: " + ", ".join(
                  f"{k} {v}" for k, v in list(counts.items())[:14])
              + f"  [{card}]", flush=True)
    ptxas = libs[FNV_SIZES[0]].ptxas_report.read_text()
    for line in ptxas.splitlines():
        if "entry function" in line or "Used" in line or "spill" in line:
            print(f"fnv ptxas: {line.strip()}", flush=True)


def _attention_float64(q, k, v, causal=True, window=0, softcap=0.0):
    """``ref.attention_ref``'s function with every operation in float64
    (``ref`` itself computes in float32 whatever its inputs' dtype); the
    output in float64."""
    s, hd = q.shape[1], q.shape[3]
    g = q.shape[2] // k.shape[2]
    k = k.double().repeat_interleave(g, dim=2)
    v = v.double().repeat_interleave(g, dim=2)
    scores = torch.einsum("bshd,bthd->bhst", q.double(), k) / hd ** 0.5
    if softcap:
        scores = softcap * torch.tanh(scores / softcap)
    i = torch.arange(s, device=q.device)
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= i[None, :] <= i[:, None]
    if window:
        mask &= i[None, :] > i[:, None] - window
    probs = torch.softmax(scores.masked_fill(~mask, float("-inf")), dim=-1)
    return torch.einsum("bhst,bthd->bshd", probs, v)


def _bwd_float64(q, k, v, dout, **kw):
    """dq, dk, dv of ``_attention_float64`` by autograd, in float64."""
    q64, k64, v64 = (t.detach().double().requires_grad_() for t in (q, k, v))
    out = _attention_float64(q64, k64, v64, **kw)
    return torch.autograd.grad(out, (q64, k64, v64), dout.double())


def _attention_variants():
    """name → attention function for ``probe_train``: the kernels (the
    port's own ``ops.flash_attention``) and computations of the same
    function outside them: the plain version, with its dot products summed
    in reverse or in four permuted orders of the head dim, in float64, and
    SDPA (causal attention without window or softcap only)."""
    import torch.nn.functional as F

    from chip_smoke import plain_attention
    from repro_torch.kernels import ref

    def float64(q, k, v, **kw):
        return _attention_float64(q, k, v, **kw).to(q.dtype)

    def sdpa(q, k, v, causal=True, window=0, softcap=0.0):
        if window or softcap or not causal:
            raise ValueError("sdpa stands in for causal attention only")
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True, enable_gqa=True).transpose(1, 2).contiguous()
    return {"kernels": ops.flash_attention, "plain": ref.attention_ref,
            "plain, sums reversed": plain_attention("reverse"),
            **{f"plain, sums permuted ({seed})": plain_attention(seed)
               for seed in (1, 2, 3, 4)},
            "plain, float64": float64, "sdpa": sdpa}


def probe_train(card: str) -> None:
    """The conditioning of each of ``chip_smoke.py``'s training steps
    (``TRAIN_PHASES``: the configs at their phase's depth and batch, random
    bf16 weights from seed 0, the loader's first batch): the step's loss
    and gradient norm with the attention through each variant of
    ``_attention_variants``, each against the plain version's, with the
    share of gradient signs equal to the plain version's."""
    from chip_smoke import TRAIN_PHASES, _train_loader
    from repro_torch.configs import depth_cut, get_config
    from repro_torch.models import init_lm, lm_loss
    from repro_torch.train.optimizer import global_norm, walk

    variants, flash = _attention_variants(), ops.flash_attention
    for arch, layers, b, s, _ in TRAIN_PHASES:
        full = get_config(arch)
        cfg = depth_cut(full, layers) if layers < full.num_layers else full
        params = init_lm(cfg, seed=0, device="cuda")
        batch = _train_loader(cfg.vocab_size, b, s, "cuda").batch(0)
        tokens = torch.as_tensor(batch["tokens"], device="cuda")
        labels = torch.as_tensor(batch["labels"], device="cuda")
        paths = [p for p, _ in walk(params)]
        leaves = [t.requires_grad_(True) for _, t in walk(params)]
        plain = None
        names = [n for n in variants if n != "plain"]
        try:
            for name in ["plain"] + names:
                if name == "sdpa" and (cfg.attn_logit_softcap or
                                       cfg.sliding_window):
                    continue                 # no library call takes them
                ops.flash_attention = variants[name]
                try:
                    loss, _ = lm_loss(params, tokens, labels, cfg)
                    grads = torch.autograd.grad(loss, leaves)
                except torch.OutOfMemoryError:
                    print(f"train {arch}, attention through {name}: out of "
                          f"memory  [{card}]", flush=True)
                    torch.cuda.empty_cache()
                    continue
                norm = global_norm(grads).item()
                if plain is None:
                    plain = (loss.item(), norm, [torch.sign(g) for g in grads])
                agree = [(torch.sign(g) == sg).float().mean().item()
                         for g, sg in zip(grads, plain[2])]
                n = [g.numel() for g in grads]
                worst = min(range(len(agree)), key=agree.__getitem__)
                print(f"train {arch} ({cfg.num_layers} layers, {b} x {s}), "
                      f"attention through {name}: loss {loss.item():.6f} "
                      f"(rel {abs(loss.item() / plain[0] - 1):.2e}), grad "
                      f"norm {norm:.6e} (rel {abs(norm / plain[1] - 1):.2e})"
                      f"; gradient signs equal to the plain version's on "
                      f"{sum(a * m for a, m in zip(agree, n)) / sum(n):.4f} "
                      f"of the elements, fewest in {paths[worst]} "
                      f"({agree[worst]:.4f})  [{card}]", flush=True)
                del grads, loss
        finally:
            ops.flash_attention = flash
        del params, leaves
        torch.cuda.empty_cache()


def _ssd_float64(x, dt, cum, b_in, c_in):
    """The intra-chunk term in float64, cast back to float32."""
    from repro_torch.kernels import ref
    s = torch.einsum("bcqn,bckn->bcqk", c_in.double(), b_in.double())
    m = s[..., None] * ref._masked_decay(cum.double()) \
        * dt.double()[:, :, None]
    return torch.einsum("bcqkh,bckhp->bcqhp", m, x.double()).float()


def probe_ssm(card: str) -> None:
    """The conditioning of an SSM training step's gradients: mamba2-780m
    (all 48 layers at 4 x 1,024 tokens, and its first 4 at 1 x 256),
    random weights from seed 0 in bf16 and the same init copied to
    float32, the loader's first batch.  ``ssd_intra`` goes through the
    kernels, the plain version, the plain version with the scores summed
    in reverse and the intra-chunk term in float64; each SSM layer's
    in_x, in_b, in_c, in_dt and a_log gradient is compared with the plain
    version's (|difference|'s largest element over the plain gradient's
    largest), the worst leaf named, and the loss and grad norm beside."""
    import dataclasses

    from chip_smoke import (_train_loader, _tree_map, plain_ssd,
                            ssm_leaves)
    from repro_torch.configs import depth_cut, get_config
    from repro_torch.models import init_lm, lm_loss
    from repro_torch.train.optimizer import global_norm, walk

    variants = {"plain": plain_ssd(), "kernels": ops.ssd_intra,
                "plain, sums reversed": plain_ssd("reverse"),
                "intra term in float64": _ssd_float64}
    saved = ops.ssd_intra
    full = get_config("mamba2-780m")
    for layers, b, s in ((48, 4, 1024), (4, 1, 256)):
        for dtype in ("bfloat16", "float32"):
            cfg = dataclasses.replace(depth_cut(full, layers), dtype=dtype) \
                if layers < full.num_layers else \
                dataclasses.replace(full, dtype=dtype)
            params = init_lm(depth_cut(full, layers) if layers <
                             full.num_layers else full, seed=0,
                             device="cuda")
            if dtype == "float32":
                params = _tree_map(lambda t: t.float(), params)
            batch = _train_loader(cfg.vocab_size, b, s, "cuda").batch(0)
            tokens = torch.as_tensor(batch["tokens"], device="cuda")
            labels = torch.as_tensor(batch["labels"], device="cuda")
            leaves = [t.requires_grad_(True) for _, t in walk(params)]
            at = {id(t): i for i, t in enumerate(leaves)}
            named = ssm_leaves(params, cfg)
            plain = None
            try:
                for name, fn in variants.items():
                    ops.ssd_intra = fn
                    loss, _ = lm_loss(params, tokens, labels, cfg)
                    grads = torch.autograd.grad(loss, leaves)
                    norm = global_norm(grads).item()
                    chosen = [grads[at[id(t)]].float() for _, t in named]
                    if plain is None:
                        plain = (loss.item(), norm, chosen)
                    offs = [((g - w).abs().max() / w.abs().max()).item()
                            for g, w in zip(chosen, plain[2])]
                    worst = max(range(len(offs)), key=offs.__getitem__)
                    print(f"ssm mamba2-780m ({layers} layers, {b} x {s}, "
                          f"{dtype}), ssd_intra through {name}: loss "
                          f"{loss.item():.6f} (rel "
                          f"{abs(loss.item() / plain[0] - 1):.2e}), grad norm "
                          f"{norm:.6e} (rel {abs(norm / plain[1] - 1):.2e}); "
                          f"the {len(offs)} SSM leaves off the plain "
                          f"version's by up to {offs[worst]:.3e} of their "
                          f"largest element "
                          f"({'.'.join(map(str, named[worst][0]))})  "
                          f"[{card}]", flush=True)
                    del grads, loss, chosen
            finally:
                ops.ssd_intra = saved
            del params, leaves, plain
            torch.cuda.empty_cache()
    _ssm_step_profile(card)


def _ssm_step_profile(card: str) -> None:
    """Where mamba2-780m's training step spends the card's time: one
    ``lm_loss`` forward and backward (48 layers, 4 x 1,024 tokens, bf16,
    remat, ``ssd_intra`` through the kernels) under ``torch.profiler``,
    after one warm-up: the step's wall (host clock around synchronised
    work), the device's busy time, and the operations with the most
    device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import _train_loader
    from repro_torch.configs import get_config
    from repro_torch.models import init_lm, lm_loss
    from repro_torch.train.optimizer import walk

    cfg = get_config("mamba2-780m")
    params = init_lm(cfg, seed=0, device="cuda")
    batch = _train_loader(cfg.vocab_size, 4, 1024, "cuda").batch(0)
    tokens = torch.as_tensor(batch["tokens"], device="cuda")
    labels = torch.as_tensor(batch["labels"], device="cuda")
    leaves = [t.requires_grad_(True) for _, t in walk(params)]

    def step():
        loss, _ = lm_loss(params, tokens, labels, cfg)
        torch.autograd.grad(loss, leaves)
    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)

    def device_us(event) -> float:
        return getattr(event, "self_device_time_total",
                       getattr(event, "self_cuda_time_total", 0.0))
    # the kernels' own rows (device events) sum to the busy time; the
    # operators' rows (host events) attribute the same time to the
    # operator that launched each kernel
    rows = sorted(prof.key_averages(), key=device_us, reverse=True)
    on_device = [e for e in rows if e.device_type == DeviceType.CUDA]
    operators = [e for e in rows if e.device_type != DeviceType.CUDA and
                 device_us(e) > 0]
    busy_ms = sum(device_us(e) for e in on_device) / 1e3
    print(f"ssm mamba2-780m step profile (48 layers, 4 x 1024, bf16, "
          f"forward and backward with remat): wall {wall_ms:.2f} ms, device "
          f"busy {busy_ms:.2f} ms ({100 * busy_ms / wall_ms:.1f}%; idle "
          f"{100 - 100 * busy_ms / wall_ms:.1f}%) in "
          f"{sum(e.count for e in on_device)} kernels  [{card}]", flush=True)
    for what, events in (("operator", operators), ("kernel", on_device)):
        for e in events[:10]:
            print(f"ssm step profile, {what} {e.key[:60]}: "
                  f"{device_us(e) / 1e3:.2f} ms device in {e.count} calls  "
                  f"[{card}]", flush=True)
    del params, leaves
    torch.cuda.empty_cache()


def _own_qkv(cfg, full, params, tokens, layers: int = 2):
    """The q, k, v and options the first ``layers`` layers give flash
    attention on ``tokens``, cut to the first KV head and its group of
    q-heads (the group's sums stay whole)."""
    from repro_torch.configs import depth_cut
    from repro_torch.models import forward
    flash, seen = ops.flash_attention, []

    def record(q, k, v, **kw):
        g = q.shape[2] // k.shape[2]
        seen.append((q[:, :, :g].contiguous(), k[:, :, :1].contiguous(),
                     v[:, :, :1].contiguous(), kw))
        return flash(q, k, v, **kw)
    ops.flash_attention = record
    try:
        with torch.no_grad():
            forward({**params, "blocks": params["blocks"][:layers]}, tokens,
                    depth_cut(full, layers))
    finally:
        ops.flash_attention = flash
    return seen


def _bwd_two_orders(q, k, v, dout, lse, *, causal=True, window=0,
                    softcap=0.0):
    """``attention_bwd_ref``'s dK and dV with the row pass (lse' and D)
    summed in one order and the dK/dV pass's scores and dP in another (q,
    k, dO and v flipped along the head dim): what a backward whose passes
    recompute S and dP in different orders gives."""
    from repro_torch.kernels import ref
    b, s, h, hd = q.shape
    kv = k.shape[2]
    g = h // kv
    flip = torch.arange(hd - 1, -1, -1, device=q.device)

    def p_dp(q_, k_, v_, do_, lse_):
        scores, t, mask = ref._scores(q_, k_, causal, window, softcap)
        p = torch.where(mask, torch.exp(scores - lse_[..., None]),
                        torch.zeros((), device=q.device))
        dp = torch.einsum("bshd,bthd->bhst", do_.float(),
                          v_.float().repeat_interleave(g, dim=2))
        return p, dp, t
    p, dp, _ = p_dp(q, k, v, dout, lse)
    total = p.sum(-1)
    lse2 = lse + torch.log(torch.where(total > 0, total, 1.0))
    dsum = (p * dp).sum(-1) / torch.where(total > 0, total, 1.0)
    del p, dp
    p, dp, t = p_dp(q[..., flip], k[..., flip], v[..., flip],
                    dout[..., flip], lse2)
    ds = p * (dp - dsum[..., None])
    if softcap:
        ds = ds * (1 - t * t)
    dk = torch.einsum("bhst,bshd->bthd", ds, q.float()) / hd ** 0.5
    dv = torch.einsum("bhst,bshd->bthd", p, dout.float())
    return (dk.view(b, s, kv, g, hd).sum(3).to(k.dtype),
            dv.view(b, s, kv, g, hd).sum(3).to(v.dtype))


def probe_saturated(card: str) -> None:
    """The backward at the training models' own q, k, v: for each of
    ``chip_smoke.py``'s ``TRAIN_PHASES`` (random bf16 weights from seed 0,
    the loader's first batch), the first two layers' q, k, v (the first KV
    head and its q-heads), as drawn (scores of std ~45-250: rows
    saturated on one key) and under ``chip_smoke.ConditionedAttention``,
    and a random dO.  Against the float64 backward (rounded to bf16, by
    ``ref.err_over_tolerance``: one bf16 ulp + 1e-3 a unit) and against
    the plain float32 version: the backward kernel's dq, dk, dv, the
    plain version's, the plain version with its dot products summed in
    reverse, and the plain version whose row pass and dK/dV pass sum in
    different orders (``_bwd_two_orders``)."""
    from chip_smoke import ConditionedAttention, TRAIN_PHASES, _train_loader
    from repro_torch.configs import depth_cut, get_config
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import BACKWARD
    from repro_torch.models import init_lm

    def flipped(q, k, v, dout, lse, **kw):
        flip = torch.arange(q.shape[-1] - 1, -1, -1, device=q.device)
        dq, dk, dv = ref.attention_bwd_ref(q[..., flip], k[..., flip], v,
                                           dout, lse, **kw)
        return dq[..., flip], dk[..., flip], dv
    for arch, layers, b, s, _ in TRAIN_PHASES:
        full = get_config(arch)
        cfg = depth_cut(full, 2)
        params = init_lm(cfg, seed=0, device="cuda")
        batch = _train_loader(cfg.vocab_size, b, s, "cuda").batch(0)
        tokens = torch.as_tensor(batch["tokens"], device="cuda")
        runs = {"as drawn": _own_qkv(cfg, full, params, tokens)}
        with ConditionedAttention(params, cfg):
            runs["conditioned"] = _own_qkv(cfg, full, params, tokens)
        gen = torch.Generator(device="cuda").manual_seed(0)
        for init, seen in runs.items():
            for layer, (q, k, v, kw) in enumerate(seen):
                hd = q.shape[-1]
                dout = torch.randn(q.shape, generator=gen,
                                   device="cuda").to(q.dtype)
                _, lse = ref.attention_lse_ref(q, k, v, **kw)
                scores, _, mask = ref._scores(q, k, kw["causal"],
                                              kw["window"], kw["softcap"])
                top2 = scores.masked_fill(~mask, float("-inf")).topk(
                    2, dim=-1).values
                gap = (top2[..., 0] - top2[..., 1])[:, :, 1:]
                std = scores[..., mask].std().item()
                del scores, mask, top2
                truth = [t.to(q.dtype) for t in _bwd_float64(
                    q, k, v, dout, **kw)]
                plain = ref.attention_bwd_ref(q, k, v, dout, lse, **kw)
                cands = {"kernel": BACKWARD(q, k, v, dout, lse, **kw),
                         "plain": plain,
                         "plain reversed": flipped(q, k, v, dout, lse, **kw),
                         "plain, passes in two orders":
                             (None,) + _bwd_two_orders(q, k, v, dout, lse,
                                                       **kw)}
                parts = []
                for name, got in cands.items():
                    errs = []
                    for n, g, t, p in zip(("dq", "dk", "dv"), got, truth,
                                          plain):
                        if g is None:
                            continue
                        errs.append(f"{n} {ref.err_over_tolerance(g, t):.2f}"
                                    f"/{ref.err_over_tolerance(g, p):.2f}")
                    parts.append(f"{name} {', '.join(errs)}")
                print(f"saturated {arch} layer {layer}, {init} (q-heads "
                      f"{q.shape[2]} of one KV head, hd {hd}, window "
                      f"{kw['window']}, softcap {kw['softcap']:g}): scores' "
                      f"std {std:.1f}, rows whose top two scores lie within "
                      f"1 of each other {(gap < 1).float().mean().item():.4f}"
                      f", within 1e-2 {(gap < 1e-2).float().mean().item():.4f}"
                      f"; err/tol against float64 / against plain float32: "
                      f"{'; '.join(parts)}  [{card}]", flush=True)
                del cands, truth, plain, dout
                torch.cuda.empty_cache()
        del params, runs
        torch.cuda.empty_cache()


BWD_SHAPES = (("qwen2-7b", 4, 1024, 32, 4, 128, 0, 0.0),
              ("gemma2-2b", 1, 8192, 16, 4, 256, 4096, 50.0),
              ("phi3-mini-3.8b", 4, 1024, 32, 32, 96, 0, 0.0),
              ("musicgen-medium", 4, 1024, 24, 24, 64, 0, 0.0))


def _bwd_inputs(b, s, h, kv, hd, window, softcap):
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rand(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=gen, device="cuda")
                ).to(torch.bfloat16)
    q, k, v = rand(b, s, h, hd, scale=2.0), rand(b, s, kv, hd), \
        rand(b, s, kv, hd)
    dout = rand(b, s, h, hd)
    from repro_torch.kernels.flash_attention import KERNEL
    kw = dict(causal=True, window=window, softcap=softcap)
    _, lse = KERNEL.with_lse(q, k, v, **kw)
    return (q, k, v, dout, lse), kw


def _ptxas_by_kernel(report: str, pattern: str) -> Dict[str, str]:
    """The registers and spills ptxas reports for each entry whose name
    holds ``pattern``, by its demangled template arguments."""
    out, entry = {}, None
    for line in report.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1] if pattern in line else None
        elif entry and ("spill" in line or "Used" in line):
            out[entry] = (out.get(entry, "") + " " +
                          line.split(":", 1)[-1].strip()).strip()
    return out


def _template_args(mangled: str) -> str:
    """'hd 128 dkdv softcap 0' for a wgmma backward kernel's symbol."""
    m = re.search(r"(kv|q)_kernelILi(\d+)E((?:Lb\dE)+)", mangled)
    kind, hd, flags = m.group(1), m.group(2), re.findall(r"\d", m.group(3))
    name = "dkdv" if kind == "kv" else ("dq" if flags[1] == "1" else "rows")
    return f"hd {hd:>3} {name:4} softcap {flags[0]}"


def probe_bwd(card: str, parent: Optional[str] = None) -> None:
    """Flash attention's backward: at qwen2-7b's training shape (B4 S1024
    H32 KV4 hd 128, causal) the design of ``--parent DIR`` (``simt`` there)
    and this tree's wgmma in turns, old, new, new, old, each against the
    plain version; then this tree's design alone at gemma2-2b's,
    phi3-mini's and musicgen's training shapes; then each wgmma kernel's
    registers and spills (ptxas) and HGMMA instructions (SASS)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    impls = {"new": fa.BACKWARD}
    if parent:
        impls["old"] = _parent_module(parent,
                                      "kernels.flash_attention").BACKWARD
    for arch, b, s, h, kv, hd, window, softcap in BWD_SHAPES:
        if hd != 128 and parent is not None:
            impls.pop("old", None)
        args, kw = _bwd_inputs(b, s, h, kv, hd, window, softcap)
        want = ref.attention_bwd_ref(*args, **kw)
        order = ["old", "new", "new", "old"] if "old" in impls else ["new"]
        times = {name: [] for name in impls}
        for name in order:
            got = impls[name](*args, **kw)
            ratio = max(ref.err_over_tolerance(g, w)
                        for g, w in zip(got, want))
            ms = time_ms(lambda: impls[name](*args, **kw), 10)
            times[name].append(ms)
            print(f"bwd {arch} B{b} S{s} H{h} KV{kv} hd{hd} window {window} "
                  f"softcap {softcap:g}: {name} "
                  f"({impls[name].design(torch.bfloat16, hd)}) {ms:.4f} ms, "
                  f"err/tol against the plain version "
                  f"{ratio:.3f}  [{card}]", flush=True)
        if "old" in times:
            print(f"bwd {arch}: old {_ms(times['old'])} ms, new "
                  f"{_ms(times['new'])} ms, old/new "
                  f"{sum(times['old']) / sum(times['new']):.2f}  [{card}]",
                  flush=True)
        del args, want, got
        torch.cuda.empty_cache()
    regs = _ptxas_by_kernel(fa.LIB.ptxas_report.read_text(),
                            "flash_bwd_wgmma")
    sass = subprocess.run([cuda_tool("cuobjdump"), "-sass",
                           str(fa.LIB.path)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    hgmma, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
        elif fn and "HGMMA" in line:
            hgmma[fn] = hgmma.get(fn, 0) + 1
    for mangled in sorted(regs, key=_template_args):
        print(f"bwd ptxas/SASS {_template_args(mangled)}: {regs[mangled]}; "
              f"{hgmma.get(mangled, 0)} HGMMA  [{card}]", flush=True)


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
              "waterfill": lambda c: probe_waterfill(c, parent),
              "distances": lambda c: probe_distances(c, parent),
              "paths": lambda c: probe_paths(c, parent),
              "plan": lambda c: probe_plan(c, parent),
              "mix": lambda c: probe_mix(c, parent),
              "fnv": lambda c: probe_fnv(c, parent),
              "train": probe_train,
              "ssm": probe_ssm,
              "saturated": probe_saturated,
              "bwd": lambda c: probe_bwd(c, parent)}
    for name in args or probes:
        probes[name](card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
