#!/usr/bin/env python3
"""Time three kernels of the port on synthetic inputs that isolate their
parts, on one CUDA card:

    python3 kernel_probe.py [cache_sim] [fifo] [waterfill]

(all three when none is named).

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

Prints one line a case with the card's name and power limit.  Imports
nothing of JAX.
"""
from __future__ import annotations

import pathlib
import sys

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "src"))

from chip_smoke import card_label, graph_ms, time_ms  # noqa: E402
from repro_torch.kernels import maxmin, ops  # noqa: E402


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


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_probe: no CUDA device", file=sys.stderr)
        return 1
    card = card_label()
    probes = {"cache_sim": probe_cache_sim, "fifo": probe_fifo,
              "waterfill": probe_waterfill}
    for name in sys.argv[1:] or probes:
        probes[name](card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
