"""Serving launcher: weights via the federation, batched generate.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-2b \
      --requests 6 --max-new 12 [--device cpu]

The reference's launcher on the port: the smoke config in float32, its
weights published through a one-pod fleet's write-back cache in the
reference's checkpoint layout, restored by another worker of the pod,
and served.  ``--device`` (default ``cuda``) runs the model and digests
the federation's real bytes.
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np

from ..configs import get_config
from ..core import AnalyticPlane, build_fleet_federation
from ..models import init_lm, jax_layout
from ..serve import Request, ServeEngine
from ..train import FederatedCheckpointer


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-2b")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--max-seq", type=int, default=96)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = dataclasses.replace(get_config(args.arch, smoke=True),
                              dtype="float32")
    params = init_lm(cfg, seed=0, device=args.device)

    # Publish → restore through the data plane (weight distribution).
    fed = build_fleet_federation(num_pods=1, hosts_per_pod=4,
                                 device=args.device)
    plane = AnalyticPlane(fed)
    ck = FederatedCheckpointer("serve", plane, site="pod0", worker=0)
    ck.save(0, jax_layout(params, cfg))
    engine = ServeEngine.from_federation(
        cfg, plane, "serve", 0, site="pod0", worker=1, like=params,
        device=args.device, batch_size=args.batch, max_seq=args.max_seq)
    st = engine.data_stats
    print(f"weights via federation: {st.bytes_fetched / 1e6:.1f} MB, "
          f"hits={st.cache_hits} misses={st.cache_misses}")

    rng = np.random.default_rng(0)
    reqs = [Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab_size, size=8),
                    max_new_tokens=args.max_new)
            for i in range(args.requests)]
    engine.generate(reqs)
    print(f"served {len(reqs)} requests: {engine.stats.prefills} prefills, "
          f"{engine.stats.decode_steps} decode steps, "
          f"{engine.stats.tokens_out} tokens")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
