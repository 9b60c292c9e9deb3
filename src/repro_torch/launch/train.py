"""Training launcher: federation-fed, fault-tolerant, arch-selectable.

  PYTHONPATH=src python -m repro_torch.launch.train --arch mixtral-8x22b \
      --steps 50 --grad-compression int8_ef --fail-at 20 [--device cpu]

The reference's launcher on the port: the reduced (smoke) config of the
selected architecture in float32, its token shards published to a
two-pod fleet's origin, a ``FederatedDataLoader`` over them, checkpoints
through the fleet's write-back cache, an injected failure where asked.
``--device`` (default ``cuda``) runs the model and digests the
federation's real bytes.  It prints the reference launcher's one line.
"""
from __future__ import annotations

import argparse
import dataclasses

from ..configs import get_config
from ..core import AnalyticPlane, build_fleet_federation
from ..data import DatasetSpec, FederatedDataLoader, SyntheticTokens
from ..train import (AdamWConfig, FailureInjector, FederatedCheckpointer,
                     Trainer)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-7b")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--pods", type=int, default=2)
    ap.add_argument("--checkpoint-every", type=int, default=10)
    ap.add_argument("--grad-compression", default="none",
                    choices=["none", "int8_ef"])
    ap.add_argument("--fail-at", type=int, default=-1,
                    help="inject a node failure at this step")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = dataclasses.replace(get_config(args.arch, smoke=True),
                              dtype="float32")
    fed = build_fleet_federation(num_pods=args.pods, hosts_per_pod=8,
                                 device=args.device)
    spec = DatasetSpec("launch", vocab_size=cfg.vocab_size,
                       tokens_per_shard=1 << 16, num_shards=16)
    SyntheticTokens(spec).publish(fed.origins[0])
    plane = AnalyticPlane(fed)
    loader = FederatedDataLoader(plane, spec, global_batch=args.batch,
                                 seq_len=args.seq, site="pod0", worker=0)
    ck = FederatedCheckpointer(f"launch-{args.arch}", plane,
                               site="pod0", worker=1)
    trainer = Trainer(cfg, loader,
                      AdamWConfig(lr=args.lr, warmup_steps=5,
                                  total_steps=max(args.steps, 10)),
                      checkpointer=ck,
                      checkpoint_every=args.checkpoint_every,
                      grad_compression=args.grad_compression,
                      device=args.device)
    failure = FailureInjector([args.fail_at]) if args.fail_at >= 0 else None
    report = trainer.run(args.steps, failure=failure)
    print(f"arch={cfg.name} steps={report.steps_run} "
          f"loss {report.losses[0]:.3f}→{report.final_loss:.3f} "
          f"restarts={report.restarts} hit_rate={report.cache_hit_rate:.2f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
