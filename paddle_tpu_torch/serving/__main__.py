"""`python -m paddle_tpu_torch.serving`: the fleet kill soak, the
counterpart of `python -m paddle_tpu.serving`.

Serves a shared-prefix batch through an `EngineFleet` (a `gpt_tiny`
from the seed), kills the busiest replica mid-decode (unclean: failover
runs from the last periodic snapshot), revives it through the half-open
canary gate, and writes `FLEET.json`: failover counts, re-admitted vs
re-submitted requests, the stranded-request count (the no-strand
contract, enforced), and the TTFT p99 of the requests a failover
displaced beside that of the steady ones.

It runs on the card unless `--device cpu` is given. The exit code is
nonzero when a submitted request reached no terminal result (stranded),
when a displaced request finished with an error, or when
`fleet.to_prometheus()` fails the strict exposition parser.
`run_soak()` is the same soak for any model and fleet geometry
(`chip_smoke.py` runs it at GPT-small width).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple


def fleet_affected_rids(fleet) -> set:
    """Rids a failover post-mortem named (re-admitted or re-submitted):
    the requests that paid for a replica death."""
    out = set()
    for rep in fleet.flight.reports:
        d = rep.get("detail") or {}
        out.update(int(x) for x in d.get("readmitted_rids", ()))
        out.update(int(x) for x in d.get("resubmitted_rids", ()))
    return out


def soak_prompts(requests: int, shared_prefix: int, seed: int) -> List:
    """The soak's prompts: one shared preamble, then a random tail of
    3-23 tokens each, ids below 1024 (the reference's load)."""
    import numpy as np
    rng = np.random.RandomState(seed)
    pre = rng.randint(0, 1024, (shared_prefix,)).astype(np.int32)
    out = []
    for _ in range(requests):
        tail = rng.randint(0, 1024,
                           (int(rng.randint(3, 24)),)).astype(np.int32)
        out.append(np.concatenate([pre, tail]))
    return out


def run_soak(fleet, prompts: Sequence, max_new_tokens: int,
             kill_after_steps: int, max_steps: int = 5000
             ) -> Tuple[Dict, Dict[int, object], List[int]]:
    """Drive `prompts` (greedy) through `fleet`, killing and reviving
    the busiest replica after `kill_after_steps` rounds (0: no kill).
    Returns (report, results by rid, rids in submit order); the report
    holds FLEET.json's keys but `replicas` and `routing`, plus the
    rounds run (`steps`) and their wall time (`wall_s`)."""
    from ..obs.prometheus import parse_exposition
    from .engine import SamplingParams
    from .metrics import nearest_rank_p99
    rids = [fleet.submit(p, SamplingParams(max_new_tokens=max_new_tokens))
            for p in prompts]
    victim = -1
    steps = 0
    t0 = time.perf_counter()
    while fleet.has_work():
        fleet.step()
        steps += 1
        if steps == kill_after_steps and kill_after_steps > 0:
            # kill the busiest replica: the worst-case failover
            victim = fleet.busiest()
            fleet.kill(victim)
            fleet.revive(victim)
        if steps > max_steps:
            break
    wall = time.perf_counter() - t0
    results = {rid: fleet.result(rid) for rid in rids
               if fleet.has_result(rid)}
    stranded = [rid for rid in rids if rid not in results]
    st = fleet.stats()
    affected = fleet_affected_rids(fleet)
    parse_exposition(fleet.to_prometheus())   # strict: raises if invalid
    report = {
        "requests": len(rids),
        "killed_replica": victim,
        "failovers": int(st["failovers"]),
        "readmitted_requests": int(st["requests_readmitted"]),
        "resubmitted_requests": int(st["requests_resubmitted"]),
        "canary_probes": int(st["canary_probes"]),
        "stranded_requests": len(stranded),
        "failed_requests": sum(1 for g in results.values()
                               if g.finish_reason == "error"),
        "ttft_p99_failover_s": nearest_rank_p99(
            [g.ttft_s for r, g in results.items() if r in affected]),
        "ttft_p99_steady_s": nearest_rank_p99(
            [g.ttft_s for r, g in results.items() if r not in affected]),
        "routed_affinity": int(st["routed_affinity"]),
        "routed_spill": int(st["routed_spill"]),
        "steps": steps,
        "wall_s": wall,
    }
    return report, results, rids


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.serving",
        description="fleet kill soak emitting FLEET.json")
    ap.add_argument("--fleet-out", default="FLEET.json",
                    help="machine-readable soak report path")
    ap.add_argument("--replicas", type=int, default=3)
    ap.add_argument("--requests", type=int, default=18)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--max-new-tokens", type=int, default=12)
    ap.add_argument("--shared-prefix", type=int, default=16,
                    help="common preamble so prefix-affinity routing "
                         "has something to score")
    ap.add_argument("--kill-after-steps", type=int, default=3,
                    help="fleet rounds before the busiest replica is "
                         "killed (unclean; 0 disables the kill)")
    ap.add_argument("--routing", default="prefix_affinity",
                    choices=("least_loaded", "prefix_affinity"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a card) or "
                         "'cpu'")
    args = ap.parse_args(argv)

    from ..models import gpt_tiny
    from .fleet import EngineFleet

    model = gpt_tiny(seed=args.seed, device=args.device)
    fleet = EngineFleet(model, replicas=args.replicas,
                        routing=args.routing, snapshot_every=2,
                        quarantine_backoff_s=0.01,
                        max_slots=args.slots, max_seq=96,
                        prefix_block=8, seed=args.seed,
                        device=args.device)
    try:
        prompts = soak_prompts(args.requests, args.shared_prefix,
                               args.seed)
        soak, _, _ = run_soak(fleet, prompts, args.max_new_tokens,
                              args.kill_after_steps)
        report = {"replicas": args.replicas, "routing": args.routing,
                  **{k: v for k, v in soak.items()
                     if k not in ("steps", "wall_s")}}
        with open(args.fleet_out, "w") as f:
            json.dump(report, f, indent=1)
        for line in fleet.replica_digests():
            print(line)
        print(f"wrote {args.fleet_out}: {json.dumps(report)}")
        if report["stranded_requests"]:
            print(f"FAIL: {report['stranded_requests']} stranded "
                  f"requests", file=sys.stderr)
            return 1
        if report["failed_requests"]:
            print(f"FAIL: {report['failed_requests']} requests errored "
                  f"under a plain kill soak (no fault plan armed)",
                  file=sys.stderr)
            return 1
        return 0
    finally:
        fleet.close()


if __name__ == "__main__":
    sys.exit(main())
