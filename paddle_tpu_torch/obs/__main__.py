"""`python -m paddle_tpu_torch.obs`: the observability smoke workload,
the counterpart of `python -m paddle_tpu.obs`.

Serves a short shared-prefix batch through `serving.LLMEngine` (a
`gpt_tiny` from the seed, tracing on) and writes two artifacts:

- `METRICS.prom`: the engine's Prometheus exposition
  (`LLMEngine.to_prometheus()`: counters, TTFT / queue-wait / TBT
  summaries, KV and pool gauges, the capture watchdog's families)
  followed by the provider registry's (`registry_exposition()`),
  strict-parsed BEFORE it is written, so the file is valid exposition
  or the run fails;
- `trace.json`: the Perfetto-loadable lifecycle trace (one track per KV
  slot lane plus the queue and engine tracks).

It runs on the card unless `--device cpu` is given. The exit code is
nonzero when the exposition fails the strict parser or the watchdog
read unexpected captures (a program built twice, or more programs than
the configuration's budget).
"""
from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.obs",
        description="short serve workload writing METRICS.prom + "
                    "trace.json")
    ap.add_argument("--metrics-out", default="METRICS.prom",
                    help="Prometheus exposition artifact path")
    ap.add_argument("--trace-out", default="trace.json",
                    help="Perfetto trace artifact path")
    ap.add_argument("--requests", type=int, default=10)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--shared-prefix", type=int, default=16,
                    help="common preamble length, so the prefix cache "
                         "(and its trace events) run")
    ap.add_argument("--max-new-tokens", type=int, default=12)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a card) or "
                         "'cpu'")
    args = ap.parse_args(argv)

    import numpy as np

    from ..models import gpt_tiny
    from ..serving import LLMEngine, SamplingParams
    from . import digest
    from .prometheus import parse_exposition, registry_exposition

    model = gpt_tiny(seed=args.seed, device=args.device)
    eng = LLMEngine(model, max_slots=args.slots, seed=args.seed,
                    max_seq=96, prefix_block=8, device=args.device)
    try:
        rng = np.random.RandomState(args.seed)
        pre = rng.randint(0, 1024, (args.shared_prefix,)).astype(np.int32)
        prompts = []
        for _ in range(args.requests):
            tail = rng.randint(
                0, 1024, (int(rng.randint(3, 24)),)).astype(np.int32)
            prompts.append(np.concatenate([pre, tail]))
        eng.generate(prompts, SamplingParams(
            max_new_tokens=args.max_new_tokens))

        text = eng.to_prometheus() + registry_exposition()
        parse_exposition(text)  # strict: invalid exposition never lands
        with open(args.metrics_out, "w") as f:
            f.write(text)
        eng.export_trace(args.trace_out)

        snap = eng.stats()
        snap.update(eng.watchdog.snapshot())
        print(digest(snap))
        print(f"wrote {args.metrics_out} "
              f"({len(text.splitlines())} lines) and {args.trace_out} "
              f"({len(eng.tracer)} lifecycle events)")
        unexpected = int(snap["compiles_unexpected"])
        if unexpected:
            print(f"FAIL: {unexpected} unexpected captures "
                  f"({eng.watchdog.counts()})", file=sys.stderr)
            return 1
        return 0
    finally:
        eng.close()


if __name__ == "__main__":
    sys.exit(main())
