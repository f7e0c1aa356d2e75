#!/usr/bin/env python3
"""Where the front-door soak's worker thread spends its stalls, on one card.

    python3 scripts/front_door_probe.py [--configs c e] [--repeat 3]
        [--out front_door_probe.json]

Builds the decode kernels and K7, GPT-small bf16 from seed 0 (phase 4's
model), then runs `python -m paddle_tpu_torch.serving.server`'s soak
(`server.run_soak`, the reference's defaults) in each configuration of
`--configs` (`chip_smoke.FRONT_DOOR_CONFIGS` tags: a slotted, b paged
int8, c 2 replicas with a kill and revive, d speculative with the int8
draft, e autoscaled, f paged int8 drained early), `--repeat` times each, on this main thread. Each
run records, on one clock from the soak's start: every program capture
(`graphs._warm_up_and_capture`: seconds and the thread), every
continuation replay (`LLMEngine._replay`: seconds and steps), the fleet's
kills, revives and spawns, the SIGTERM drain, the behaved tenant's live
streams each time they pass a multiple of 8 and its sheds (reason, live
streams); and it prints the soak's TTFT p99s, tail ratio, stranded
streams and the peak of live behaved streams. Every line carries the
card's name and power limit. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import tempfile
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def instrument(S, E, G, F, SLO, clock):
    """Wrap the soak's stall points; returns (events, peak) that each run
    clears and reads."""
    events, peak = [], {}

    def stamp(kind, **kw):
        events.append((round(time.perf_counter() - clock[0], 4), kind, kw))

    capture = G._warm_up_and_capture

    def timed_capture(graph, step, pool=None):
        t = time.perf_counter()
        try:
            return capture(graph, step, pool)
        finally:
            stamp("capture", s=round(time.perf_counter() - t, 4),
                  thread=threading.current_thread().name)

    G._warm_up_and_capture = timed_capture
    replay = E.LLMEngine._replay

    def timed_replay(self, lanes):
        t, n = time.perf_counter(), self.metrics.replay_steps
        try:
            return replay(self, lanes)
        finally:
            stamp("replay", s=round(time.perf_counter() - t, 4),
                  steps=self.metrics.replay_steps - n)

    E.LLMEngine._replay = timed_replay
    admit = SLO.SLOController.admit

    def counted_admit(self, tenant, tokens):
        adm = admit(self, tenant, tokens)
        n = self.streams_active(tenant)
        if tenant == "behaved":
            if n > peak.get(tenant, 0) and n % 8 == 0:
                stamp("live", n=n)
            if not adm.admitted:
                stamp("shed", reason=adm.reason, live=n)
        peak[tenant] = max(peak.get(tenant, 0), n)
        return adm

    SLO.SLOController.admit = counted_admit
    for name in ("kill", "revive", "add_replica"):
        verb = getattr(F.EngineFleet, name)

        def timed(self, *a, verb=verb, name=name, **k):
            t = time.perf_counter()
            try:
                return verb(self, *a, **k)
            finally:
                stamp(name, s=round(time.perf_counter() - t, 4))

        setattr(F.EngineFleet, name, timed)
    drain = S.LLMServer.begin_drain

    def noted_drain(self):
        stamp("sigterm")
        return drain(self)

    S.LLMServer.begin_drain = noted_drain
    return events, peak


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--configs", nargs="+", default=["c", "e"],
                    choices=list("abcdef"))
    ap.add_argument("--repeat", type=int, default=1)
    ap.add_argument("--out", help="also write every run to this JSON file")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("front_door_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    import paddle_tpu_torch as P
    from paddle_tpu_torch.ops_cuda import _build
    from paddle_tpu_torch.serving import engine as E
    from paddle_tpu_torch.serving import fleet as F
    from paddle_tpu_torch.serving import graphs as G
    from paddle_tpu_torch.serving import server as S
    from paddle_tpu_torch.serving import slo as SLO
    card = cs.card_line()
    print(f"card: {card}", flush=True)
    _build.build(["decode_attention", "int8_linear"])
    model = cs.gpt_small_bf16(torch, P)
    clock = [time.perf_counter()]
    events, peak = instrument(S, E, G, F, SLO, clock)
    flags = {tag: argv for tag, _, argv, *_ in cs.FRONT_DOOR_CONFIGS}
    runs = []
    for tag in args.configs:
        for i in range(args.repeat):
            events.clear()
            peak.clear()
            gc.collect()
            with tempfile.TemporaryDirectory() as d:
                soak = S.soak_parser().parse_args(
                    ["--server-out", os.path.join(d, "SERVER.json"),
                     *flags[tag]])
                clock[0] = time.perf_counter()
                rc, rep, extra = S.run_soak(model, soak)
            runs.append({"config": tag, "turn": i, "rc": rc, "report": rep,
                         "extra": extra, "peak_live": dict(peak),
                         "events": list(events)})
            print(f"({tag}) turn {i} [card: {card}]: rc {rc}, stranded "
                  f"{rep['stranded_count']}, peak live behaved streams "
                  f"{peak.get('behaved', 0)}, ttft_p99 steady "
                  f"{rep['ttft_p99_steady_ms']:.2f} ms, under shedding "
                  f"{rep['ttft_p99_shed_ms']:.2f} ms, tail ratio "
                  f"{rep['ttft_tail_ratio']}, {extra['soak_s']:.1f} s",
                  flush=True)
            for ev in events:
                if ev[1] != "live":
                    print(f"    {ev}", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "runs": runs}, f, indent=1,
                      default=str)
    return 0


if __name__ == "__main__":
    sys.exit(main())
