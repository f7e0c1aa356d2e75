"""The port's front door: the drain pickle and the soak.

- A paged drain with a parked (swapped-out) request writes a snapshot to
  `drain_path` whose host pages are each leaf's own bytes, not views of
  the pinned gather buffer (pickled, a view writes its whole storage);
  the engine rebuilt by `load_engine(prefix, snapshot=...)` continues
  every stream bit-identically to an uninterrupted run, the parked one
  uploading its pages (no prefill).
- `warm_up` builds each program a served backend runs once, the replay
  step's included.
- `python -m paddle_tpu_torch.serving.server --device cpu` at a reduced
  size, slotted and `--paged`, exits 0 and writes the reference's
  SERVER.json keys, with its gates at the reference's values.
- `run_soak(served=...)` sees the backends that served, stopped, before
  the verdicts' reference engine is built.
"""
import json
import os
import pickle
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from paddle_tpu_torch.models import gpt_tiny
from paddle_tpu_torch.serving import (EngineFleet, LLMEngine, LLMServer,
                                      SamplingParams, load_engine,
                                      save_for_serving)
from paddle_tpu_torch.serving.server import own_bytes

from port_threads import one_torch_thread  # noqa: F401 — autouse fixture
from test_torch_server import (_http, _open_sse, _read_event,
                               _stream_tokens, _wait)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAGED = dict(max_slots=2, max_seq=128, seed=7, kv_layout="paged",
             page_size=8, decode_block_size=1, overlap=False)


def _leaves(snap):
    out = []
    for r in snap.get("swapped", ()) + snap.get("queued", ()) \
            + snap.get("active", ()):
        kv = r.get("kv_pages")
        if kv:
            for lay in list(kv["k"]) + list(kv["v"]):
                out += [lay["q"], lay["s"]] if isinstance(lay, dict) \
                    else [lay]
    return out


def test_own_bytes_copies_views_only():
    buf = torch.arange(64, dtype=torch.float32)
    whole = torch.zeros(4)
    snap = {"a": [buf[8:16], whole], "b": (buf[:4].view(2, 2),),
            "n": np.arange(3), "s": "x"}
    out = own_bytes(snap)
    assert out["a"][1] is whole and out["n"] is snap["n"]
    for t, src in ((out["a"][0], buf[8:16]), (out["b"][0], buf[:4])):
        assert t.untyped_storage().nbytes() == t.numel() * 4
        assert torch.equal(t.reshape(-1), src.reshape(-1))
    assert isinstance(out["b"], tuple)


def test_paged_drain_pickles_own_bytes_and_resumes(tmp_path):
    model = gpt_tiny(seed=0, device="cpu")
    prefix = save_for_serving(model, str(tmp_path / "gpt"))
    rng = np.random.RandomState(11)
    prompts = [[int(t) for t in rng.randint(1, 1000, (n,))]
               for n in (21, 13)]
    ref_eng = LLMEngine(model, device="cpu", register_stats=False,
                        **PAGED)
    want = [r.token_ids for r in ref_eng.generate(
        [np.asarray(p, np.int32) for p in prompts],
        SamplingParams(max_new_tokens=40))]
    drain_path = str(tmp_path / "drain.pkl")
    eng = load_engine(prefix, device="cpu", register_stats=False, **PAGED)
    srv = LLMServer(eng, close_backend=True, drain_grace_s=0.05,
                    drain_path=drain_path)
    h = srv.run_in_thread()
    socks, got, rids = [], [], []
    for p in prompts:
        s, f, st = _open_sse(h.port, {"prompt": p, "max_tokens": 40,
                                      "stream": True})
        assert st == 200
        ev = _read_event(f)
        socks.append((s, f))
        rids.append(ev["id"])
        got.append(list(ev["token_ids"]))
    # park the first request: its pages go to host memory
    assert srv.worker.call(lambda: eng.swap_out(rids[0])).result(30)
    raw = srv.worker.call(lambda: len(pickle.dumps(eng.snapshot()))
                          ).result(30)
    holder = {}
    t = threading.Thread(target=lambda: holder.update(snap=h.drain(30)))
    t.start()
    for i, (s, f) in enumerate(socks):
        while True:
            ev = _read_event(f)
            assert ev is not None
            if ev.get("drain"):
                assert ev["delivered"] == len(got[i])
                break
            got[i].extend(ev.get("token_ids", ()))
        s.close()
    t.join(30)
    assert holder["snap"] is not None
    size = os.path.getsize(drain_path)
    with open(drain_path, "rb") as f:
        snap = pickle.load(f)
    assert [r["rid"] for r in snap["swapped"]] == [rids[0]]
    leaves = _leaves(snap)
    own = sum(t.numel() * t.element_size() for t in leaves)
    assert own > 0 and all(
        t.untyped_storage().nbytes() == t.numel() * t.element_size()
        for t in leaves)
    # the payloads' own bytes, plus the rest of the snapshot; a pickle
    # of the views writes the gather buffer once per leaf (2 x 4 layers)
    print(f"drain pickle {size} B, payload leaves {own} B, pickled "
          f"views {raw} B")
    assert own < size < own + 32768
    assert raw > 4 * own

    eng2 = load_engine(prefix, snapshot=snap, register_stats=False)
    assert eng2.swapped_rids == [rids[0]]
    srv2 = LLMServer(eng2, close_backend=True, owners=srv.drain_owners)
    h2 = srv2.run_in_thread()
    try:
        assert srv2.worker.call(lambda: eng2.swap_in(rids[0])).result(30)
        for i, rid in enumerate(rids):
            st, _, body = _http(h2.port, "GET",
                                f"/v1/completions/{rid}?from={len(got[i])}")
            assert st == 200
            _, toks, fin = _stream_tokens(body)
            assert fin == "length"
            got[i].extend(toks)
        st = srv2.worker.call(eng2.stats).result(30)
        assert st["swap_ins"] == 1
        assert _wait(lambda: srv2.slo.inflight == 0)
    finally:
        h2.stop()
    assert got == [list(w) for w in want]


def test_warm_up_builds_each_program_once():
    """`warm_up` builds the plain decode block (which a continuation's
    replay steps run too), the speculative one and the prefill programs
    of the given lengths' pieces; traffic, a snapshot and a resume's
    replay build nothing more on the warmed engine, and the watchdog
    sees one build per program."""
    model = gpt_tiny(seed=0, device="cpu")
    kw = dict(max_slots=2, max_seq=64, seed=7, prefill_chunk=16,
              speculate_k=2, register_stats=False, device="cpu")
    eng = LLMEngine(model, **kw)
    assert eng.warm_up([5, 40]) == 3         # plain, spec, 128 rows
    assert eng.warm_up([5, 40]) == 0
    assert sorted(eng._prefill_runners) == [128]
    p = np.arange(1, 12, dtype=np.int32)
    rid = eng.submit(p, SamplingParams(max_new_tokens=12))
    while eng.stats()["generated_tokens"] < 3:
        eng.step()
    eng2 = LLMEngine.resume(model, eng.snapshot(), register_stats=False)
    assert eng2.metrics.replay_steps > 0
    eng.run_until_complete()
    eng2.run_until_complete()
    assert eng2.result(rid).token_ids == eng.result(rid).token_ids
    counts = eng.watchdog.counts()
    assert counts["decode"]["compiles"] == counts["spec_decode"][
        "compiles"] == counts["prefill"]["compiles"] == 1
    assert sorted(eng2._runners) == [False, True]   # resume replayed
    assert eng.watchdog.compiles_unexpected == 0
    assert eng2.watchdog.compiles_unexpected == 0
    fleet = EngineFleet(model, replicas=2, **kw)
    assert fleet.warm_up([5]) == 6
    fleet.close()


# the reference's SERVER.json keys (`paddle_tpu/serving/server.py`'s
# report, without --autoscale)
SERVER_KEYS = {
    "requests", "flood_requests", "shed_count",
    "sheds_missing_retry_after", "disconnected_streams", "drained",
    "drain_snapshot", "reattached_streams", "killed_replica",
    "stranded_count", "bit_mismatches", "exposition_ok",
    "ttft_p99_shed_ms", "ttft_p99_steady_ms", "decode_ms_per_token",
    "ttft_tail_ratio", "tail_gate_ratio", "tail_gate_ok",
    "prefill_budget", "paged", "tp", "kv_dtype", "kv_bytes_per_token",
    "leaked_pages", "speculate_k", "spec_proposed", "spec_accepted",
    "spec_fallbacks", "spec_acceptance_rate"}


@pytest.mark.parametrize("knobs", [[], ["--paged"]],
                         ids=["slotted", "paged"])
def test_cpu_soak_exits_0_with_the_reference_keys(tmp_path, knobs):
    out = tmp_path / "SERVER.json"
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    proc = subprocess.run(
        [sys.executable, "-W", "ignore", "-m",
         "paddle_tpu_torch.serving.server", "--device", "cpu",
         "--requests", "16", "--flood", "8", "--drain-after", "3",
         "--max-new-tokens", "6", "--spacing-ms", "100",
         "--server-out", str(out), *knobs],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    report = json.loads(out.read_text())
    assert set(report) == SERVER_KEYS
    assert report["stranded_count"] == 0 and report["bit_mismatches"] == 0
    assert report["drained"] and report["exposition_ok"]
    assert report["shed_count"] > 0
    assert report["sheds_missing_retry_after"] == 0
    assert report["tail_gate_ratio"] == 400.0 and report["tail_gate_ok"]
    assert report["leaked_pages"] == 0
    assert report["paged"] == bool(knobs)


SERVED = r"""
import json
from paddle_tpu_torch.models import gpt_tiny
from paddle_tpu_torch.serving import engine as E
from paddle_tpu_torch.serving import server as S
built, seen = [], []
init = E.LLMEngine.__init__
def tracked(self, *a, **kw):
    init(self, *a, **kw)
    built.append(self)
E.LLMEngine.__init__ = tracked
def served(backends):
    seen.append({"same": [b is e for b, e in zip(backends, built)],
                 "served": len(backends), "built": len(built),
                 "closed": [b._closed for b in backends],
                 "steps": sum(b.stats()["decode_steps"] for b in backends)})
model = gpt_tiny(seed=0, device="cpu")
model.eval()
args = S.soak_parser().parse_args(
    ["--device", "cpu", "--requests", "8", "--flood", "8",
     "--drain-after", "3", "--max-new-tokens", "6", "--spacing-ms", "100",
     "--server-out", SERVER_OUT])
rc, rep, _ = S.run_soak(model, args, served=served)
print("SERVED " + json.dumps({"rc": rc, "seen": seen, "built": len(built),
                              "drained": rep["drained"]}))
"""


def test_served_sees_the_served_backends_before_the_reference(tmp_path):
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    code = SERVED.replace("SERVER_OUT", repr(str(tmp_path / "S.json")))
    proc = subprocess.run([sys.executable, "-W", "ignore", "-c", code],
                          cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("SERVED ")][-1]
    out = json.loads(line[len("SERVED "):])
    assert out["rc"] == 0 and out["drained"]
    # one call, with the first server's engine and the restarted one's,
    # both stopped; the reference engine came after it
    assert len(out["seen"]) == 1
    seen = out["seen"][0]
    assert seen["served"] == seen["built"] == 2
    assert seen["same"] == [True, True] and seen["closed"] == [True, True]
    assert seen["steps"] > 0
    assert out["built"] == 3


def test_tp_is_not_ported():
    """`--tp` is ported (the `--tp 2` soak runs in
    tests/test_torch_tp_serving.py): it reaches the engine, whose head
    check rejects a degree gpt_tiny's 4 heads do not divide by."""
    from paddle_tpu_torch.serving.server import main
    with pytest.raises(ValueError, match="not divisible by tp=3"):
        main(["--device", "cpu", "--tp", "3"])
