"""The port's HTTP front door (`paddle_tpu_torch.serving.server`) on the
CPU, the counterpart of `tests/test_server.py`'s HTTP cases, against the
port's engine and a 2-replica fleet on `gpt_tiny` with the JAX model's
weights (through `models.load_jax_params`).

- Greedy streams through the server, JSON and SSE, equal the port's
  library `generate()` and the JAX library engine's (reference top-2
  margins > 1e-3, logged); best-of-n (`n=2`) answers equal the library
  group's.
- Shaped overload: 400 without a debit, 404, 429 with Retry-After for
  the token budget, the stream cap and backpressure (the engine's
  overload counter stays 0), the behaved tenant unharmed by a flood.
- Disconnect = cancel (the slot and the prefix pins freed), the
  `http_write` and `client_disconnect` fault points, a `_wcall` timeout
  releasing its admission, a replaced stream releasing its admission.
- Drain: a snapshot with live streams notified, reattach by id on a
  resumed engine (gapless, tenant-scoped), 503 while draining, reattach
  after finish from the server's record.
- Fleet: healthz reads the replica states on the worker thread; streams
  survive a replica kill bitwise.
"""
import asyncio
import contextlib
import json
import socket
import threading
import time

import numpy as np
import pytest

import paddle_tpu as pt
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu.serving import LLMEngine as JaxEngine
from paddle_tpu.serving import SamplingParams as JaxParams
from paddle_tpu_torch.models import gpt_tiny, load_jax_params
from paddle_tpu_torch.obs import parse_exposition
from paddle_tpu_torch.serving import (EngineFleet, LLMEngine, LLMServer,
                                      SamplingParams, TenantPolicy)
from paddle_tpu_torch.testing import faults

from port_streams import reference_margins
from port_threads import one_torch_thread  # noqa: F401 — autouse fixture

CFG = dict(max_slots=2, max_seq=64, seed=7, prefix_block=8,
           register_stats=False)
# one dispatch per token: a request is provably still live when the
# test acts on it
SLOW = {"max_seq": 256, "decode_block_size": 1, "overlap": False}


@pytest.fixture(scope="module")
def jax_model():
    pt.seed(0)
    m = jax_gpt_tiny()
    m.eval()
    return m


@pytest.fixture(scope="module")
def model(jax_model):
    np_params = {k: np.asarray(v)
                 for k, v in jax_model.raw_parameters().items()}
    return load_jax_params(gpt_tiny(device="cpu"), np_params)


# --------------------------------------------------------------------------- #
# HTTP helpers (raw sockets: stdlib-only clients, like real traffic)
# --------------------------------------------------------------------------- #


def _http(port, method, path, body=None, tenant=None, timeout=60):
    s = socket.create_connection(("127.0.0.1", port), timeout=timeout)
    payload = json.dumps(body).encode() if body is not None else b""
    hdr = (f"{method} {path} HTTP/1.1\r\nHost: t\r\n"
           f"Content-Type: application/json\r\n"
           f"Content-Length: {len(payload)}\r\n")
    if tenant:
        hdr += f"X-Tenant: {tenant}\r\n"
    hdr += "Connection: close\r\n\r\n"
    s.sendall(hdr.encode() + payload)
    data = b""
    while True:
        c = s.recv(65536)
        if not c:
            break
        data += c
    s.close()
    head, _, rest = data.partition(b"\r\n\r\n")
    lines = head.decode("latin-1").splitlines()
    status = int(lines[0].split()[1])
    headers = {}
    for ln in lines[1:]:
        k, _, v = ln.partition(":")
        headers[k.strip().lower()] = v.strip()
    return status, headers, rest


def _sse_events(raw: bytes):
    out = []
    for line in raw.decode().splitlines():
        if line.startswith("data: ") and line != "data: [DONE]":
            out.append(json.loads(line[len("data: "):]))
    return out


def _stream_tokens(raw: bytes):
    toks, fin, rid = [], None, -1
    for ev in _sse_events(raw):
        rid = ev.get("id", rid)
        toks.extend(ev.get("token_ids", ()))
        fin = ev.get("finish_reason", fin)
    return rid, toks, fin


def _open_sse(port, body, tenant=None, timeout=60):
    """A streaming POST, its body UNREAD: (sock, file, status)."""
    s = socket.create_connection(("127.0.0.1", port), timeout=timeout)
    payload = json.dumps(body).encode()
    hdr = (f"POST /v1/completions HTTP/1.1\r\nHost: t\r\n"
           f"Content-Type: application/json\r\n"
           f"Content-Length: {len(payload)}\r\n")
    if tenant:
        hdr += f"X-Tenant: {tenant}\r\n"
    hdr += "Connection: close\r\n\r\n"
    s.sendall(hdr.encode() + payload)
    f = s.makefile("rb")
    status = int(f.readline().split()[1])
    while True:
        ln = f.readline()
        if ln in (b"\r\n", b"\n", b""):
            break
    return s, f, status


def _read_event(f):
    """One SSE data event (dict), or None on [DONE]/EOF."""
    while True:
        ln = f.readline()
        if not ln:
            return None
        ln = ln.strip()
        if ln == b"data: [DONE]":
            return None
        if ln.startswith(b"data: "):
            return json.loads(ln[len(b"data: "):].decode())


@contextlib.contextmanager
def _server(model, policies=None, engine_kw=None, fleet=None, **kw):
    if fleet:
        backend = EngineFleet(model, replicas=fleet, device="cpu",
                              quarantine_backoff_s=0.0, snapshot_every=2,
                              **{**CFG, **(engine_kw or {})})
    else:
        backend = LLMEngine(model, device="cpu",
                            **{**CFG, **(engine_kw or {})})
    srv = LLMServer(backend, policies=policies, close_backend=True, **kw)
    handle = srv.run_in_thread()
    try:
        yield handle, srv, backend
    finally:
        handle.stop()


def _ref(model, prompts, max_new, **kw):
    eng = LLMEngine(model, device="cpu", **{**CFG, **kw})
    try:
        return [r.token_ids for r in eng.generate(
            [np.asarray(p, np.int32) for p in prompts],
            SamplingParams(max_new_tokens=max_new))]
    finally:
        eng.close()


def _prompts(n, lo=4, hi=12, seed=0):
    rng = np.random.RandomState(seed)
    return [[int(t) for t in rng.randint(1, 512,
                                         (int(rng.randint(lo, hi)),))]
            for _ in range(n)]


def _wait(cond, timeout=10.0):
    deadline = time.time() + timeout
    while time.time() < deadline and not cond():
        time.sleep(0.02)
    return cond()


def _level(srv, tenant):
    b = srv.slo._buckets.get(tenant)
    return None if b is None else b.level


# --------------------------------------------------------------------------- #
# streams: bit-identity with the library, both packages
# --------------------------------------------------------------------------- #


class TestStreams:
    def test_json_and_sse_equal_the_library_and_the_jax_engine(
            self, model, jax_model):
        prompts = _prompts(3, seed=1)
        ref = _ref(model, prompts, 8)
        jeng = JaxEngine(jax_model, **CFG)
        want = [r.token_ids for r in jeng.generate(
            [np.asarray(p, np.int32) for p in prompts],
            JaxParams(max_new_tokens=8))]
        margins = reference_margins(
            jax_model, [np.asarray(p, np.int32) for p in prompts], want)
        print(f"JAX reference top-2 margins: {margins}")
        assert min(margins) > 1e-3
        assert [list(r) for r in ref] == [list(w) for w in want]
        with _server(model) as (h, srv, eng):
            for p, w in zip(prompts, want):
                st, _, body = _http(h.port, "POST", "/v1/completions",
                                    {"prompt": p, "max_tokens": 8})
                assert st == 200
                out = json.loads(body)
                assert out["token_ids"] == list(w)
                assert out["usage"]["completion_tokens"] == len(w)
                st, hdrs, body = _http(
                    h.port, "POST", "/v1/completions",
                    {"prompt": p, "max_tokens": 8, "stream": True})
                assert st == 200
                rid, toks, fin = _stream_tokens(body)
                assert toks == list(w) and fin in ("stop", "length")
                assert hdrs["x-request-id"] == str(rid)
                # the first token arrives in its own event (admission),
                # later blocks follow: never one blob
                assert len([e for e in _sse_events(body)
                            if "token_ids" in e]) >= 2
                assert body.rstrip().endswith(b"data: [DONE]")

    def test_speculative_backend_streams_equal_spec_off(self, model):
        prompts = _prompts(2, seed=3)
        ref = _ref(model, prompts, 10)
        with _server(model, engine_kw={"speculate_k": 2}) \
                as (h, srv, eng):
            for p, want in zip(prompts, ref):
                st, _, body = _http(
                    h.port, "POST", "/v1/completions",
                    {"prompt": p, "max_tokens": 10, "stream": True})
                assert st == 200
                assert _stream_tokens(body)[1] == list(want)
            assert eng.stats()["spec_blocks"] > 0

    def test_best_of_n_json_and_sse_equal_the_library_group(self, model):
        p = _prompts(1, lo=9, hi=10, seed=4)[0]
        knobs = dict(max_new_tokens=6, temperature=0.8, top_k=20, n=2)
        kw = {**CFG, "max_slots": 4}

        def library():
            eng = LLMEngine(model, device="cpu", **kw)
            g = eng.generate([np.asarray(p, np.int32)],
                             SamplingParams(**knobs))[0]
            eng.close()
            return [g.token_ids] + [s.token_ids for s in g.siblings]

        want = library()
        assert want[0] != want[1]                # sampled, not copies
        body = {"prompt": p, "max_tokens": 6, "temperature": 0.8,
                "top_k": 20, "n": 2}
        with _server(model, engine_kw={"max_slots": 4}) as (h, srv, eng):
            st, _, raw = _http(h.port, "POST", "/v1/completions", body)
            assert st == 200
            out = json.loads(raw)
            assert [c["token_ids"] for c in out["choices"]] == want
            assert [c["index"] for c in out["choices"]] == [0, 1]
            assert out["usage"]["completion_tokens"] == 12
        with _server(model, engine_kw={"max_slots": 4}) as (h, srv, eng):
            st, hdrs, raw = _http(h.port, "POST", "/v1/completions",
                                  {**body, "stream": True})
            assert st == 200 and hdrs["x-choices"] == "2"
            got = [[], []]
            for ev in _sse_events(raw):
                got[ev["choice"]].extend(ev.get("token_ids", ()))
            assert got == want
            assert srv.slo.inflight == 0
            st, _, raw = _http(h.port, "POST", "/v1/completions",
                               {**body, "n": 5})      # > max_slots
            assert st == 400 and b"n/best_of" in raw


# --------------------------------------------------------------------------- #
# shaped overload
# --------------------------------------------------------------------------- #


class TestOverload:
    def test_invalid_request_400_no_budget_debit(self, model):
        pol = {"t": TenantPolicy(tokens_per_s=10.0, burst_tokens=100.0)}
        with _server(model, policies=pol) as (h, srv, eng):
            st, _, body = _http(h.port, "POST", "/v1/completions",
                                {"prompt": [1] * 60, "max_tokens": 30},
                                tenant="t")
            assert st == 400 and b"max_seq" in body
            st, _, _ = _http(h.port, "POST", "/v1/completions",
                             {"prompt": "nope"}, tenant="t")
            assert st == 400
            assert _level(srv, "t") in (None, 100.0)
            assert srv.metrics.shed == {}

    def test_unknown_route_and_rid_404(self, model):
        with _server(model) as (h, srv, eng):
            assert _http(h.port, "GET", "/nope")[0] == 404
            assert _http(h.port, "GET", "/v1/completions/999")[0] == 404

    def test_healthz_and_metrics_parse_with_tenant_labels(self, model):
        with _server(model) as (h, srv, eng):
            st, _, body = _http(h.port, "GET", "/healthz")
            assert st == 200 and json.loads(body)["status"] == "serving"
            for p in _prompts(2, seed=3):
                _http(h.port, "POST", "/v1/completions",
                      {"prompt": p, "max_tokens": 4}, tenant="acme")
            st, _, body = _http(h.port, "GET", "/metrics")
            assert st == 200
            fams = parse_exposition(body.decode())
            reqs = fams["paddle_tpu_server_requests_total"]["samples"]
            assert any(lab.get("tenant") == "acme" and v == 2
                       for _, lab, v in reqs)
            # the backend's exposition rides in the same scrape
            assert "paddle_tpu_serving_requests_submitted_total" in fams
            ttft = fams["paddle_tpu_server_ttft_seconds"]["samples"]
            assert any(lab.get("tenant") == "acme"
                       and lab.get("quantile") == "0.99"
                       for _, lab, v in ttft)

    def test_budget_shed_429_with_retry_after(self, model):
        pol = {"t": TenantPolicy(tokens_per_s=1.0, burst_tokens=5.0)}
        with _server(model, policies=pol) as (h, srv, eng):
            st, hdrs, body = _http(h.port, "POST", "/v1/completions",
                                   {"prompt": [1, 2, 3, 4],
                                    "max_tokens": 8}, tenant="t")
            assert st == 429 and int(hdrs["retry-after"]) >= 1
            assert json.loads(body)["error"]["reason"] == "token_budget"
            assert srv.metrics.shed[("t", "token_budget")] == 1
            assert eng.stats()["requests_submitted"] == 0

    def test_paged_backend_charges_pages(self, model):
        with _server(model, engine_kw={"kv_layout": "paged",
                                       "page_size": 16}) as (h, srv, eng):
            assert srv.slo.charge_unit == "pages"
            assert srv.slo.page_size == 16

    def test_stream_cap_shed_while_stream_live(self, model):
        pol = {"t": TenantPolicy(max_streams=1)}
        with _server(model, policies=pol, engine_kw=SLOW) \
                as (h, srv, eng):
            s, f, st = _open_sse(h.port, {"prompt": [1, 2, 3],
                                          "max_tokens": 60,
                                          "stream": True}, tenant="t")
            assert st == 200 and _read_event(f) is not None
            st2, hdrs, body = _http(h.port, "POST", "/v1/completions",
                                    {"prompt": [4, 5], "max_tokens": 4},
                                    tenant="t")
            assert st2 == 429 and "retry-after" in hdrs
            assert json.loads(body)["error"]["reason"] == "stream_cap"
            while _read_event(f) is not None:
                pass
            s.close()

    def test_backpressure_shapes_and_engine_never_overflows(self,
                                                            model):
        # inflight cap == the engine's max_queue (2): a concurrent burst
        # sheds at the SERVER, and the engine's own overload counter
        # stays 0
        with _server(model, engine_kw={"max_queue": 2},
                     policies={}) as (h, srv, eng):
            results = []

            def fire(p):
                results.append(_http(h.port, "POST", "/v1/completions",
                                     {"prompt": p, "max_tokens": 16}))

            threads = [threading.Thread(target=fire, args=(p,))
                       for p in _prompts(8, seed=4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            codes = sorted(st for st, _, _ in results)
            assert codes.count(200) >= 1 and 429 in codes
            for st, hdrs, body in results:
                if st == 429:
                    assert "retry-after" in hdrs
                    assert json.loads(body)["error"]["reason"] == \
                        "backpressure"
            assert eng.stats()["rejected_overload"] == 0

    def test_behaved_tenant_unharmed_by_flooding_tenant(self, model):
        pol = {"pro": TenantPolicy(priority=1),
               "flood": TenantPolicy(tokens_per_s=20.0,
                                     burst_tokens=40.0, max_streams=2)}
        with _server(model, policies=pol) as (h, srv, eng):
            flood_codes, pro_codes = [], []

            def flood():
                for p in _prompts(6, seed=5):
                    flood_codes.append(_http(
                        h.port, "POST", "/v1/completions",
                        {"prompt": p, "max_tokens": 10},
                        tenant="flood")[0])

            def pro():
                for p in _prompts(4, seed=6):
                    pro_codes.append(_http(
                        h.port, "POST", "/v1/completions",
                        {"prompt": p, "max_tokens": 6}, tenant="pro")[0])

            tf, tp = (threading.Thread(target=flood),
                      threading.Thread(target=pro))
            tf.start(), tp.start()
            tf.join(), tp.join()
            assert pro_codes == [200, 200, 200, 200]
            assert 429 in flood_codes
            stat = srv.metrics.ttft.get("pro")
            assert stat is not None and stat.count == 4
            assert stat.quantile(0.99) < 30.0


# --------------------------------------------------------------------------- #
# disconnect = cancel, fault points, admission pairing
# --------------------------------------------------------------------------- #


class TestDisconnect:
    def test_disconnect_cancels_and_frees_slot_and_pins(self, model):
        with _server(model, engine_kw=SLOW) as (h, srv, eng):
            s, f, st = _open_sse(h.port, {"prompt": [9, 8, 7, 6],
                                          "max_tokens": 80,
                                          "stream": True})
            assert st == 200
            first = _read_event(f)
            assert first and first["token_ids"]
            f.close()
            s.close()
            assert _wait(lambda: eng.stats()["requests_cancelled"] >= 1
                         and eng.stats()["slots_active"] == 0)
            assert srv.metrics.disconnects.get("default") == 1
            if eng.prefix is not None:               # no leaked pins
                stack = list(eng.prefix.root.children.values())
                while stack:
                    n = stack.pop()
                    assert n.ref == 0
                    stack.extend(n.children.values())
            # the reaper collected the cancelled result
            assert _wait(lambda: any(d["finish_reason"] == "cancelled"
                                     for d in list(srv._done.values())))
            assert srv.slo.inflight == 0

    def test_http_write_fault_is_a_disconnect(self, model):
        plan = faults.FaultPlan().fail_at("http_write", 2)
        with faults.inject(plan):
            with _server(model) as (h, srv, eng):
                st, _, body = _http(h.port, "POST", "/v1/completions",
                                    {"prompt": [1, 2, 3],
                                     "max_tokens": 30, "stream": True})
                assert st == 200
                assert _wait(
                    lambda: eng.stats()["requests_cancelled"] >= 1
                    and eng.stats()["slots_active"] == 0)
                assert srv.metrics.disconnects.get("default") == 1
        assert plan.injected["http_write"] == 1
        rid, toks, fin = _stream_tokens(body)
        assert fin is None and toks        # a truncated, valid prefix

    def test_client_disconnect_fault_cancels(self, model):
        plan = faults.FaultPlan().fail_at("client_disconnect", 2)
        with faults.inject(plan):
            with _server(model) as (h, srv, eng):
                st, _, _ = _http(h.port, "POST", "/v1/completions",
                                 {"prompt": [4, 5, 6],
                                  "max_tokens": 30, "stream": True})
                assert st == 200
                assert _wait(
                    lambda: eng.stats()["requests_cancelled"] >= 1)
        assert plan.injected["client_disconnect"] == 1

    def test_wcall_timeout_releases_admission(self, model):
        with _server(model) as (h, srv, backend):
            async def _boom(fn):
                raise asyncio.TimeoutError()

            orig = srv._wcall
            srv._wcall = _boom
            try:
                status, _, _ = _http(h.port, "POST", "/v1/completions",
                                     {"prompt": [1, 2, 3],
                                      "max_tokens": 4})
                assert status == 500
                assert srv.slo.inflight == 0
                assert srv.slo.streams_active("default") == 0
            finally:
                srv._wcall = orig
            status, _, raw = _http(h.port, "POST", "/v1/completions",
                                   {"prompt": [1, 2, 3], "max_tokens": 4})
            assert status == 200 and json.loads(raw)["token_ids"]

    def test_replaced_stream_releases_admission(self, model):
        with _server(model, engine_kw=SLOW) as (h, srv, eng):
            s1, f1, st = _open_sse(h.port, {"prompt": [2, 7, 1],
                                            "max_tokens": 60,
                                            "stream": True}, tenant="t")
            assert st == 200
            rid = _read_event(f1)["id"]
            st, _, body = _http(h.port, "GET",
                                f"/v1/completions/{rid}?from=0",
                                tenant="t")
            assert st == 200
            _, toks, fin = _stream_tokens(body)
            assert fin in ("stop", "length") and len(toks) == 60
            f1.close()
            s1.close()
            assert _wait(lambda: srv.slo.inflight == 0)
            assert srv.slo.streams_active("t") == 0


# --------------------------------------------------------------------------- #
# drain and reattach
# --------------------------------------------------------------------------- #


class TestDrain:
    def test_drain_snapshots_and_streams_reattach(self, model):
        prompts = _prompts(2, lo=5, hi=9, seed=7)
        ref = _ref(model, prompts, 60, **SLOW)
        with _server(model, drain_grace_s=0.05, engine_kw=SLOW) \
                as (h, srv, eng):
            socks = []
            for p in prompts:
                s, f, st = _open_sse(h.port, {"prompt": p,
                                              "max_tokens": 60,
                                              "stream": True})
                assert st == 200
                socks.append((s, f))
            got = [[] for _ in socks]
            rids = [None] * len(socks)
            for i, (s, f) in enumerate(socks):
                ev = _read_event(f)
                rids[i] = ev["id"]
                got[i].extend(ev["token_ids"])
            holder = {}
            t = threading.Thread(
                target=lambda: holder.update(snap=h.drain(timeout=30)))
            t.start()
            for i, (s, f) in enumerate(socks):
                while True:
                    ev = _read_event(f)
                    if ev is None or ev.get("drain"):
                        assert ev is not None
                        assert ev["delivered"] == len(got[i])
                        break
                    got[i].extend(ev.get("token_ids", ()))
                s.close()
            t.join(timeout=30)
            snap = holder.get("snap")
        assert snap is not None                      # work was left
        eng2 = LLMEngine.resume(model, snap, register_stats=False)
        srv2 = LLMServer(eng2, close_backend=True,
                         owners=srv.drain_owners)
        h2 = srv2.run_in_thread()
        try:
            # tenant-scoped across the restart
            assert _http(h2.port, "GET",
                         f"/v1/completions/{rids[0]}?from=0",
                         tenant="mallory")[0] == 404
            for i, rid in enumerate(rids):
                st, _, body = _http(
                    h2.port, "GET",
                    f"/v1/completions/{rid}?from={len(got[i])}")
                assert st == 200
                _, toks, fin = _stream_tokens(body)
                got[i].extend(toks)
                assert fin in ("stop", "length")
            assert srv2.metrics.reattached_streams == len(rids)
        finally:
            h2.stop()
        for i, want in enumerate(ref):
            assert got[i] == list(want)              # gapless

    def test_draining_sheds_new_work_503(self, model):
        with _server(model, drain_grace_s=10.0, engine_kw=SLOW) \
                as (h, srv, eng):
            s, f, st = _open_sse(h.port, {"prompt": [1, 2, 3],
                                          "max_tokens": 60,
                                          "stream": True})
            assert st == 200 and _read_event(f) is not None
            h.call_soon(srv.begin_drain)
            assert _wait(lambda: srv.draining, 5.0)
            st2, hdrs, _ = _http(h.port, "POST", "/v1/completions",
                                 {"prompt": [4], "max_tokens": 2})
            assert st2 == 503 and "retry-after" in hdrs
            assert srv.metrics.shed[("default", "draining")] == 1
            st3, _, body = _http(h.port, "GET", "/healthz")
            assert st3 == 503 and json.loads(body)["status"] == \
                "draining"
            while _read_event(f) is not None:
                pass                                 # in-flight work
            s.close()                                # still finishes

    def test_reattach_is_tenant_scoped(self, model):
        with _server(model) as (h, srv, eng):
            st, _, body = _http(h.port, "POST", "/v1/completions",
                                {"prompt": [3, 1, 4], "max_tokens": 4,
                                 "stream": True}, tenant="alice")
            rid, toks, _ = _stream_tokens(body)
            assert st == 200 and len(toks) == 4
            assert _http(h.port, "GET", f"/v1/completions/{rid}?from=0",
                         tenant="mallory")[0] == 404
            st, _, body = _http(h.port, "GET",
                                f"/v1/completions/{rid}?from=0",
                                tenant="alice")
            assert st == 200 and _stream_tokens(body)[1] == toks

    def test_reattach_after_finish_replays_from_record(self, model):
        with _server(model) as (h, srv, eng):
            st, _, body = _http(h.port, "POST", "/v1/completions",
                                {"prompt": [5, 6, 7], "max_tokens": 5,
                                 "stream": True})
            rid, toks, _ = _stream_tokens(body)
            assert st == 200 and len(toks) == 5
            st, _, body = _http(h.port, "GET",
                                f"/v1/completions/{rid}?from=2")
            assert st == 200
            _, tail, fin = _stream_tokens(body)
            assert tail == toks[2:] and fin in ("stop", "length")


# --------------------------------------------------------------------------- #
# fleet backend
# --------------------------------------------------------------------------- #


class TestFleetBackend:
    def test_healthz_replica_states_read_on_worker_thread(self, model):
        with _server(model, fleet=2) as (h, srv, fleet):
            seen = {}
            orig_stats, orig_states = fleet.stats, fleet.replica_states

            def stats_spy():
                seen["stats"] = threading.current_thread().name
                return orig_stats()

            def states_spy():
                seen["states"] = threading.current_thread().name
                return orig_states()

            fleet.stats, fleet.replica_states = stats_spy, states_spy
            try:
                status, _, raw = _http(h.port, "GET", "/healthz")
            finally:
                del fleet.stats, fleet.replica_states
            assert status == 200
            payload = json.loads(raw)
            assert payload["replica_states"] == ["healthy", "healthy"]
            assert payload["replicas_serving"] == 2
            assert seen == {"stats": "engine-worker",
                            "states": "engine-worker"}

    def test_streams_survive_replica_kill(self, model):
        prompts = _prompts(4, lo=5, hi=10, seed=8)
        ref = _ref(model, prompts, 16)
        with _server(model, fleet=2) as (h, srv, fleet):
            socks = []
            for p in prompts:
                s, f, st = _open_sse(h.port, {"prompt": p,
                                              "max_tokens": 16,
                                              "stream": True})
                assert st == 200
                socks.append((s, f))
            firsts = [_read_event(f) for _, f in socks]
            assert all(ev and ev["token_ids"] for ev in firsts)

            def _kill():
                victim = fleet.busiest()
                fleet.kill(victim)
                fleet.revive(victim)
                return victim

            assert srv.worker.call(_kill).result(timeout=30) >= 0
            outs = []
            for (s, f), first in zip(socks, firsts):
                toks = list(first["token_ids"])
                delivered, fin = len(toks), None
                while True:
                    ev = _read_event(f)
                    if ev is None:
                        break
                    if "token_ids" in ev:
                        # dedup like a real client: events replay from
                        # zero after a failover re-attach
                        start = ev.get("index", delivered)
                        toks.extend(ev["token_ids"][max(
                            0, delivered - start):])
                        delivered = max(delivered,
                                        start + len(ev["token_ids"]))
                    fin = ev.get("finish_reason", fin)
                s.close()
                outs.append((toks, fin))
            assert fleet.stats()["kills"] == 1
            for (toks, fin), want in zip(outs, ref):
                assert fin in ("stop", "length")
                assert toks == list(want)
