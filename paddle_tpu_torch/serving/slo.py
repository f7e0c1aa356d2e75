"""Multi-tenant SLO admission: token budgets, stream caps and bounded
backpressure for the HTTP front door (`serving/server.py`).

The port of `paddle_tpu/serving/slo.py`: pure host state on an
injectable clock, the same decisions in the same order, so one scripted
`admit` / `finish` sequence gives the same `Admission`s and `snapshot()`
in both packages. It imports nothing but the standard library.

The serving engine already has admission control — a bounded queue that
raises `EngineOverloadError` when full — but that is the LAST line of
defense, and the exception is engine-shaped, not client-shaped. A front
door needs overload behavior that is SHAPED, not emergent: a tenant
over its budget gets a polite 429 with a Retry-After it can obey, other
tenants' latency stays bounded because the flood never reaches the
engine queue, and the engine's own overflow machinery is never the
shedding mechanism a client sees. This module is that policy layer:

- `TokenBucket`: the budget primitive — capacity (burst) + refill rate,
  `try_take` either debits or returns exactly how long until the debit
  would succeed (the Retry-After a client can trust).
- `TenantPolicy`: one tenant's contract — token refill rate, burst,
  concurrent-stream cap, and the `SamplingParams.priority` its admitted
  requests carry through engine/fleet admission.
- `SLOController`: the per-request decision. Checks, in order: global
  inflight cap (bounded-queue backpressure, sized AT or BELOW the
  backend's own queue bound so the engine never overflows), the
  tenant's stream cap, then the tenant's token budget (debiting
  prompt + max_new_tokens up front; `finish()` refunds the unused
  reservation so budgets track real usage, not worst-case). Every
  shed is counted per (tenant, reason) for the `/metrics` surface.

What 429s vs what queues: a request INSIDE all three limits is admitted
and may still WAIT (engine queue, block-boundary admission) — that's
queuing, bounded by the inflight cap and observable as queue-wait
quantiles. A request outside any limit is SHED immediately with a
reason and a Retry-After — it never consumes engine queue space, KV
slots, or another tenant's latency budget.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, Optional, Tuple

__all__ = ["TokenBucket", "TenantPolicy", "Admission", "SLOController",
           "SHED_REASONS"]

# the closed vocabulary of shed reasons (metric label values; the
# server adds "draining" for its SIGTERM window)
SHED_REASONS = ("backpressure", "stream_cap", "token_budget",
                "draining")


class TokenBucket:
    """Classic token bucket with an explicit clock: `capacity` is the
    burst allowance, `refill_per_s` the sustained rate. `try_take`
    either debits atomically or — without debiting — returns the exact
    wait until the debit would succeed, which is the honest
    Retry-After."""

    __slots__ = ("capacity", "refill_per_s", "level", "_t")

    def __init__(self, capacity: float, refill_per_s: float,
                 now: float = 0.0):
        if capacity < 0 or refill_per_s < 0:
            raise ValueError("capacity and refill_per_s must be >= 0")
        self.capacity = float(capacity)
        self.refill_per_s = float(refill_per_s)
        self.level = float(capacity)   # start full: bursts admit cold
        self._t = float(now)

    def _advance(self, now: float):
        if now > self._t:
            self.level = min(self.capacity,
                             self.level + (now - self._t)
                             * self.refill_per_s)
        self._t = max(self._t, now)

    def try_take(self, n: float, now: float) -> float:
        """0.0 = taken; > 0 = NOT taken, seconds until `n` tokens will
        be available (inf when n exceeds what this bucket can ever
        hold or the refill rate is zero)."""
        self._advance(now)
        if n <= self.level:
            self.level -= n
            return 0.0
        if n > self.capacity or self.refill_per_s <= 0:
            return math.inf
        return (n - self.level) / self.refill_per_s

    def refund(self, n: float):
        """Return an unused reservation (a stream that finished early
        generated fewer tokens than it reserved)."""
        self.level = min(self.capacity, self.level + max(0.0, float(n)))


@dataclasses.dataclass
class TenantPolicy:
    """One tenant's SLO contract. Defaults are permissive (no budget,
    generous stream cap, priority 0) so an unconfigured tenant behaves
    like the pre-SLO server; the DEFAULT policy applies to any tenant
    without an explicit entry."""
    tokens_per_s: float = math.inf   # sustained token budget (prompt +
    #   reserved new tokens count against it; unused reservations are
    #   refunded at finish)
    burst_tokens: Optional[float] = None  # bucket capacity; default
    #   10s worth of refill (or unlimited with an unlimited rate)
    max_streams: int = 64            # concurrent live streams
    priority: int = 0                # SamplingParams.priority for this
    #   tenant's admitted requests (engine/fleet admission order)

    def __post_init__(self):
        if self.max_streams < 1:
            raise ValueError("max_streams must be >= 1")
        if self.tokens_per_s < 0:
            raise ValueError("tokens_per_s must be >= 0")
        if self.burst_tokens is not None and self.burst_tokens <= 0:
            raise ValueError("burst_tokens must be > 0")

    @property
    def bucket_capacity(self) -> float:
        if self.burst_tokens is not None:
            return float(self.burst_tokens)
        if math.isinf(self.tokens_per_s):
            return math.inf
        return 10.0 * self.tokens_per_s

    @property
    def unlimited(self) -> bool:
        return math.isinf(self.tokens_per_s) \
            and self.burst_tokens is None


@dataclasses.dataclass
class Admission:
    """One admit() verdict. `admitted=False` carries the shed reason
    and the Retry-After the client should obey; `admitted=True`
    carries the priority to stamp on the request's SamplingParams."""
    admitted: bool
    tenant: str
    reason: str = ""
    retry_after_s: float = 0.0
    priority: int = 0
    tokens: int = 0                  # the reservation admit() debited,
    #   in the controller's charge unit (tokens, or KV pages when the
    #   backend serves the paged layout)


class SLOController:
    """The front door's admission brain: per-tenant buckets + stream
    counts + a global inflight cap, all on one injectable clock.

    Thread contract: called only from the server's event-loop thread
    (admit at request arrival, finish at stream end) — no locks, like
    the engine's own scheduler-thread contract.
    """

    def __init__(self, policies: Optional[Dict[str, TenantPolicy]] = None,
                 default_policy: Optional[TenantPolicy] = None,
                 max_inflight: int = 64,
                 min_retry_after_s: float = 0.05,
                 max_retry_after_s: float = 60.0,
                 charge_unit: str = "tokens", page_size: int = 1,
                 clock=time.monotonic):
        if max_inflight < 1:
            raise ValueError("max_inflight must be >= 1")
        if charge_unit not in ("tokens", "pages"):
            raise ValueError(f"charge_unit must be 'tokens' or "
                             f"'pages', got {charge_unit!r}")
        if page_size < 1:
            raise ValueError("page_size must be >= 1")
        # CHARGE UNIT (paged KV): with
        # charge_unit="pages", every debit/refund converts a token
        # count to the KV pages it actually occupies
        # (ceil(tokens / page_size)) — so tenant budgets meter the
        # resource the paged engine admits by (device pages resident),
        # not a token fiction. TenantPolicy rates are then pages/s and
        # burst pages. With "tokens" (default, slotted layout) this is
        # the identity.
        self.charge_unit = charge_unit
        self.page_size = int(page_size)
        self.policies = dict(policies or {})
        self.default_policy = default_policy or TenantPolicy()
        self.max_inflight = int(max_inflight)
        self.min_retry_after_s = float(min_retry_after_s)
        self.max_retry_after_s = float(max_retry_after_s)
        self._clock = clock
        self._buckets: Dict[str, TokenBucket] = {}
        self._streams: Dict[str, int] = {}
        self.inflight = 0
        # counters (the /metrics + SERVER.json surface)
        self.admitted_requests: Dict[str, int] = {}
        self.admitted_tokens: Dict[str, int] = {}
        self.shed: Dict[Tuple[str, str], int] = {}

    def policy_for(self, tenant: str) -> TenantPolicy:
        return self.policies.get(tenant, self.default_policy)

    def _bucket(self, tenant: str,
                policy: TenantPolicy) -> Optional[TokenBucket]:
        if policy.unlimited:
            return None
        b = self._buckets.get(tenant)
        if b is None:
            b = self._buckets[tenant] = TokenBucket(
                policy.bucket_capacity, policy.tokens_per_s,
                now=self._clock())
        return b

    def _clamp_retry(self, wait_s: float) -> float:
        if math.isinf(wait_s):
            return self.max_retry_after_s
        return min(self.max_retry_after_s,
                   max(self.min_retry_after_s, wait_s))

    def _shed(self, tenant: str, reason: str,
              retry_after_s: float) -> Admission:
        key = (tenant, reason)
        self.shed[key] = self.shed.get(key, 0) + 1
        return Admission(False, tenant, reason=reason,
                         retry_after_s=self._clamp_retry(retry_after_s))

    def streams_active(self, tenant: str) -> int:
        return self._streams.get(tenant, 0)

    def units_of(self, tokens: float) -> int:
        """Token count → charge units (identity under "tokens"; the
        page span under "pages")."""
        if self.charge_unit == "pages":
            return -(-int(tokens) // self.page_size)
        return int(tokens)

    def admit(self, tenant: str, tokens: int) -> Admission:
        """Decide one request charging `tokens` (prompt + reserved new
        tokens). Order matters and is part of the contract: global
        backpressure first (protects EVERY tenant's latency — the
        engine queue must never be the limit a client discovers), then
        the tenant's stream cap, then its token budget. An admitted
        request increments the stream count and inflight and debits the
        bucket; the caller MUST pair it with exactly one `finish()`."""
        now = self._clock()
        policy = self.policy_for(tenant)
        units = self.units_of(tokens)
        if self.inflight >= self.max_inflight:
            # the shaped stand-in for the engine's own queue overflow:
            # retry once the current work has had a chance to drain
            return self._shed(tenant, "backpressure",
                              self.min_retry_after_s * 4)
        if self._streams.get(tenant, 0) >= policy.max_streams:
            return self._shed(tenant, "stream_cap",
                              self.min_retry_after_s * 4)
        bucket = self._bucket(tenant, policy)
        if bucket is not None:
            wait = bucket.try_take(float(units), now)
            if wait > 0:
                return self._shed(tenant, "token_budget", wait)
        self.inflight += 1
        self._streams[tenant] = self._streams.get(tenant, 0) + 1
        self.admitted_requests[tenant] = \
            self.admitted_requests.get(tenant, 0) + 1
        self.admitted_tokens[tenant] = \
            self.admitted_tokens.get(tenant, 0) + units
        return Admission(True, tenant, priority=policy.priority,
                         tokens=units)

    def finish(self, adm: Admission, tokens_used: Optional[int] = None):
        """Release one admitted request: decrement stream/inflight and
        refund the unused part of its reservation (a request that
        stopped at EOS after 3 of 64 reserved tokens gives 61 back —
        budgets meter actual usage, not worst case)."""
        if not adm.admitted:
            return
        self.inflight = max(0, self.inflight - 1)
        n = self._streams.get(adm.tenant, 0)
        if n <= 1:
            self._streams.pop(adm.tenant, None)
        else:
            self._streams[adm.tenant] = n - 1
        if tokens_used is None:
            return
        used = self.units_of(tokens_used)
        if used < adm.tokens:
            bucket = self._buckets.get(adm.tenant)
            if bucket is not None:
                bucket.refund(adm.tokens - used)

    def snapshot(self) -> Dict[str, float]:
        """Flat numeric dict (SERVER.json / digest material); the
        labeled per-tenant families render in the server's
        `/metrics` handler."""
        out: Dict[str, float] = {
            "inflight": self.inflight,
            "max_inflight": self.max_inflight,
            "streams_active": sum(self._streams.values()),
            "shed_total": sum(self.shed.values()),
            "admitted_requests_total":
                sum(self.admitted_requests.values()),
            "admitted_tokens_total": sum(self.admitted_tokens.values()),
        }
        return out
