"""Per-request token sampling for the serving engine.

The counterpart of `paddle_tpu/serving/sampler.py`. The sampling knobs
(temperature / top-k / top-p) are DATA — `[slots]`-shaped tensors — so
one function serves a batch mixing greedy and nucleus requests.

Shapes: `logits [S, V]`, knob tensors `[S]`. Conventions:
- `temperature <= 0` → greedy (argmax of the raw logits);
- `top_k <= 0` → no top-k filter; `top_p >= 1` → no nucleus filter;
- top-p applies over the post-top-k renormalised distribution.

RANDOM DRAWS. The reference keys each lane with
`fold_in(fold_in(base, salt), position)` on the counter-based threefry
generator; the port cannot reproduce those bits, so a sampled stream is
equal to the reference's in distribution only. What the port keeps is
the engine's invariant: a request's sampled stream depends only on
(engine seed, per-request salt, position) — never on the block size,
the lane it occupies, or the other traffic. It does so on the device,
with no per-lane generator and no host sync: a counter-based integer
hash of (seed, salt, position, domain, vocab index) gives one uniform
per logit, and the draw is the Gumbel-max `argmax(filtered + G)`, which
follows `softmax(filtered_logits)`. The `domain` tag separates the
first token (drawn from the prompt's logits at admission) from the
decode steps. The hash works in int64 holding uint32 values (the
32-bit multiplies are split so that no int64 product overflows).
"""
from __future__ import annotations

from typing import Union

import torch

__all__ = ["DOMAIN_DECODE", "DOMAIN_FIRST", "filtered_logits",
           "lane_keys", "lane_uniforms", "sample_tokens",
           "sample_tokens_per_lane", "sample_verify_tokens",
           "speculative_accept", "compact_block"]

DOMAIN_DECODE = 0x1D
DOMAIN_FIRST = 0x2F
_M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9

TensorLike = Union[torch.Tensor, float, int]


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 `x` in [0, 2^32) and a constant
    c < 2^32, with every intermediate below 2^49."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A bijective 32-bit integer finaliser (xorshift-multiply, the
    `lowbias32` constants) with full avalanche."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def lane_keys(seed: int, salts: torch.Tensor, positions: torch.Tensor,
              domain: int = DOMAIN_DECODE) -> torch.Tensor:
    """Per-lane 32-bit keys (int64 [S]) from (seed, salt, position,
    domain): the seed folded first, then the request's salt, then the
    absolute position, then the domain tag."""
    salts = salts.to(torch.int64) & _M32
    k = _mix32(torch.full_like(salts, (int(seed) ^ _GOLDEN) & _M32))
    k = _mix32(k ^ salts)
    k = _mix32((k + (positions.to(torch.int64) & _M32)) & _M32)
    return _mix32(k ^ (int(domain) & _M32))


def lane_uniforms(keys: torch.Tensor, vocab: int) -> torch.Tensor:
    """[S, V] float32 uniforms in (0, 1): entry (i, v) is a pure
    function of keys[i] and v (24 random bits, centred in their bin)."""
    idx = _mix32(torch.arange(vocab, device=keys.device,
                              dtype=torch.int64) * 2 + 1)
    bits = _mix32(_mix32(keys[:, None] ^ idx[None, :]))
    return ((bits >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))


def _knob(x: TensorLike, S: int, dtype, device) -> torch.Tensor:
    t = torch.as_tensor(x, dtype=dtype, device=device)
    return t.expand(S) if t.dim() == 0 else t


def filtered_logits(logits: torch.Tensor, temperature: TensorLike,
                    top_k: TensorLike, top_p: TensorLike) -> torch.Tensor:
    """Temperature-scale then mask logits per row: keep only the top-k
    entries (where top_k > 0; ties at the threshold survive) and the
    smallest nucleus whose cumulative probability reaches top_p (where
    top_p < 1). Returns f32 [S, V] with dropped entries at -inf; softmax
    of a row is its sampling law. One stable argsort serves both
    filters, as in the reference."""
    lg = logits.to(torch.float32)
    S, V = lg.shape
    dev = lg.device
    temperature = _knob(temperature, S, torch.float32, dev)
    top_k = _knob(top_k, S, torch.int64, dev)
    top_p = _knob(top_p, S, torch.float32, dev)
    neg = torch.full((), float("-inf"), device=dev)   # a fill: capturable

    scaled = lg / torch.clamp(temperature, min=1e-6)[:, None]
    order = torch.argsort(-scaled, dim=-1, stable=True)
    desc = torch.gather(scaled, -1, order)
    kidx = torch.clamp(top_k - 1, 0, V - 1)[:, None]
    kth = torch.gather(desc, -1, kidx)
    topk_drop = (top_k[:, None] > 0) & (scaled < kth)
    scaled = torch.where(topk_drop, neg, scaled)
    sorted_lg = torch.where(torch.gather(topk_drop, -1, order), neg, desc)
    probs = torch.softmax(sorted_lg, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep_sorted = (cum - probs) < torch.clamp(top_p, max=1.0)[:, None]
    keep = torch.zeros((S, V), dtype=torch.bool, device=dev).scatter(
        1, order, keep_sorted)
    return torch.where((top_p[:, None] < 1.0) & ~keep, neg, scaled)


def sample_tokens_per_lane(logits: torch.Tensor, seed: int,
                           salts: torch.Tensor, positions: torch.Tensor,
                           temperature: TensorLike, top_k: TensorLike,
                           top_p: TensorLike,
                           domain: int = DOMAIN_DECODE) -> torch.Tensor:
    """One token per row: argmax where temperature <= 0, else the
    Gumbel-max draw from `filtered_logits` with row i's uniforms keyed
    by (seed, salts[i], positions[i], domain) — a lane's draw depends
    only on its own key and logits, never on its row. int64 [S]."""
    lg = logits.to(torch.float32)
    S, V = lg.shape
    greedy = torch.argmax(lg, dim=-1)
    masked = filtered_logits(lg, temperature, top_k, top_p)
    u = lane_uniforms(lane_keys(seed, salts, positions, domain), V)
    gumbel = -torch.log(-torch.log(u))
    # dropped entries stay -inf (-inf + finite); nothing here multiplies
    # a masked entry, so no 0 * inf can turn one into NaN
    sampled = torch.argmax(masked + gumbel, dim=-1)
    temperature = _knob(temperature, S, torch.float32, lg.device)
    return torch.where(temperature <= 0.0, greedy, sampled)


def sample_tokens(logits: torch.Tensor, seed: int, salt: TensorLike,
                  position: TensorLike, temperature: TensorLike,
                  top_k: TensorLike, top_p: TensorLike,
                  domain: int = DOMAIN_FIRST) -> torch.Tensor:
    """`sample_tokens_per_lane` with salt, position and the knobs given
    as scalars (or [S]) and broadcast over the rows; by default in the
    first-token domain, the engine's draw from the prompt's logits."""
    S = logits.shape[0]
    dev = logits.device
    return sample_tokens_per_lane(
        logits, seed, _knob(salt, S, torch.int64, dev),
        _knob(position, S, torch.int64, dev), temperature, top_k, top_p,
        domain)


# --------------------------------------------------------------------------- #
# speculative decoding: the verify draws, the accept rule, the compaction
# --------------------------------------------------------------------------- #
#
# Draft-and-verify speculation emits, per round, the longest prefix of the
# k drafted tokens that EQUALS what the target would have emitted
# un-speculated, plus the target's own token at the first mismatch (or at
# the bonus position when all k match). Position t of a request is always
# drawn with the key (seed, salt, t) from the target's logits at t, with
# speculation on or off, so the emitted stream is the un-speculated one
# token for token, greedy and sampled; the draft only decides how many of
# those tokens land per verify pass.


def sample_verify_tokens(logits: torch.Tensor, seed: int,
                         salts: torch.Tensor, positions: torch.Tensor,
                         temperature: torch.Tensor, top_k: torch.Tensor,
                         top_p: torch.Tensor) -> torch.Tensor:
    """The target's would-be tokens for a verify pass: `logits`
    (S, W, V) at query positions `positions` (S, W) of lanes with salts
    and knobs (S,). Column j is drawn by one `sample_tokens_per_lane`
    call over exactly S rows, the plain decode step's call, with the
    key of (seed, salt, position): each draw is the un-speculated
    step's draw, bitwise. Returns (S, W) int64."""
    W = logits.shape[1]
    return torch.stack([
        sample_tokens_per_lane(logits[:, j], seed, salts, positions[:, j],
                               temperature, top_k, top_p)
        for j in range(W)], dim=1)


def _cumand(x: torch.Tensor) -> torch.Tensor:
    """Running AND along axis 1 of a bool (S, n) tensor."""
    return torch.cumprod(x.to(torch.int32), dim=1) > 0


def speculative_accept(drafted: torch.Tensor, target: torch.Tensor,
                       cur: torch.Tensor, act: torch.Tensor,
                       pos: torch.Tensor, rem: torch.Tensor,
                       eos: torch.Tensor, max_seq: int):
    """The accept decision of one verify round over every lane:
    `drafted` (S, k) are the draft's proposals, `target` (S, k+1) the
    target's own tokens for positions pos .. pos+k.

    Token j emits iff every earlier token emitted AND (j == 0 or
    drafted[j-1] == target[j-1]) AND no earlier emitted token was EOS
    AND the plain step's caps still hold at step j ((rem - j) > 0,
    (pos + j) < max_seq - 1). Every factor is non-increasing in j, so
    the emit mask is a prefix per lane, and an active lane always emits
    at least one token.

    Returns (emit (S, W) bool, toks (S, W) — the target tokens, 0 where
    not emitted, cur2, pos2, rem2, act2 — the lane state after the
    round, accepted (S,) — drafted tokens that matched)."""
    S, W = target.shape
    k = W - 1
    dev = target.device
    j_idx = torch.arange(W, device=dev)
    ones = torch.ones((S, 1), dtype=torch.bool, device=dev)
    accept_chain = _cumand(torch.cat([ones, drafted == target[:, :k]],
                                     dim=1))
    stop = (eos >= 0)[:, None] & (target == eos[:, None])
    # exclusive: token j is gated by EOS among the tokens before it (an
    # emitted EOS itself still emits, as in the plain step)
    nostop = torch.cat([ones, _cumand(~stop[:, :k])], dim=1)
    rem_ok = (rem[:, None] - j_idx[None, :]) > 0
    pos_ok = (pos[:, None] + j_idx[None, :]) < (max_seq - 1)
    emit = act[:, None] & accept_chain & nostop & rem_ok & pos_ok
    e = emit.to(pos.dtype).sum(dim=1)
    last = torch.clamp(e - 1, 0, k)[:, None]
    last_tok = target.gather(1, last)[:, 0]
    stop_last = stop.gather(1, last)[:, 0]
    cur2 = torch.where(e > 0, last_tok.to(cur.dtype), cur)
    pos2 = pos + e
    rem2 = rem - e
    act2 = act & (e > 0) & ~stop_last & (rem2 > 0) & (pos2 < max_seq - 1)
    toks = torch.where(emit, target, 0)
    accepted = (accept_chain[:, 1:] & act[:, None]).to(torch.int64).sum(1)
    return emit, toks, cur2, pos2, rem2, act2, accepted


def compact_block(toks: torch.Tensor, emits: torch.Tensor):
    """Pack each lane's emitted tokens to the front of the block's step
    axis: a multi-round speculative block emits a prefix per round, which
    flattened is no prefix of the block. A stable sort on ~emit per lane
    restores the prefix shape (emitted rows first, in order), so the host
    processes a speculative block as it does a plain one. toks / emits
    are (steps, S)."""
    order = torch.argsort((~emits).to(torch.int8), dim=0, stable=True)
    return toks.gather(0, order), emits.gather(0, order)
