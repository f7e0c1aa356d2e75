"""Prometheus text exposition (v0.0.4) for the serving stack.

A copy of `paddle_tpu/obs/prometheus.py`: the same families, names and
strict parser, so a dashboard built on the JAX engine's exposition reads
the port's. `registry_exposition` reads the port's `profiler` registry.

Three layers, all pure host-side string work:

- `Family` / `render_families`: a tiny typed model of exposition —
  counter/gauge/summary families with HELP/TYPE headers, labeled
  samples, and validated metric/label names. Rendering enforces the
  conventions the format expects instead of hoping: every name matches
  `[a-zA-Z_:][a-zA-Z0-9_:]*`, counters end in `_total`, seconds/bytes
  units are spelled out (`_seconds`, `_bytes` — never the snapshot
  dict's `_s` shorthand), summaries carry `{quantile="..."}` samples
  plus `_sum`/`_count`.
- `registry_exposition()`: every `profiler.register_stats_provider`
  provider rendered as gauges labeled `{provider="<name>"}` — the
  generic path that picks up ANY subsystem publishing flat numeric
  dicts (engines, pools, future fleet routers) without bespoke code.
  Provider snapshot keys are sanitized and unit-suffix-normalized; a
  provider that raises shows up as `..._provider_error 1` instead of
  poisoning the scrape (mirroring `custom_stats()` semantics).
- `parse_exposition()`: a STRICT line parser used by the round-trip
  tests (and anyone post-processing `METRICS.prom`): unknown line
  shapes, invalid names, duplicate TYPE declarations, samples under an
  undeclared family, or unparsable values are errors, not warnings —
  the artifact stays valid exposition, not exposition-shaped text.

`ServingMetrics.to_prometheus()` (serving/metrics.py) builds its typed
families on this module; `python -m paddle_tpu_torch.obs` writes the
result to `METRICS.prom`.
"""
from __future__ import annotations

import math
import re
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["Family", "render_families", "registry_exposition",
           "parse_exposition", "sanitize_metric_name",
           "sanitize_label_value", "ExpositionError"]

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")
_TYPES = ("counter", "gauge", "summary", "histogram", "untyped")


class ExpositionError(ValueError):
    """Raised by the strict parser (and by Family on invalid names)."""


def sanitize_metric_name(name: str) -> str:
    """Coerce an arbitrary key into a valid Prometheus metric name:
    invalid characters (slashes, dots, dashes, spaces...) become `_`,
    runs collapse, and a leading digit gets a `_` prefix. Also
    normalizes the snapshot dicts' second-unit shorthand: a trailing
    or embedded `_s` component becomes `_seconds` (`ttft_p50_s` ->
    `ttft_seconds_p50` is the caller's job; this function only fixes
    the terminal `_s`)."""
    s = re.sub(r"[^a-zA-Z0-9_:]", "_", str(name))
    s = re.sub(r"__+", "_", s).strip("_") or "unnamed"
    if s[0].isdigit():
        s = "_" + s
    if s.endswith("_s"):
        s = s[:-2] + "_seconds"
    return s


def sanitize_label_value(value: str) -> str:
    """Escape a label value for exposition (\\ -> \\\\, " -> \\",
    newline -> \\n). Any string is a legal label value once escaped."""
    return (str(value).replace("\\", "\\\\").replace("\"", "\\\"")
            .replace("\n", "\\n"))


def _fmt(v: float) -> str:
    f = float(v)
    if math.isnan(f):
        return "NaN"
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


class Family:
    """One metric family: TYPE + HELP + samples.

    `add(value, labels=..., suffix=...)` appends a sample; summaries
    use `suffix="_sum"/"_count"` and `labels={"quantile": "0.99"}`.
    Names are validated at construction — an invalid name is a bug in
    the instrumentation, not something to emit and hope."""

    def __init__(self, name: str, typ: str, help_text: str = ""):
        if typ not in _TYPES:
            raise ExpositionError(f"unknown family type {typ!r}")
        if not _NAME_RE.match(name):
            raise ExpositionError(f"invalid metric name {name!r}")
        if typ == "counter" and not name.endswith("_total"):
            raise ExpositionError(
                f"counter {name!r} must end with _total")
        self.name = name
        self.type = typ
        self.help = help_text
        self.samples: List[Tuple[str, Dict[str, str], float]] = []

    def add(self, value: float,
            labels: Optional[Dict[str, str]] = None,
            suffix: str = "") -> "Family":
        name = self.name + suffix
        if not _NAME_RE.match(name):
            raise ExpositionError(f"invalid sample name {name!r}")
        for k in (labels or {}):
            if not _LABEL_RE.match(k):
                raise ExpositionError(f"invalid label name {k!r}")
        self.samples.append((name, dict(labels or {}), float(value)))
        return self

    def add_summary(self, stat, labels: Optional[Dict[str, str]] = None,
                    quantiles: Sequence[float] = (0.5, 0.99)) -> "Family":
        """Render an `OnlineStat`-shaped object (count/total +
        `quantile(q)`) as a summary. Reservoir-less stats (the hot-path
        per-block timers) emit `_sum`/`_count` only — still a valid
        summary, just quantile-free."""
        if self.type != "summary":
            raise ExpositionError(
                f"add_summary on {self.type} family {self.name!r}")
        if getattr(stat, "_cap", 0) > 0:
            for q in quantiles:
                self.add(stat.quantile(q),
                         {**(labels or {}), "quantile": _fmt(q)})
        self.add(stat.total, labels, suffix="_sum")
        self.add(stat.count, labels, suffix="_count")
        return self


def render_families(families: Sequence[Family]) -> str:
    """Valid exposition text: HELP/TYPE headers then samples, one
    family block each, trailing newline."""
    lines: List[str] = []
    seen = set()
    for fam in families:
        if fam.name in seen:
            raise ExpositionError(f"duplicate family {fam.name!r}")
        seen.add(fam.name)
        if fam.help:
            lines.append(f"# HELP {fam.name} {fam.help}")
        lines.append(f"# TYPE {fam.name} {fam.type}")
        for name, labels, value in fam.samples:
            if labels:
                lab = ",".join(
                    f'{k}="{sanitize_label_value(v)}"'
                    for k, v in sorted(labels.items()))
                lines.append(f"{name}{{{lab}}} {_fmt(value)}")
            else:
                lines.append(f"{name} {_fmt(value)}")
    return "\n".join(lines) + "\n"


# --------------------------------------------------------------------------- #
# the provider registry -> exposition bridge
# --------------------------------------------------------------------------- #

_NS = "paddle_tpu"


def registry_exposition(namespace: str = _NS) -> str:
    """Render every registered `profiler` stats provider as gauges
    `"<namespace>_<key>"{provider="<name>"}` — the machine-readable
    sibling of `Profiler.summary()`'s [provider] blocks. Keys are
    sanitized (`sanitize_metric_name`, `_s` -> `_seconds`); non-numeric
    values (a provider's `{"error": ...}` payload) become a
    `<namespace>_provider_error` gauge carrying the message as a label
    so one broken provider is visible, not fatal."""
    from .. import profiler
    stats = profiler.custom_stats()
    fams: Dict[str, Family] = {}
    err = Family(f"{namespace}_provider_error", "gauge",
                 "a registered stats provider raised during scrape")
    errs = 0
    for provider in sorted(stats):
        snap = stats[provider]
        for key in sorted(snap):
            val = snap[key]
            if not isinstance(val, (int, float)) \
                    or isinstance(val, bool):
                errs += 1
                err.add(1.0, {"provider": provider,
                              "key": str(key), "detail": str(val)})
                continue
            name = f"{namespace}_{sanitize_metric_name(key)}"
            fam = fams.get(name)
            if fam is None:
                # ALWAYS gauges: a provider snapshot is a point-in-time
                # numeric dict with no type metadata — inferring
                # "counter" from a `_total` name suffix would mislabel
                # gauges like slots_total (rate() over it reads a slot
                # reconfiguration as a counter reset). True counter
                # semantics live in the typed per-subsystem exposition
                # (e.g. ServingMetrics.to_prometheus).
                fam = fams[name] = Family(
                    name, "gauge",
                    "stats-provider value (see provider label)")
            fam.add(float(val), {"provider": provider})
    out = [fams[n] for n in sorted(fams)]
    if errs:
        out.append(err)
    return render_families(out)


# --------------------------------------------------------------------------- #
# strict parser (the round-trip test's other half)
# --------------------------------------------------------------------------- #

_SAMPLE_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*")
_SAMPLE_VALUE_RE = re.compile(r"^\s+(?P<value>\S+)(?:\s+(?P<ts>-?\d+))?$")
_LABEL_PAIR_RE = re.compile(
    r'^(?P<k>[a-zA-Z_][a-zA-Z0-9_]*)="(?P<v>(?:[^"\\]|\\.)*)"$')
_SUMMARY_SUFFIXES = ("_sum", "_count")


def _split_sample(line: str, lineno: int) -> Tuple[str, str, str]:
    """`(name, raw_labels, raw_value)` of one sample line. The label
    section is scanned for its closing brace OUTSIDE quotes — '}' is a
    legal character inside a label value (a provider_error detail can
    carry a repr with braces), so a regex stopping at the first '}'
    would reject the renderer's own valid output."""
    m = _SAMPLE_NAME_RE.match(line)
    if not m:
        raise ExpositionError(f"line {lineno}: bad sample {line!r}")
    name, rest, raw_labels = m.group(0), line[m.end():], ""
    if rest.startswith("{"):
        i, inq = 1, False
        while i < len(rest):
            ch = rest[i]
            if ch == "\\" and inq:
                i += 2
                continue
            if ch == '"':
                inq = not inq
            elif ch == "}" and not inq:
                break
            i += 1
        if i >= len(rest):
            raise ExpositionError(
                f"line {lineno}: unterminated labels {line!r}")
        raw_labels, rest = rest[1:i], rest[i + 1:]
    vm = _SAMPLE_VALUE_RE.match(rest)
    if not vm:
        raise ExpositionError(f"line {lineno}: bad sample {line!r}")
    return name, raw_labels, vm.group("value")


def _split_labels(raw: str, lineno: int) -> Dict[str, str]:
    out: Dict[str, str] = {}
    if not raw.strip():
        return out
    # split on commas not inside the (escaped) quoted value
    parts, depth, cur = [], False, []
    i = 0
    while i < len(raw):
        ch = raw[i]
        if ch == "\\" and depth:
            cur.append(raw[i:i + 2])
            i += 2
            continue
        if ch == '"':
            depth = not depth
        if ch == "," and not depth:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
        i += 1
    if cur:
        parts.append("".join(cur))
    for p in parts:
        m = _LABEL_PAIR_RE.match(p.strip())
        if not m:
            raise ExpositionError(
                f"line {lineno}: bad label pair {p.strip()!r}")
        if m.group("k") in out:
            raise ExpositionError(
                f"line {lineno}: duplicate label {m.group('k')!r}")
        out[m.group("k")] = (m.group("v").replace("\\n", "\n")
                             .replace("\\\"", "\"")
                             .replace("\\\\", "\\"))
    return out


def _base_family(name: str, declared) -> Optional[str]:
    if name in declared:
        return name
    for suf in _SUMMARY_SUFFIXES + ("_bucket",):
        if name.endswith(suf) and name[:-len(suf)] in declared:
            return name[:-len(suf)]
    return None


def parse_exposition(text: str) -> Dict[str, Dict]:
    """Strictly parse exposition text. Returns
    `{family: {"type", "help", "samples": [(name, labels, value)]}}`.
    Raises `ExpositionError` on anything malformed: bad names or label
    syntax, duplicate TYPE, a sample under no declared family, a
    counter sample not ending in `_total`, a quantile outside [0, 1],
    an unparsable value, or a missing trailing newline."""
    if not text.endswith("\n"):
        raise ExpositionError("exposition must end with a newline")
    fams: Dict[str, Dict] = {}
    for lineno, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("# HELP "):
            rest = line[len("# HELP "):]
            name, _, help_text = rest.partition(" ")
            if not _NAME_RE.match(name):
                raise ExpositionError(
                    f"line {lineno}: invalid HELP name {name!r}")
            fams.setdefault(name, {"type": None, "help": "",
                                   "samples": []})["help"] = help_text
            continue
        if line.startswith("# TYPE "):
            rest = line[len("# TYPE "):]
            name, _, typ = rest.partition(" ")
            if not _NAME_RE.match(name):
                raise ExpositionError(
                    f"line {lineno}: invalid TYPE name {name!r}")
            if typ not in _TYPES:
                raise ExpositionError(
                    f"line {lineno}: unknown type {typ!r}")
            fam = fams.setdefault(name, {"type": None, "help": "",
                                         "samples": []})
            if fam["type"] is not None:
                raise ExpositionError(
                    f"line {lineno}: duplicate TYPE for {name!r}")
            fam["type"] = typ
            continue
        if line.startswith("#"):
            continue  # plain comment
        name, raw_labels, raw_v = _split_sample(line, lineno)
        labels = _split_labels(raw_labels, lineno)
        try:
            value = float(raw_v.replace("+Inf", "inf")
                          .replace("-Inf", "-inf"))
        except ValueError:
            raise ExpositionError(
                f"line {lineno}: bad value {raw_v!r}") from None
        declared = {n for n, f in fams.items()
                    if f["type"] is not None}
        base = _base_family(name, declared)
        if base is None:
            raise ExpositionError(
                f"line {lineno}: sample {name!r} under no declared "
                f"family (TYPE must precede samples)")
        fam = fams[base]
        if fam["type"] == "counter" and not name.endswith("_total"):
            raise ExpositionError(
                f"line {lineno}: counter sample {name!r} must end "
                f"with _total")
        if "quantile" in labels:
            try:
                q = float(labels["quantile"])
            except ValueError:
                raise ExpositionError(
                    f"line {lineno}: bad quantile "
                    f"{labels['quantile']!r}") from None
            if not 0.0 <= q <= 1.0:
                raise ExpositionError(
                    f"line {lineno}: quantile {q} outside [0, 1]")
        fam["samples"].append((name, labels, value))
    for name, fam in fams.items():
        if fam["type"] is None:
            raise ExpositionError(f"family {name!r} has HELP but no TYPE")
    return fams
