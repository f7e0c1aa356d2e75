"""Capture watchdog: the port's counterpart of the JAX package's
`CompileWatchdog` (`paddle_tpu/obs/watchdog.py`).

The JAX engine counts XLA traces per compiled program; the port's
engine builds each program once instead (`LLMEngine._captures`, keyed
like the JAX engine's `_traces`): the plain decode block, the
speculative block, and one prefill program per row count. On a card
each build is one CUDA graph capture (warm-up included), on the CPU the
same runner is built without one. The kernels themselves are built by
`ops_cuda._build`, which counts every nvcc run per source
(`_build.BUILDS`).

The watchdog holds those two count dicts (never the engine) plus a
matcher and a budget per program kind, and checks at read time that
every program was built EXACTLY once and that no kind built more
distinct programs than the configuration allows:

- `decode`: 1 per engine;
- `spec_decode`: 1 more when `speculate_k > 0` (the plain program
  stays in budget: it is the `draft_dispatch` fallback);
- `prefill`: the exact image of the engine's row-count function
  (`max(bucket, PREFILL_MIN_ROWS)` over its buckets, `max_seq`
  included);
- `kernel_build`: one per source of `_build.kernel_names()`;
- `native_build`: one per host C++ source of `native.NATIVE_SOURCES`
  (the `ps/` sparse table behind the fleet KV tier, built with g++ and
  counted in `_build.BUILDS` beside the kernels).

The prefix copies and the page programs (gather, scatter, COW copy)
run eagerly in the port, so they build nothing and have no budget.

Every program key ends in the engine's TP group fingerprint (`()`
without a group, `(tp, *rank ids)` with one: `nn/tp.py`), and each
matcher is this engine's exact keys, fingerprint included
(`paddle_tpu/obs/watchdog.py:74-82` pins `key[-1]`): sibling engines on
other groups (a fleet's replicas) never match each other's programs,
and a TP engine's budget is the unsharded engine's, since sharding
adds no program.

It keeps the reference's read side and family names (`counts`,
`compiles_total`, `compiles_unexpected`, `budget_total`, `snapshot`,
`families`), so the exposition and the stats digest read the same as
the JAX engine's. `compiles_unexpected` counts a rebuild of one key
(a capture repeated) and distinct programs beyond a kind's budget;
healthy serving reads 0.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

__all__ = ["CompileWatchdog"]


class CompileWatchdog:
    """Budget-checked view over an engine's per-program capture counts
    and the process's kernel builds.

    `programs` maps a program-kind name to `(match, budget)`: `match(key)`
    selects that kind's keys and `budget` is the most DISTINCT programs
    the configuration allows (each built exactly once). `builds` ({source
    name: nvcc runs}) enters under the keys `("kernel_build", name)`.
    """

    def __init__(self, captures: Dict[Tuple, int],
                 programs: Dict[str, Tuple[Callable[[Tuple], bool], int]],
                 builds: Optional[Dict[str, int]] = None):
        self._captures = captures
        self._builds = builds if builds is not None else {}
        self.programs = dict(programs)

    @classmethod
    def for_engine(cls, engine) -> "CompileWatchdog":
        """Matchers and budgets for one `serving.LLMEngine`
        configuration. Holds the engine's capture dict and the build
        counts, not the engine, so a watchdog never keeps an engine
        alive."""
        from ..native import NATIVE_SOURCES
        from ..ops_cuda import _build
        from ..serving import engine as engine_mod
        floor = engine_mod.PREFILL_MIN_ROWS
        # the image of the row-count function: one key per row count
        prefill = frozenset(engine._prefill_key(max(b, floor))
                            for b in engine._buckets)
        programs: Dict[str, Tuple[Callable, int]] = {
            "decode": (lambda k, dk=engine._decode_key: k == dk, 1),
            "prefill": (lambda k, pk=prefill: k in pk, len(prefill)),
            "kernel_build": (lambda k: k[0] == "kernel_build"
                             and k[1] not in NATIVE_SOURCES,
                             len(_build.kernel_names())),
            "native_build": (lambda k: k[0] == "kernel_build"
                             and k[1] in NATIVE_SOURCES,
                             len(NATIVE_SOURCES)),
        }
        if engine.speculate_k:
            programs["spec_decode"] = (
                lambda k, sk=engine._spec_key: k == sk, 1)
        return cls(engine._captures, programs, _build.BUILDS)

    # --- read side -------------------------------------------------------- #
    def _items(self):
        yield from list(self._captures.items())
        for name, n in list(self._builds.items()):
            yield ("kernel_build", name), n

    def counts(self) -> Dict[str, Dict[str, int]]:
        """Per program kind: `programs` (distinct keys built),
        `compiles` (total builds incl. repeats), `retraces` (builds
        beyond the first per key), `budget`."""
        out = {name: {"programs": 0, "compiles": 0, "retraces": 0,
                      "budget": budget}
               for name, (_, budget) in self.programs.items()}
        for key, n in self._items():
            for name, (match, _) in self.programs.items():
                if match(key):
                    c = out[name]
                    c["programs"] += 1
                    c["compiles"] += int(n)
                    c["retraces"] += max(0, int(n) - 1)
                    break
        return out

    @property
    def compiles_total(self) -> int:
        return sum(c["compiles"] for c in self.counts().values())

    @property
    def compiles_unexpected(self) -> int:
        """Repeated builds plus distinct programs beyond any kind's
        budget: 0 when the engine held its one-build-per-program
        contract."""
        return sum(c["retraces"] + max(0, c["programs"] - c["budget"])
                   for c in self.counts().values())

    @property
    def budget_total(self) -> int:
        """The one-build-per-program ceiling: `compiles_total` never
        legitimately exceeds it for the configuration."""
        return sum(b for _, b in self.programs.values())

    def snapshot(self) -> Dict[str, float]:
        """Flat numeric dict (stats-provider and digest payload), from
        one `counts()` walk."""
        counts = self.counts()
        out: Dict[str, float] = {
            "compiles_total": sum(c["compiles"] for c in counts.values()),
            "compiles_unexpected": sum(
                c["retraces"] + max(0, c["programs"] - c["budget"])
                for c in counts.values()),
            "compiles_budget": self.budget_total,
        }
        for name, c in counts.items():
            out[f"compiles_{name}"] = c["compiles"]
        return out

    def families(self, namespace: str = "paddle_tpu_serving"):
        """Prometheus families, one sample per program kind:
        `<ns>_compiles_total` (counter), `<ns>_compiles_unexpected` and
        `<ns>_compiles_budget` (gauges), the reference's names."""
        from .prometheus import Family
        counts = self.counts()
        total = Family(f"{namespace}_compiles_total", "counter",
                       "programs built: CUDA graph captures of engine "
                       "programs and nvcc kernel builds (expected: one "
                       "per program, ever)")
        unexpected = Family(f"{namespace}_compiles_unexpected", "gauge",
                            "repeated builds + programs beyond the "
                            "budget (healthy serving reads 0)")
        budget = Family(f"{namespace}_compiles_budget", "gauge",
                        "one-build-per-program ceiling for the engine "
                        "configuration")
        for name in sorted(counts):
            c = counts[name]
            lab = {"program": name}
            total.add(c["compiles"], lab)
            unexpected.add(c["retraces"]
                           + max(0, c["programs"] - c["budget"]), lab)
            budget.add(c["budget"], lab)
        return [total, unexpected, budget]
