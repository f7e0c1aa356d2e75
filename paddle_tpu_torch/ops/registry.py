"""Op registry: the single source of truth for the port's op coverage,
the counterpart of `paddle_tpu/ops/registry.py`.

`build_registry()` introspects the port's live `ops` and
`nn.functional` and reconciles them with the reference's op list
snapshot, this package's own copy of `reference_ops.txt` (the same
bytes as the JAX package's; the port never reads that one). Each
reference op is `implemented` (a name of the surface), an `alias` (the
reference's kernel name whose public API here is another name),
`collapsed` (subsumed by another subsystem, or an in-place `name_`
variant of an implemented op) or `missing`; `coverage()` counts them
and `document()` renders the table.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional

__all__ = ["OpInfo", "build_registry", "coverage", "missing_ops",
           "document", "REFERENCE_OPS_FILE"]

REFERENCE_OPS_FILE = os.path.join(os.path.dirname(__file__),
                                  "reference_ops.txt")

@dataclasses.dataclass
class OpInfo:
    name: str
    status: str          # implemented | alias | collapsed | missing
    module: Optional[str] = None
    doc: Optional[str] = None


def _implemented_surface() -> Dict[str, str]:
    """{op_name: module} for everything the ops package (the flat
    tensor-op namespace re-exports it) + nn.functional exposes."""
    from .. import ops as ops_pkg
    from ..nn import functional as F

    surface: Dict[str, str] = {}
    for modname in ("math", "creation", "manipulation", "linalg", "extras",
                    "logic", "random", "search", "stat", "einsum"):
        mod = getattr(ops_pkg, modname, None)
        if mod is None:
            continue
        for name in getattr(mod, "__all__", []):
            surface.setdefault(name, f"ops.{modname}")
    for name in dir(ops_pkg):
        if not name.startswith("_") and callable(getattr(ops_pkg, name,
                                                         None)):
            surface.setdefault(name, "ops")
    for name in getattr(F, "__all__", dir(F)):
        if not name.startswith("_"):
            surface.setdefault(name, "nn.functional")
    return surface


def _reference_ops() -> Dict[str, str]:
    """{name: kind-or-alias-target} from the snapshot file. Lines:
    `name` (plain op), `name -> target` (reference kernel name whose
    public API here is `target`), `collapsed: name  # why` (subsumed by
    another subsystem — optimizer/metric/XLA)."""
    ops = {}
    with open(REFERENCE_OPS_FILE) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            if line.startswith("collapsed:"):
                name = line[len("collapsed:"):].strip().split()[0]
                ops[name] = "collapsed"
            elif "->" in line:
                name, target = (s.strip() for s in line.split("->", 1))
                ops[name] = f"alias:{target}"
            else:
                ops[line.split()[0]] = "op"
    return ops


def build_registry() -> Dict[str, OpInfo]:
    surface = _implemented_surface()
    registry: Dict[str, OpInfo] = {}
    for name, kind in _reference_ops().items():
        if kind == "collapsed":
            registry[name] = OpInfo(name, "collapsed")
        elif kind.startswith("alias:"):
            target = kind[len("alias:"):]
            if target in surface:
                registry[name] = OpInfo(name, "alias",
                                        module=surface[target],
                                        doc=f"as {target}")
            else:
                registry[name] = OpInfo(name, "missing",
                                        doc=f"alias target {target} "
                                            "not found")
        elif name in surface:
            registry[name] = OpInfo(name, "implemented",
                                    module=surface[name])
        elif name.endswith("_") and name[:-1] in surface:
            # in-place variant of an implemented op: functional arrays
            # collapse it onto the pure form
            registry[name] = OpInfo(name, "collapsed",
                                    module=surface[name[:-1]])
        else:
            registry[name] = OpInfo(name, "missing")
    return registry


def coverage(reg: Optional[Dict[str, OpInfo]] = None) -> Dict[str, float]:
    reg = reg if reg is not None else build_registry()
    total = len(reg)
    impl = sum(1 for o in reg.values() if o.status == "implemented")
    alias = sum(1 for o in reg.values() if o.status == "alias")
    collapsed = sum(1 for o in reg.values() if o.status == "collapsed")
    return {"total": total, "implemented": impl, "alias": alias,
            "collapsed": collapsed,
            "missing": total - impl - alias - collapsed,
            "covered_frac": (impl + alias + collapsed) / max(total, 1)}


def missing_ops() -> List[str]:
    return sorted(n for n, o in build_registry().items()
                  if o.status == "missing")


def document() -> str:
    """Markdown coverage table (the generated-docs role of the
    reference's codegen)."""
    reg = build_registry()
    cov = coverage(reg)
    lines = ["# Op coverage vs reference", "",
             f"{cov['implemented']} implemented + {cov['collapsed']} "
             f"collapsed of {cov['total']} reference ops "
             f"({cov['covered_frac']:.1%})", "",
             "| op | status | module |", "|---|---|---|"]
    for name in sorted(reg):
        o = reg[name]
        lines.append(f"| {name} | {o.status} | {o.module or ''} |")
    return "\n".join(lines)
