"""The port's op registry against the JAX package's, and the port's root
namespace against the JAX package's: `build_registry()` gives every
reference op the same status (and module) in both, `coverage()` reads
322 = 251 implemented + 37 aliases + 34 collapsed with 0 missing, the
two `reference_ops.txt` are the same bytes, every public name of
`paddle_tpu/__init__.py` has a port counterpart or raises naming its
ROADMAP item, and every op the reference sweep differentiates has a
gradient case in the port's case table."""
import ast
import pathlib

import pytest

import paddle_tpu_torch as pt
from paddle_tpu.ops import registry as jreg
from paddle_tpu_torch.ops import registry as preg
from paddle_tpu_torch.testing import op_cases as oc
from port_threads import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent


def test_registry_matches_the_reference_name_for_name():
    mine, ref = preg.build_registry(), jreg.build_registry()
    assert set(mine) == set(ref)
    diff = {n: (mine[n].status, mine[n].module, ref[n].status, ref[n].module)
            for n in ref if (mine[n].status, mine[n].module)
            != (ref[n].status, ref[n].module)}
    assert not diff, diff


def test_coverage_is_complete():
    cov = preg.coverage()
    assert {k: cov[k] for k in ("total", "implemented", "alias",
                                "collapsed", "missing")} == {
        "total": 322, "implemented": 251, "alias": 37, "collapsed": 34,
        "missing": 0}
    assert preg.missing_ops() == []
    doc = preg.document()
    assert "| add | implemented | ops.math |" in doc


def test_reference_list_is_the_same_bytes_and_the_port_reads_its_own():
    mine = pathlib.Path(preg.REFERENCE_OPS_FILE)
    assert mine.parent == ROOT / "paddle_tpu_torch" / "ops"
    assert mine.read_bytes() == (ROOT / "paddle_tpu" / "ops" /
                                 "reference_ops.txt").read_bytes()


def _reference_root_names():
    """The public names `paddle_tpu/__init__.py` binds (its star import
    expanded over `paddle_tpu.ops`) and the names its `__getattr__`
    answers."""
    import paddle_tpu.ops as jops
    tree = ast.parse((ROOT / "paddle_tpu" / "__init__.py").read_text())
    names = set()
    for node in tree.body:
        if isinstance(node, ast.ImportFrom) and node.level == 1:
            for al in node.names:
                if al.name == "*":
                    names |= {n for n in dir(jops) if not n.startswith("_")}
                else:
                    names.add(al.asname or al.name)
        if isinstance(node, ast.FunctionDef) and node.name == "__getattr__":
            for sub in ast.walk(node):
                if isinstance(sub, ast.Set):
                    names |= {e.value for e in sub.elts}
                if isinstance(sub, ast.Compare) and isinstance(
                        sub.left, ast.Name) and sub.left.id == "name":
                    for c in sub.comparators:
                        if isinstance(c, ast.Constant):
                            names.add(c.value)
                        elif isinstance(c, ast.Tuple):
                            names |= {e.value for e in c.elts}
    return {n for n in names if not n.startswith("_")}


def test_every_reference_root_name_has_a_counterpart_or_its_item():
    names = _reference_root_names()
    assert {"seed", "no_grad", "value_and_grad", "functional_call",
            "tensor", "Tensor", "save", "summary", "matmul"} <= names
    pending = {}
    for n in sorted(names):
        try:
            getattr(pt, n)
        except AttributeError as e:
            pending[n] = str(e)
    for n, msg in pending.items():
        assert "item 13." in msg or "ops_cuda" in msg, (n, msg)
    assert set(pending) == {"distribution", "sparse", "incubate", "onnx",
                            "utils", "ops_pallas"}


def test_root_exports_mean_what_they_meant():
    assert pt.tensor is pt.ops and pt.Tensor is __import__("torch").Tensor
    assert pt.save is pt.framework.io.save
    assert pt.resolve_device is pt.core.resolve_device
    assert pt.default_device() == "cuda"
    assert pt.grad is pt.autograd.grad


def test_every_differentiated_reference_op_has_a_grad_case():
    """The reference sweep's gradient set (its UNARY / BINARY / REDUCE
    with grad) is a subset of the case table's."""
    import test_op_sweep as sweep
    ref = ({n for n, v in sweep.UNARY.items() if v[2]}
           | {n for n, v in sweep.BINARY.items() if v[3]}
           | {n for n, v in sweep.REDUCE.items() if v[3]})
    mine = {c.name for c in oc.CASES if c.grad}
    assert ref - mine == set()


@pytest.mark.parametrize("module", ["ops.creation", "ops.math",
                                    "ops.manipulation", "ops.linalg",
                                    "ops.extras", "nn.functional"])
def test_registry_modules_have_cases(module):
    assert any(c.module == module for c in oc.CASES)
