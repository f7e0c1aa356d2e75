"""Dynamic-to-static control-flow conversion (dy2static): the
counterpart of `paddle_tpu/jit/dy2static.py`.

Python `if`/`while`/`for` over tensors is rewritten so that a program
captured by `torch.export` holds BOTH branches / the loop as graph
operators: `torch.cond` and `torch._higher_order_ops.while_loop` (the
JAX package's rewrite targets `lax.cond` / `lax.while_loop`). The AST
passes below are the JAX package's, unchanged, plus two of the port's
own after them, because torch.cond and while_loop trace their bodies
with Dynamo: `_IndexTransformer` (a traced index reads through
`index_select`) and `_BindNames` (no `locals()`). The converted
function runs in a module of its own, as Dynamo resolves globals
through the module. The runtime helpers differ.

The transform dispatches at run time, as in the JAX package: a helper
checks whether the condition is a traced tensor, i.e. one that
`torch.export` is tracing (a fake tensor). An eager tensor or a Python
value takes the Python path (`bool(t)`), which keeps Python's semantics
exactly (short-circuiting included), so a converted function behaves
as the original outside a capture and becomes capturable inside one.

What the torch operators need, and the helpers supply:
- operands and results are tensors. A Python bool, int or float that a
  branch or a loop carries becomes a 0-d tensor, made by `torch.full`
  (an operator, so the program holds no tensor constant): in the dtype
  of the tensor it replaces where there is one, else bool, int64 or
  float32 by its kind. A loop body's result is cast to its carry's
  dtype where the cast is safe (to a kind no lower); a float result
  for a carry that began as a Python int raises (initialize it as a
  float), where the JAX package promotes the carry instead;
- a branch or loop body may not return an input: every tensor result is
  a fresh copy (`clone`);
- other Python values (None, lists, modules) are never operands: a
  branch reads them as free variables, and a traced loop may not write
  them;
- early returns merge by `torch.where` (`select_return`).

Covered, as in the JAX package: `if`/`elif`/`else`, `while`,
`for <name> in range(...)` (1-3 args; a 3-arg step must be a nonzero
literal), `break`/`continue` inside those loops, and early `return`
inside loops and branches. Error attribution: converted code compiles
against the ORIGINAL file name with the original line numbers, so a
capture-time failure's traceback points at the user's own line.
"""
from __future__ import annotations

import ast
import functools
import inspect
import itertools
import sys
import textwrap
import types
from typing import Any, Callable, List, Optional, Set, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensor

__all__ = ["convert_to_static", "convert_ifelse", "convert_while",
           "Dy2StaticError", "is_traced"]


class Dy2StaticError(RuntimeError):
    pass


# --------------------------------------------------------------------------- #
# runtime dispatch helpers (the convert_operators analog)
# --------------------------------------------------------------------------- #


def is_traced(x) -> bool:
    """A tensor that `torch.export` is tracing (a fake tensor, or any
    tensor while an export runs)."""
    if not isinstance(x, torch.Tensor):
        return False
    return isinstance(x, FakeTensor) or torch.compiler.is_exporting()


class _Undefined:
    """Placeholder for a name not yet bound at the control-flow site
    (the reference's UndefinedVar, convert_operators.py). Any USE raises
    — mirroring Python's UnboundLocalError — while mere propagation
    (a branch that rebinds it, or a value never read) stays silent."""

    def __repr__(self):
        return "<undefined>"

    def _raise(self, *a, **k):
        raise Dy2StaticError(
            "variable referenced before assignment inside converted "
            "control flow (bound in only one branch / a zero-trip loop)")

    __bool__ = __add__ = __radd__ = __sub__ = __rsub__ = _raise
    __mul__ = __rmul__ = __truediv__ = __rtruediv__ = _raise
    __floordiv__ = __rfloordiv__ = __mod__ = __rmod__ = _raise
    __pow__ = __rpow__ = __eq__ = __ne__ = _raise
    __lt__ = __le__ = __gt__ = __ge__ = __iter__ = _raise
    __len__ = __getitem__ = __call__ = __neg__ = __matmul__ = _raise
    __float__ = __int__ = __index__ = _raise
    __hash__ = object.__hash__  # __eq__ override would drop it


_UNDEF = _Undefined()
_MODULES = itertools.count()


def prebind(value, default):
    """For-range loop-var bootstrap: keep an existing binding (so an
    empty range preserves it, like Python), else the range start (the
    traced while carry needs a typed value). An _UNDEF (a name not
    bound yet, or threaded in by an enclosing converted branch) is NOT a
    real binding. The JAX package's takes `(locals(), name, default)`;
    `_BindNames` passes the value, since Dynamo cannot trace
    `locals()`."""
    return default if value is _UNDEF else value


_SCALARS = (bool, int, float, torch.SymBool, torch.SymInt, torch.SymFloat)


def _scalar_dtype(v) -> torch.dtype:
    if isinstance(v, (bool, torch.SymBool)):
        return torch.bool
    if isinstance(v, (int, torch.SymInt)):
        return torch.int64
    return torch.float32


def _kind(dtype) -> int:
    """0 bool, 1 integer, 2 floating: a cast to a kind no lower is
    safe (`torch.can_cast`, which Dynamo does not trace)."""
    if dtype == torch.bool:
        return 0
    return 2 if dtype.is_floating_point or dtype.is_complex else 1


def _tensor_of(v, like, device):
    """`v` as a tensor result: a Python scalar as a 0-d tensor (in
    `like`'s dtype when `like` is a tensor, else by its kind), a tensor
    as a fresh copy (an operator's result may not alias its inputs)."""
    if isinstance(v, torch.Tensor):
        return v.clone()
    if isinstance(v, _SCALARS):
        dtype = like.dtype if isinstance(like, torch.Tensor) \
            else _scalar_dtype(v)
        return torch.full((), v, dtype=dtype, device=device)
    raise Dy2StaticError(
        f"converted control flow over a traced condition produced a "
        f"{type(v).__name__} ({v!r}); torch.cond and while_loop carry "
        f"tensors and Python numbers only")


def _bool_tensor(v, device):
    if isinstance(v, torch.Tensor):
        return v if v.dtype == torch.bool else v.bool()
    return torch.full((), bool(v), dtype=torch.bool, device=device)


def convert_ifelse(cond, true_fn: Callable[[Tuple], Tuple],
                   false_fn: Callable[[Tuple], Tuple], init: Tuple):
    """reference convert_operators.convert_ifelse: python-if for plain
    bools and eager tensors, torch.cond for traced conditions. Branch
    closures receive the CURRENT values of every variable either branch
    writes, so read-modify-write (`y = y + 1`) sees the outer value.

    Tensors and Python numbers of `init` are torch.cond's operands (a
    number as a 0-d tensor, as JAX traces a weak-typed scalar); the
    other entries (_UNDEF for names first bound inside the branches,
    None, objects) ride outside, legal as long as every branch that
    returns them rebinds them to a tensor or a number."""
    if not is_traced(cond):
        return true_fn(init) if cond else false_fn(init)
    device = cond.device
    live_idx = [i for i, v in enumerate(init)
                if isinstance(v, (torch.Tensor,) + _SCALARS)]
    live = tuple(_tensor_of(init[i], None, device)
                 if not isinstance(init[i], torch.Tensor) else init[i]
                 for i in live_idx)

    def expand(live_vals):
        vals = list(init)
        for i, v in zip(live_idx, live_vals):
            vals[i] = v
        return tuple(vals)

    def branch(fn):
        def run(*live_vals):
            out = fn(expand(live_vals))
            if any(v is _UNDEF for v in out):
                raise Dy2StaticError(
                    "a variable assigned in only one branch of a traced "
                    "`if` must be initialized before it (both torch.cond "
                    "branches need a value of matching type)")
            return tuple(_tensor_of(v, init[i], device)
                         for i, v in enumerate(out))
        return run

    return tuple(torch.cond(_bool_tensor(cond, device), branch(true_fn),
                            branch(false_fn), live))


def convert_while(cond_fn: Callable[[Tuple], Any],
                  body_fn: Callable[[Tuple], Tuple], state: Tuple):
    """reference convert_while_loop: python loop for plain bools and
    eager tensors, while_loop when the condition comes out traced."""
    def lowered(state, first):
        if any(v is _UNDEF for v in state):
            raise Dy2StaticError(
                "a variable assigned inside a traced `while` must be "
                "initialized before the loop (while_loop carries "
                "fixed-type state)")
        from torch._higher_order_ops import while_loop
        device = first.device
        carry = tuple(_tensor_of(v, None, device)
                      if not isinstance(v, torch.Tensor) else v
                      for v in state)

        def cond(*c):
            return _bool_tensor(cond_fn(c), device)

        def body(*c):
            out = body_fn(c)
            res = []
            for v, was in zip(out, carry):
                t = _tensor_of(v, was, device)
                if t.dtype != was.dtype:
                    if _kind(t.dtype) > _kind(was.dtype):
                        raise Dy2StaticError(
                            f"a traced `while` carries a {was.dtype} "
                            f"variable that the loop body makes "
                            f"{t.dtype}; initialize it before the loop "
                            f"with a value of that dtype (e.g. 0.0, not "
                            f"0)")
                    t = t.to(was.dtype)
                res.append(t)
            return tuple(res)

        return tuple(while_loop(cond, body, carry))

    first = cond_fn(state)
    if is_traced(first):
        return lowered(state, first)
    # reuse the probed value for the first iteration — re-evaluating the
    # header would run a side-effecting condition (walrus, iterator
    # advance) one extra time versus the original function
    while first:
        state = body_fn(state)
        first = cond_fn(state)
        if is_traced(first):
            # the condition TURNED data-dependent mid-loop (e.g. a
            # break flag fed by a traced comparison): the iterations so
            # far are correctly unrolled into the capture; hand the rest
            # to while_loop from the current state
            return lowered(state, first)
    return state


def convert_not(x):
    """`not` over a possibly-traced bool (reference convert_logical_not)."""
    if is_traced(x):
        return torch.logical_not(x)
    return not x


def _either_traced(a, b):
    return next(t for t in (a, b) if is_traced(t)).device


def convert_and(a, b):
    """Eager logical and (guard conditions — both sides are flag reads,
    so evaluation order cannot matter)."""
    if is_traced(a) or is_traced(b):
        dev = _either_traced(a, b)
        return torch.logical_and(_bool_tensor(a, dev), _bool_tensor(b, dev))
    return bool(a) and bool(b)


def loop_test(brk, test_thunk: Callable[[], Any]):
    """Break-augmented loop condition with Python's short-circuit
    semantics: after a concrete `break` the original test is NOT
    re-evaluated (it may index with a now-out-of-range counter or carry
    side effects). Traced flags evaluate the thunk symbolically, which
    is side-effect-free by construction."""
    if is_traced(brk):
        return torch.logical_and(torch.logical_not(brk),
                                 _bool_tensor(test_thunk(), brk.device))
    return (not brk) and test_thunk()


def convert_or(a, b):
    if is_traced(a) or is_traced(b):
        dev = _either_traced(a, b)
        return torch.logical_or(_bool_tensor(a, dev), _bool_tensor(b, dev))
    return bool(a) or bool(b)


def select_return(pairs, fallback: Callable[[], Any]):
    """Merge early-return sites with the fall-through value (the tail
    of the reference's return_transformer). `pairs` is a tuple of
    (flag, thunk) in source order; the first True flag wins. From the
    first traced flag on, every site that can still be taken is
    evaluated in source order, then the tail, and the values merge by
    `torch.where` from the last site back: all return sites must
    produce one consistent type (tensors, or tuples of them; a Python
    number becomes a 0-d tensor). The JAX package nests `lax.cond`s
    instead; here the tail may rebind the function's variables
    (`nonlocal`), which Dynamo refuses inside a `torch.cond` branch,
    and the replayed expressions must read them before the tail runs."""
    def rec(i):
        if i == len(pairs):
            return fallback()
        flag, thunk = pairs[i]
        if is_traced(flag):
            return _merge_traced(pairs[i:], fallback, flag.device)
        return thunk() if flag else rec(i + 1)

    return rec(0)


def _merge_traced(pairs, fallback, device):
    taken = []
    for flag, thunk in pairs:
        if is_traced(flag):
            taken.append((flag, thunk()))
        elif flag:                       # a concrete True: the rest is dead
            last = thunk()
            break
    else:
        last = fallback()

    def pick(flag, a, b):
        if isinstance(a, tuple):
            return tuple(pick(flag, x, y) for x, y in zip(a, b))
        a, b = _tensor_of(a, b, device), _tensor_of(b, a, device)
        return torch.where(flag, a, b)

    for flag, value in reversed(taken):
        last = pick(flag, value, last)
    return last


def getitem(x, index):
    """`x[index]`. A traced 0-d integer tensor indexing a tensor (alone
    or in a tuple of such indices and ints) reads its row with
    `index_select`, a negative index counting from the end as jnp's
    dynamic index does: Dynamo, which traces torch.cond and while_loop
    bodies, reads such an index as a data-dependent Python int and
    cannot capture `x[i]`."""
    idx = index if isinstance(index, tuple) else (index,)
    if (isinstance(x, torch.Tensor) and any(is_traced(i) for i in idx)
            and all(_scalar_index(i) for i in idx)):
        for i in idx:
            if isinstance(i, torch.Tensor):
                n = x.shape[0]
                row = torch.where(i < 0, i + n, i).reshape(1)
                x = x.index_select(0, row).squeeze(0)
            else:
                x = x[i]
        return x
    return x[index]


def _scalar_index(i) -> bool:
    if isinstance(i, torch.Tensor):
        return (i.dim() == 0 and not i.dtype.is_floating_point
                and i.dtype != torch.bool)
    return isinstance(i, int) and not isinstance(i, bool)


# --------------------------------------------------------------------------- #
# the AST transformer
# --------------------------------------------------------------------------- #


def _assigned_names(nodes: List[ast.stmt]) -> Set[str]:
    """Simple-Name write set of a statement list (assign/augassign/
    for-target), recursing into nested blocks."""
    out: Set[str] = set()

    class V(ast.NodeVisitor):
        def visit_Assign(self, node):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    out.add(t.id)
                elif isinstance(t, (ast.Tuple, ast.List)):
                    out.update(e.id for e in t.elts
                               if isinstance(e, ast.Name))
            self.generic_visit(node)

        def visit_AugAssign(self, node):
            if isinstance(node.target, ast.Name):
                out.add(node.target.id)
            self.generic_visit(node)

        def visit_AnnAssign(self, node):
            if isinstance(node.target, ast.Name):
                out.add(node.target.id)
            self.generic_visit(node)

        def visit_For(self, node):
            targets = [node.target] if isinstance(node.target, ast.Name) \
                else (node.target.elts
                      if isinstance(node.target, (ast.Tuple, ast.List))
                      else [])
            for t in targets:
                if isinstance(t, ast.Starred):
                    t = t.value
                if isinstance(t, ast.Name):
                    out.add(t.id)
            self.generic_visit(node)

        def visit_NamedExpr(self, node):  # walrus
            if isinstance(node.target, ast.Name):
                out.add(node.target.id)
            self.generic_visit(node)

        def visit_With(self, node):
            for item in node.items:
                if isinstance(item.optional_vars, ast.Name):
                    out.add(item.optional_vars.id)
            self.generic_visit(node)

        def visit_FunctionDef(self, node):
            # the def binds the name; don't descend. Generated branch/
            # loop closures are block-local plumbing — not user state
            if not node.name.startswith("__ptpu_"):
                out.add(node.name)

        def visit_Lambda(self, node):
            pass

    for n in nodes:
        V().visit(n)
    return out


def _global_names(stmts: List[ast.stmt]) -> Set[str]:
    """Names declared `global` at this function scope (not inside
    nested defs) — such names must never get a nonlocal declaration."""
    names: Set[str] = set()

    def walk(n):
        if isinstance(n, ast.Global):
            names.update(n.names)
            return
        if isinstance(n, _FN_SCOPES):
            return
        for c in ast.iter_child_nodes(n):
            walk(c)

    for s in stmts:
        walk(s)
    return names


_FN_SCOPES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)


def _scan(nodes, target, stop) -> bool:
    """Any `target` node under `nodes`, not descending into `stop`
    scopes — the one walker behind every escape/ownership query (the
    stop set is what distinguishes 'in this function' from 'in this
    loop')."""
    def walk(n) -> bool:
        if isinstance(n, target):
            return True
        if isinstance(n, stop):
            return False
        return any(walk(c) for c in ast.iter_child_nodes(n))

    return any(walk(n) for n in nodes)


def _has_escape(nodes: List[ast.stmt]) -> bool:
    """break/continue/return anywhere in this block — but NOT inside
    nested function definitions (the returns of already-converted inner
    branches are part of their closures, not of this block)."""
    return _scan(nodes, (ast.Break, ast.Continue, ast.Return),
                 _FN_SCOPES)


class _Ctr:
    def __init__(self):
        self.n = 0

    def fresh(self, base):
        self.n += 1
        return f"__ptpu_{base}_{self.n}"

    def fresh_live(self, base):
        """Live state names (break/continue/return flags): these MUST be
        threaded through converted control flow, so they take a prefix
        the __ptpu_* dead-plumbing filters do not match."""
        self.n += 1
        return f"__dy2s_{base}_{self.n}"


def _assign_bool(name, value: bool):
    return ast.Assign(targets=[ast.Name(id=name, ctx=ast.Store())],
                      value=ast.Constant(value=value))


def _call(fname, args):
    return ast.Call(func=ast.Name(id=fname, ctx=ast.Load()), args=args,
                    keywords=[])


def _or_flags(names):
    """__ptpu_convert_or-chained flag expression."""
    expr = ast.Name(id=names[0], ctx=ast.Load())
    for nm in names[1:]:
        expr = _call("__ptpu_convert_or",
                     [expr, ast.Name(id=nm, ctx=ast.Load())])
    return expr


# --------------------------------------------------------------------------- #
# pass 1: functionalize early returns (reference return_transformer.py)
# --------------------------------------------------------------------------- #


def _contains_return(node) -> bool:
    return _scan([node], ast.Return, _FN_SCOPES)


class _ReturnFunctionalizer:
    """Lowers `return` inside loops/branches to per-site flags.

    `return e` becomes `<flag> = True` (+ `break` inside loops — the
    break/continue pass then threads it), the rest of the function
    moves into a tail closure, and the final return is
    `select_return(((flag, lambda: e), ...), tail)`. Expression replay
    is sound because every flag-set freezes loop state (guards + break
    stop further mutation), so `e` evaluates at the tail to the value
    it had at the return site — assuming purity, like the rest of the
    converter. The reference's return_transformer threads a RETURN
    value variable instead; a replayed expression needs no typed
    placeholder, which eager tracing cannot invent."""

    def __init__(self, ctr: _Ctr):
        self.ctr = ctr
        self.applied = False

    def process_function(self, fdef) -> None:
        if not any(_contains_return(s) for s in fdef.body
                   if isinstance(s, (ast.If, ast.While, ast.For))):
            return
        params = {a.arg for a in (fdef.args.posonlyargs + fdef.args.args
                                  + fdef.args.kwonlyargs)}
        for va in (fdef.args.vararg, fdef.args.kwarg):
            if va is not None:
                params.add(va.arg)
        self._globals = _global_names(fdef.body)
        fdef.body = self._process_level(fdef.body, params)
        self.applied = True

    # --- function/tail level ------------------------------------------- #
    def _process_level(self, stmts: List[ast.stmt],
                       outer_bound: Set[str]) -> List[ast.stmt]:
        out: List[ast.stmt] = []
        for idx, s in enumerate(stmts):
            if isinstance(s, (ast.If, ast.While, ast.For)) \
                    and _contains_return(s):
                flags: List[Tuple[str, ast.expr]] = []
                if isinstance(s, ast.If):
                    self._strip_if(s, flags, in_loop=False)
                else:
                    self._strip_block(s.body, flags, in_loop=True)
                for name, _ in flags:
                    out.append(ast.copy_location(
                        _assign_bool(name, False), s))
                out.append(s)
                # the rest of this level becomes the fall-through tail.
                # Names the tail REBINDS that are locals/params of the
                # enclosing scope chain need `nonlocal` — without it the
                # rebind makes them tail-locals and any read-before-
                # write raises UnboundLocalError (and the mutation would
                # be invisible to replayed return expressions anyway)
                level_bound = outer_bound | _assigned_names(out)
                tail_name = self.ctr.fresh("tail")
                tail_body = self._process_level(list(stmts[idx + 1:]),
                                                level_bound) \
                    or [ast.Return(value=ast.Constant(value=None))]
                tail_writes = _assigned_names(tail_body)
                rebound = sorted((tail_writes & level_bound)
                                 - self._globals)
                if rebound:
                    tail_body.insert(0, ast.copy_location(
                        ast.Nonlocal(names=rebound), s))
                # global-declared names need their declaration carried
                # into the tail too (the Global stmt stayed outside)
                glob = sorted(tail_writes & self._globals)
                if glob:
                    tail_body.insert(0, ast.copy_location(
                        ast.Global(names=glob), s))
                tail = ast.FunctionDef(name=tail_name, args=_noargs(),
                                       body=tail_body, decorator_list=[])
                pairs = ast.Tuple(
                    elts=[ast.Tuple(
                        elts=[ast.Name(id=f, ctx=ast.Load()),
                              ast.Lambda(args=_noargs(), body=e)],
                        ctx=ast.Load()) for f, e in flags],
                    ctx=ast.Load())
                ret = ast.Return(value=_call(
                    "__ptpu_select_return",
                    [pairs, ast.Name(id=tail_name, ctx=ast.Load())]))
                out.append(ast.copy_location(tail, s))
                out.append(ast.copy_location(ret, s))
                return out
            out.append(s)
        return out

    # --- inside loops / branches --------------------------------------- #
    def _strip_block(self, stmts: List[ast.stmt],
                     flags: List[Tuple[str, ast.expr]],
                     in_loop: bool) -> None:
        """Replace returns in `stmts` (in place) with flag sets; after a
        nested loop that can set flags, break out of this level too
        (a set flag means the whole function is returning)."""
        i = 0
        while i < len(stmts):
            s = stmts[i]
            if isinstance(s, ast.Return):
                name = self.ctr.fresh_live("rf")
                expr = s.value if s.value is not None \
                    else ast.Constant(value=None)
                flags.append((name, expr))
                repl = [ast.copy_location(_assign_bool(name, True), s)]
                if in_loop:
                    repl.append(ast.copy_location(ast.Break(), s))
                # statements after a return are unreachable
                stmts[i:] = repl
                return
            if isinstance(s, ast.If):
                before = len(flags)
                self._strip_if(s, flags, in_loop)
                fired = [f for f, _ in flags[before:]]
                if fired and not in_loop:
                    # outside loops there is no `break` to stop the
                    # block: statements after a return-bearing if must
                    # not run (they would mutate what the replayed
                    # return expression reads)
                    rest = stmts[i + 1:]
                    del stmts[i + 1:]
                    if rest:
                        self._strip_block(rest, flags, in_loop)
                        guard = ast.If(
                            test=_call("__ptpu_convert_not",
                                       [_or_flags(fired)]),
                            body=rest, orelse=[])
                        stmts.append(ast.copy_location(guard, s))
                    return
                i += 1
                continue
            if isinstance(s, (ast.While, ast.For)) and _contains_return(s):
                before = len(flags)
                self._strip_block(s.body, flags, in_loop=True)
                fired = [f for f, _ in flags[before:]]
                if fired:
                    esc = ast.Break() if in_loop else None
                    if esc is not None:
                        guard = ast.If(test=_or_flags(fired), body=[esc],
                                       orelse=[])
                        stmts.insert(i + 1, ast.copy_location(guard, s))
                        i += 1
                    else:
                        # top level handles the split in _process_level;
                        # reaching here means a loop nested in an if at
                        # top level — guard the rest of this block
                        rest = stmts[i + 1:]
                        del stmts[i + 1:]
                        if rest:
                            keep = ast.If(
                                test=_call("__ptpu_convert_not",
                                           [_or_flags(fired)]),
                                body=rest, orelse=[])
                            stmts.append(ast.copy_location(keep, s))
                i += 1
                continue
            i += 1

    def _strip_if(self, node: ast.If,
                  flags: List[Tuple[str, ast.expr]],
                  in_loop: bool) -> None:
        for arm in (node.body, node.orelse):
            if arm:
                self._strip_block(arm, flags, in_loop)


# --------------------------------------------------------------------------- #
# pass 2: for-range → while desugar (shared with the CF transformer)
# --------------------------------------------------------------------------- #


def _literal_int(node) -> Optional[int]:
    """Static int value of a literal (incl. unary minus), else None."""
    if isinstance(node, ast.Constant) and isinstance(node.value, int) \
            and not isinstance(node.value, bool):
        return node.value
    if isinstance(node, ast.UnaryOp) and isinstance(node.op,
                                                    (ast.USub, ast.UAdd)):
        v = _literal_int(node.operand)
        if v is None:
            return None
        return -v if isinstance(node.op, ast.USub) else v
    return None


def _desugar_for_range(node: ast.For, ctr: _Ctr):
    """`for i in range(a[, b[, c]])` → counter init + While (bump FIRST
    so a `continue` in the body cannot skip it). A 3-arg range needs a
    LITERAL non-zero step: the while test's direction (< vs >) is
    decided at conversion time, so the step's sign must be static.
    Returns None when the loop is not a convertible for-range."""
    if (node.orelse
            or not isinstance(node.target, ast.Name)
            or not isinstance(node.iter, ast.Call)
            or not isinstance(node.iter.func, ast.Name)
            or node.iter.func.id != "range"
            or len(node.iter.args) not in (1, 2, 3)):
        return None
    step = 1
    if len(node.iter.args) == 3:
        step = _literal_int(node.iter.args[2])
        if step is None or step == 0:
            return None  # dynamic/zero step keeps Python semantics
    i = node.target.id
    if len(node.iter.args) == 1:
        start: ast.expr = ast.Constant(value=0)
        stop = node.iter.args[0]
    else:
        start, stop = node.iter.args[:2]
    ctrn = ctr.fresh("ctr")
    nname = ctr.fresh("stop")
    init = [ast.Assign(targets=[ast.Name(id=ctrn, ctx=ast.Store())],
                       value=start),
            ast.Assign(targets=[ast.Name(id=nname, ctx=ast.Store())],
                       value=stop),
            # pre-bind the user var so a traced while carry is typed
            # (body overwrites before any read); an existing binding
            # survives an empty range, like Python
            ast.Assign(
                targets=[ast.Name(id=i, ctx=ast.Store())],
                value=_call("__ptpu_prebind",
                            [_call("locals", []), ast.Constant(value=i),
                             ast.Name(id=ctrn, ctx=ast.Load())]))]
    # the user-visible loop var takes the counter's value at iteration
    # entry, so after the loop it holds the LAST YIELDED value (Python
    # semantics: stop-1 for step 1, start+k*step generally)
    set_i = ast.Assign(targets=[ast.Name(id=i, ctx=ast.Store())],
                       value=ast.Name(id=ctrn, ctx=ast.Load()))
    bump = ast.Assign(
        targets=[ast.Name(id=ctrn, ctx=ast.Store())],
        value=ast.BinOp(left=ast.Name(id=ctrn, ctx=ast.Load()),
                        op=ast.Add(), right=ast.Constant(value=step)))
    as_while = ast.While(
        test=ast.Compare(left=ast.Name(id=ctrn, ctx=ast.Load()),
                         ops=[ast.Lt() if step > 0 else ast.Gt()],
                         comparators=[ast.Name(id=nname, ctx=ast.Load())]),
        body=[set_i, bump] + list(node.body), orelse=[])
    for n in init + [as_while]:
        ast.copy_location(n, node)
    return init + [as_while]


class _ForToWhile(ast.NodeTransformer):
    def __init__(self, ctr: _Ctr):
        self.ctr = ctr

    def visit_For(self, node: ast.For):
        self.generic_visit(node)
        out = _desugar_for_range(node, self.ctr)
        return out if out is not None else node


# --------------------------------------------------------------------------- #
# pass 3: break/continue → guard flags (reference
# break_continue_transformer.py)
# --------------------------------------------------------------------------- #


def _block_has(stmts: List[ast.stmt], kind) -> bool:
    """Any `kind` statement belonging to THIS loop level (not nested
    loops or function definitions)."""
    return _scan(stmts, kind,
                 _FN_SCOPES + (ast.While, ast.For, ast.AsyncFor))


class _BreakContinueTransformer(ast.NodeTransformer):
    """Lowers break/continue in While bodies to boolean guard state:
    `break` → brk flag (strengthens the loop test), `continue` → cont
    flag (reset each iteration); statements after a potential escape
    run under `if not (brk or cont)` guards. The If converter then
    threads the flags like any other state."""

    def __init__(self, ctr: _Ctr):
        self.ctr = ctr

    def visit_While(self, node: ast.While):
        self.generic_visit(node)  # innermost loops first
        has_b = _block_has(node.body, ast.Break)
        has_c = _block_has(node.body, ast.Continue)
        if not (has_b or has_c) or node.orelse:
            return node
        brk = self.ctr.fresh_live("brk") if has_b else None
        cont = self.ctr.fresh_live("cont") if has_c else None
        body = self._rewrite(list(node.body), brk, cont)
        if cont:
            body = [ast.copy_location(_assign_bool(cont, False), node)] \
                + body
        test = node.test
        if brk:
            test = _call("__ptpu_loop_test",
                         [ast.Name(id=brk, ctx=ast.Load()),
                          ast.Lambda(args=_noargs(), body=test)])
        new = ast.While(test=test, body=body, orelse=[])
        ast.copy_location(new, node)
        # BOTH flags need a pre-loop binding: a loop whose condition is
        # traced at entry lowers immediately, and while_loop state
        # must be typed before the first iteration
        pre = [ast.copy_location(_assign_bool(f, False), node)
               for f in (brk, cont) if f]
        return pre + [new]

    def _guard_test(self, brk, cont):
        names = [n for n in (brk, cont) if n]
        return _call("__ptpu_convert_not", [_or_flags(names)])

    def _rewrite(self, stmts: List[ast.stmt], brk, cont
                 ) -> List[ast.stmt]:
        out: List[ast.stmt] = []
        for idx, s in enumerate(stmts):
            if isinstance(s, ast.Break):
                out.append(ast.copy_location(_assign_bool(brk, True), s))
                return out  # rest unreachable
            if isinstance(s, ast.Continue):
                out.append(ast.copy_location(_assign_bool(cont, True), s))
                return out
            if isinstance(s, ast.If) and (
                    _block_has(s.body, (ast.Break, ast.Continue))
                    or _block_has(s.orelse, (ast.Break, ast.Continue))):
                new_if = ast.If(test=s.test,
                                body=self._rewrite(s.body, brk, cont)
                                or [ast.Pass()],
                                orelse=self._rewrite(s.orelse, brk, cont))
                out.append(ast.copy_location(new_if, s))
                rest = self._rewrite(stmts[idx + 1:], brk, cont)
                if rest:
                    guard = ast.If(test=self._guard_test(brk, cont),
                                   body=rest, orelse=[])
                    out.append(ast.copy_location(guard, s))
                return out
            out.append(s)
        return out


class _ControlFlowTransformer(ast.NodeTransformer):
    """Rewrites If/While/For-range into helper-dispatched closures."""

    def __init__(self, ctr: _Ctr = None):
        self.ctr = ctr or _Ctr()
        self.converted = 0

    # --- if/else --------------------------------------------------------- #
    def visit_If(self, node: ast.If):
        self.generic_visit(node)
        if _has_escape(node.body) or _has_escape(node.orelse):
            return node  # early-exit branches keep Python semantics
        # generated __ptpu_* counters/stops are local plumbing of inner
        # conversions — dead beyond their own statement, never threaded
        written = sorted(n for n in (_assigned_names(node.body)
                                     | _assigned_names(node.orelse))
                         if not n.startswith("__ptpu_"))
        if not written:
            return node  # pure side-effect branches: nothing to thread
        tname = self.ctr.fresh("true")
        fname = self.ctr.fresh("false")
        unpack = _unpack_stmt(written)
        ret = ast.Return(value=ast.Tuple(
            elts=[ast.Name(id=w, ctx=ast.Load()) for w in written],
            ctx=ast.Load()))
        t_def = ast.FunctionDef(
            name=tname, args=_onearg("__ptpu_state"),
            body=[unpack] + list(node.body) + [ret], decorator_list=[])
        f_def = ast.FunctionDef(
            name=fname, args=_onearg("__ptpu_state"),
            body=[unpack] + (list(node.orelse) or [ast.Pass()]) + [ret],
            decorator_list=[])
        call = ast.Assign(
            targets=[ast.Tuple(
                elts=[ast.Name(id=w, ctx=ast.Store()) for w in written],
                ctx=ast.Store())],
            value=ast.Call(
                func=ast.Name(id="__ptpu_convert_ifelse", ctx=ast.Load()),
                args=[node.test,
                      ast.Name(id=tname, ctx=ast.Load()),
                      ast.Name(id=fname, ctx=ast.Load()),
                      _load_state_expr(written)],
                keywords=[]))
        self.converted += 1
        return [t_def, f_def, call]

    # --- while ----------------------------------------------------------- #
    def visit_While(self, node: ast.While):
        self.generic_visit(node)
        if _has_escape(node.body) or node.orelse:
            return node
        # loop state = names the body writes (test-read globals/builtins
        # like len/jnp stay free variables of the closures)
        state = sorted(_assigned_names(node.body))
        if not state:
            return node
        cname = self.ctr.fresh("cond")
        bname = self.ctr.fresh("body")
        unpack = _unpack_stmt(state)
        pack = ast.Tuple(elts=[ast.Name(id=s, ctx=ast.Load())
                               for s in state], ctx=ast.Load())
        c_def = ast.FunctionDef(
            name=cname, args=_onearg("__ptpu_state"),
            body=[unpack, ast.Return(value=node.test)],
            decorator_list=[])
        b_def = ast.FunctionDef(
            name=bname, args=_onearg("__ptpu_state"),
            body=[unpack] + list(node.body) + [ast.Return(value=pack)],
            decorator_list=[])
        call = ast.Assign(
            targets=[ast.Tuple(
                elts=[ast.Name(id=s, ctx=ast.Store()) for s in state],
                ctx=ast.Store())],
            value=ast.Call(
                func=ast.Name(id="__ptpu_convert_while", ctx=ast.Load()),
                args=[ast.Name(id=cname, ctx=ast.Load()),
                      ast.Name(id=bname, ctx=ast.Load()),
                      _load_state_expr(state)],
                keywords=[]))
        self.converted += 1
        return [c_def, b_def, call]

    # --- for i in range(...) --------------------------------------------- #
    def visit_For(self, node: ast.For):
        # for-range loops were desugared to While by the _ForToWhile
        # pre-pass; a For reaching here is not convertible (non-range
        # iterable / orelse) and keeps Python semantics
        self.generic_visit(node)
        return node


class _BindNames:
    """The port's last pass: no `locals()` in the converted code, which
    Dynamo (tracing torch.cond and while_loop bodies) cannot trace.
    `__ptpu_load_state(locals(), ("a", ...))` becomes the tuple `(a,
    ...)` and `__ptpu_prebind(locals(), "i", d)` becomes
    `__ptpu_prebind(i, d)`; every name they read is bound to `_UNDEF` at
    the top of its function (generated closures included), unless it is
    a parameter or declared global / nonlocal there. A name not yet
    bound then reads as _UNDEF, as `locals().get(name, _UNDEF)` gives
    the JAX package; a use raises `Dy2StaticError`, as there."""

    def process(self, fdef) -> None:
        names: Set[str] = set()
        outer = self

        class Rewrite(ast.NodeTransformer):
            def visit_FunctionDef(self, node):
                outer.process(node)            # a scope of its own
                return node

            def visit_Lambda(self, node):
                return node

            def visit_Call(self, node):
                self.generic_visit(node)
                fn = node.func.id if isinstance(node.func, ast.Name) \
                    else None
                if fn == "__ptpu_load_state":
                    read = [e.value for e in node.args[1].elts]
                    names.update(read)
                    return ast.copy_location(ast.Tuple(
                        elts=[ast.Name(id=n, ctx=ast.Load()) for n in read],
                        ctx=ast.Load()), node)
                if fn == "__ptpu_prebind":
                    name = node.args[1].value
                    names.add(name)
                    return ast.copy_location(_call("__ptpu_prebind", [
                        ast.Name(id=name, ctx=ast.Load()), node.args[2]]),
                        node)
                return node

        fdef.body = [Rewrite().visit(st) for st in fdef.body]
        args = fdef.args
        bound = {a.arg for a in args.posonlyargs + args.args
                 + args.kwonlyargs}
        bound |= {a.arg for a in (args.vararg, args.kwarg) if a}
        head = 0
        while head < len(fdef.body) and isinstance(
                fdef.body[head], (ast.Global, ast.Nonlocal)):
            bound.update(fdef.body[head].names)
            head += 1
        for st in fdef.body:
            if isinstance(st, (ast.Global, ast.Nonlocal)):
                bound.update(st.names)
        fdef.body[head:head] = [
            ast.copy_location(ast.Assign(
                targets=[ast.Name(id=n, ctx=ast.Store())],
                value=ast.Name(id="__ptpu_UNDEF", ctx=ast.Load())), fdef)
            for n in sorted(names - bound)]


class _IndexTransformer(ast.NodeTransformer):
    """`a[i]` and `a[i, j]` (reads whose index is not a literal and holds
    no slice) → `__ptpu_getitem(a, i)`: the port's addition
    to the JAX package's passes, for the index a traced loop counter
    gives (`getitem`)."""

    def visit_Subscript(self, node: ast.Subscript):
        self.generic_visit(node)
        index = node.slice
        if (not isinstance(node.ctx, ast.Load)
                or isinstance(index, (ast.Slice, ast.Constant))
                or isinstance(index, ast.Tuple) and any(
                    isinstance(e, (ast.Slice, ast.Starred))
                    for e in index.elts)):
            return node
        return ast.copy_location(
            _call("__ptpu_getitem", [node.value, node.slice]), node)


def _noargs():
    return ast.arguments(posonlyargs=[], args=[], vararg=None,
                         kwonlyargs=[], kw_defaults=[], kwarg=None,
                         defaults=[])


def _onearg(name):
    a = _noargs()
    a.args = [ast.arg(arg=name)]
    return a


def _unpack_stmt(names):
    """(a, b, ...) = __ptpu_state"""
    return ast.Assign(
        targets=[ast.Tuple(
            elts=[ast.Name(id=n, ctx=ast.Store()) for n in names],
            ctx=ast.Store())],
        value=ast.Name(id="__ptpu_state", ctx=ast.Load()))


def _load_state_expr(names):
    """__ptpu_load_state(locals(), ("a", "b", ...)) — the current values
    at the call site, _UNDEF for not-yet-bound names."""
    return ast.Call(
        func=ast.Name(id="__ptpu_load_state", ctx=ast.Load()),
        args=[ast.Call(func=ast.Name(id="locals", ctx=ast.Load()),
                       args=[], keywords=[]),
              ast.Tuple(elts=[ast.Constant(value=n) for n in names],
                        ctx=ast.Load())],
        keywords=[])


def convert_to_static(fn: Callable) -> Callable:
    """AST-convert `fn`'s if/while/for-range statements to runtime-
    dispatched control flow. Returns `fn` unchanged when its source is
    unavailable or contains nothing convertible."""
    if hasattr(fn, "__wrapped__"):
        # a functools.wraps chain: getsource would reach the innermost
        # body and the recompile would silently DROP the wrappers
        return fn
    try:
        lines, first_lineno = inspect.getsourcelines(fn)
        src = textwrap.dedent("".join(lines))
        tree = ast.parse(src)
        # error attribution (reference origin_info.py): keep the user's
        # own line numbers so trace-time failures point at their source
        ast.increment_lineno(tree, first_lineno - 1)
    except (OSError, TypeError, SyntaxError, IndentationError):
        return fn
    fdef = tree.body[0]
    if not isinstance(fdef, (ast.FunctionDef, ast.AsyncFunctionDef)):
        return fn
    if any(isinstance(n, ast.Nonlocal) for n in ast.walk(fdef)):
        # the recompiled module-level function would have no enclosing
        # scope for the nonlocal — leave such closures unconverted
        return fn
    fdef.decorator_list = []  # don't re-apply @to_static etc.
    ctr = _Ctr()
    retf = _ReturnFunctionalizer(ctr)
    retf.process_function(fdef)
    _ForToWhile(ctr).visit(fdef)
    _BreakContinueTransformer(ctr).visit(fdef)
    tr = _ControlFlowTransformer(ctr)
    tr.visit(fdef)
    if tr.converted == 0 and not retf.applied:
        return fn
    _IndexTransformer().visit(fdef)
    _BindNames().process(fdef)
    ast.fix_missing_locations(tree)
    # the converted code runs in a module of its own (a copy of the
    # function's globals plus the helpers): torch.cond and while_loop
    # trace their branches with Dynamo, which resolves a function's
    # globals through its module (`__name__`), not its globals dict
    modname = f"{__name__}._converted_{next(_MODULES)}"
    module = types.ModuleType(modname)
    ns = module.__dict__
    ns.update(fn.__globals__)
    ns["__name__"] = modname
    ns["__ptpu_convert_ifelse"] = convert_ifelse
    ns["__ptpu_convert_while"] = convert_while
    ns["__ptpu_convert_not"] = convert_not
    ns["__ptpu_convert_and"] = convert_and
    ns["__ptpu_convert_or"] = convert_or
    ns["__ptpu_loop_test"] = loop_test
    ns["__ptpu_select_return"] = select_return
    ns["__ptpu_prebind"] = prebind
    ns["__ptpu_UNDEF"] = _UNDEF
    ns["__ptpu_getitem"] = getitem
    sys.modules[modname] = module
    # freeze the current closure cell values (documented limitation:
    # later rebinds of free variables are not observed)
    if fn.__closure__:
        for name, cell in zip(fn.__code__.co_freevars, fn.__closure__):
            try:
                ns[name] = cell.cell_contents
            except ValueError:
                pass
    # compile against the ORIGINAL file so tracebacks show user source
    code = compile(tree, filename=fn.__code__.co_filename, mode="exec")
    exec(code, ns)
    out = ns[fdef.name]
    out = functools.wraps(fn)(out)
    out.__wrapped_dy2static__ = True
    return out
