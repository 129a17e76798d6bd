"""Predicate/projection expression IR.

A copy of ``hyperspace_tpu.plan.expr`` whose device evaluation runs on
torch tensors. Filter predicates over single columns and equi-join
conditions; expressions evaluate against a ColumnarBatch on the host
(numpy) or on the device (torch) — both backends share the operator
surface, and string literals are resolved to dictionary-code comparisons
host-side before evaluation, exploiting the order-preserving encoding.

NULL semantics: string NULLs are code -1; every comparison excludes them
(SQL-style: NULL never satisfies a predicate).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, FrozenSet, Optional

import numpy as np

from ..exceptions import HyperspaceException
from ..storage.columnar import ColumnarBatch, is_string


class Expr:
    def columns(self) -> FrozenSet[str]:
        raise NotImplementedError

    # -- operator sugar ------------------------------------------------------
    def __and__(self, other: "Expr") -> "Expr":
        return And(self, _as_expr(other))

    def __or__(self, other: "Expr") -> "Expr":
        return Or(self, _as_expr(other))

    def __invert__(self) -> "Expr":
        return Not(self)

    def __eq__(self, other):  # type: ignore[override]
        return Cmp("eq", self, _as_expr(other))

    def __ne__(self, other):  # type: ignore[override]
        return Cmp("ne", self, _as_expr(other))

    def __lt__(self, other):
        return Cmp("lt", self, _as_expr(other))

    def __le__(self, other):
        return Cmp("le", self, _as_expr(other))

    def __gt__(self, other):
        return Cmp("gt", self, _as_expr(other))

    def __ge__(self, other):
        return Cmp("ge", self, _as_expr(other))

    def __hash__(self) -> int:
        return hash(repr(self))


def _as_expr(v: Any) -> Expr:
    return v if isinstance(v, Expr) else Lit(v)


@dataclass(frozen=True, eq=False)
class Col(Expr):
    name: str

    def columns(self) -> FrozenSet[str]:
        return frozenset({self.name})

    def __repr__(self) -> str:
        return f"col({self.name})"


@dataclass(frozen=True, eq=False)
class Lit(Expr):
    value: Any

    def columns(self) -> FrozenSet[str]:
        return frozenset()

    def __repr__(self) -> str:
        return f"lit({self.value!r})"


@dataclass(frozen=True, eq=False)
class Cmp(Expr):
    op: str  # eq ne lt le gt ge
    left: Expr
    right: Expr

    def columns(self) -> FrozenSet[str]:
        return self.left.columns() | self.right.columns()

    def __repr__(self) -> str:
        return f"({self.left!r} {self.op} {self.right!r})"


@dataclass(frozen=True, eq=False)
class And(Expr):
    left: Expr
    right: Expr

    def columns(self) -> FrozenSet[str]:
        return self.left.columns() | self.right.columns()

    def __repr__(self) -> str:
        return f"({self.left!r} & {self.right!r})"


@dataclass(frozen=True, eq=False)
class Or(Expr):
    left: Expr
    right: Expr

    def columns(self) -> FrozenSet[str]:
        return self.left.columns() | self.right.columns()

    def __repr__(self) -> str:
        return f"({self.left!r} | {self.right!r})"


@dataclass(frozen=True, eq=False)
class Not(Expr):
    child: Expr

    def columns(self) -> FrozenSet[str]:
        return self.child.columns()

    def __repr__(self) -> str:
        return f"~({self.child!r})"


@dataclass(frozen=True, eq=False)
class In(Expr):
    child: Expr
    values: tuple

    def columns(self) -> FrozenSet[str]:
        return self.child.columns()

    def __repr__(self) -> str:
        return f"({self.child!r} in {self.values!r})"


def col(name: str) -> Col:
    return Col(name)


def lit(value: Any) -> Lit:
    return Lit(value)


def is_in(e: Expr, values) -> In:
    return In(e, tuple(values))


# ---------------------------------------------------------------------------
# evaluation
# ---------------------------------------------------------------------------
_SWAP = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le", "eq": "eq", "ne": "ne"}


def _string_cmp_codes(op: str, vocab: np.ndarray, value) -> tuple:
    """Translate ``codes <op> string-literal`` into a code comparison using
    the order-preserving dictionary. Returns (op, code_bound, always) where
    ``always`` is True/False for statically-decided masks, else None."""
    v = value.encode() if isinstance(value, str) else bytes(value)
    pos = int(np.searchsorted(vocab, v))
    found = pos < len(vocab) and vocab[pos] == v
    if op == "eq":
        return ("eq", pos, None) if found else (op, 0, False)
    if op == "ne":
        return ("ne", pos, None) if found else (op, 0, True)
    if op == "lt":  # codes of strings < v are exactly codes < pos
        return ("lt", pos, None)
    if op == "ge":
        return ("ge", pos, None)
    if op == "le":  # <= v  ⇔  < pos(+1 if v present)
        return ("lt", pos + (1 if found else 0), None)
    if op == "gt":
        return ("ge", pos + (1 if found else 0), None)
    raise HyperspaceException(f"Unknown comparison op {op}.")


def _apply_cmp(xp, op: str, a, b):
    if op == "eq":
        return a == b
    if op == "ne":
        return a != b
    if op == "lt":
        return a < b
    if op == "le":
        return a <= b
    if op == "gt":
        return a > b
    if op == "ge":
        return a >= b
    raise HyperspaceException(f"Unknown comparison op {op}.")


def eval_mask(expr: Expr, batch: ColumnarBatch, arrays=None):
    """Evaluate a boolean expression to a row mask.

    ``arrays=None``: host evaluation with numpy over batch data.
    ``arrays=dict``: device evaluation — values are torch tensors on one
    device (e.g. from ``batch.device_arrays()``); the returned mask is a
    bool tensor there. The batch is still consulted for schemas and
    dictionaries (literal resolution is host-side either way).
    """
    if arrays is None:
        xp = np
        get = lambda name: batch.columns[name].data  # noqa: E731
    else:
        import torch

        xp = torch

        def get(name):
            t = arrays[name]
            # compare narrow integer lanes in int64: a Python int literal
            # outside the column dtype's range must compare by value (as
            # numpy does), not overflow
            if not t.dtype.is_floating_point and t.dtype not in (
                torch.int64,
                torch.bool,
            ):
                return t.to(torch.int64)
            return t

    def ev(e: Expr):
        if isinstance(e, And):
            return ev(e.left) & ev(e.right)
        if isinstance(e, Or):
            return ev(e.left) | ev(e.right)
        if isinstance(e, Not):
            return ~ev(e.child)
        if isinstance(e, Cmp):
            return ev_cmp(e)
        if isinstance(e, In):
            return ev_in(e)
        raise HyperspaceException(f"Not a boolean expression: {e!r}.")

    def _full(value: bool):
        # With explicit (possibly padded) device arrays, masks must match
        # the array length, not the batch's logical row count.
        if arrays is not None and arrays:
            first = next(iter(arrays.values()))
            return xp.full(
                (first.shape[0],), value, dtype=xp.bool, device=first.device
            )
        return xp.full(batch.num_rows, value, dtype=bool)

    def ev_cmp(e: Cmp):
        left, right, op = e.left, e.right, e.op
        if isinstance(left, Lit) and isinstance(right, Col):
            left, right, op = right, left, _SWAP[op]
        if isinstance(left, Col) and isinstance(right, Lit):
            c = batch.columns[left.name]
            data = get(left.name)
            if is_string(c.dtype_str):
                cop, bound, always = _string_cmp_codes(op, c.vocab, right.value)
                if always is not None:
                    base = _full(always)
                else:
                    base = _apply_cmp(xp, cop, data, bound)
                return base & (data >= 0)  # NULL never matches (incl. ne)
            return _apply_cmp(xp, op, data, right.value)
        if isinstance(left, Col) and isinstance(right, Col):
            lc, rc = batch.columns[left.name], batch.columns[right.name]
            if is_string(lc.dtype_str) != is_string(rc.dtype_str):
                raise HyperspaceException("Cannot compare string to non-string.")
            if is_string(lc.dtype_str) and lc.vocab is not rc.vocab:
                if not np.array_equal(lc.vocab, rc.vocab):
                    raise HyperspaceException(
                        "String col-col comparison requires a unified dictionary."
                    )
            m = _apply_cmp(xp, op, get(left.name), get(right.name))
            if is_string(lc.dtype_str):
                m = m & (get(left.name) >= 0) & (get(right.name) >= 0)
            return m
        raise HyperspaceException(f"Unsupported comparison shape: {e!r}.")

    def ev_in(e: In):
        if not isinstance(e.child, Col):
            raise HyperspaceException("IN requires a column child.")
        c = batch.columns[e.child.name]
        data = get(e.child.name)
        m = _full(False)
        for v in e.values:
            if is_string(c.dtype_str):
                cop, bound, always = _string_cmp_codes("eq", c.vocab, v)
                if always is not None:
                    continue
                m = m | _apply_cmp(xp, cop, data, bound)
            else:
                m = m | (data == v)
        if is_string(c.dtype_str):
            m = m & (data >= 0)
        return m

    return ev(expr)


def resolve_expr_columns(expr: Expr, available) -> Expr:
    """Rewrite every ``Col`` reference to the canonical spelling from
    ``available`` (case-insensitive — ResolverUtils.resolve semantics,
    the analyzer normalization Spark gave the reference for free). Names
    with no match keep their spelling: downstream execution raises its
    usual unknown-column error, exactly as before."""
    from ..utils import resolver

    def walk(e: Expr) -> Expr:
        if isinstance(e, And):
            return And(walk(e.left), walk(e.right))
        if isinstance(e, Or):
            return Or(walk(e.left), walk(e.right))
        if isinstance(e, Not):
            return Not(walk(e.child))
        if isinstance(e, Cmp):
            return Cmp(e.op, walk(e.left), walk(e.right))
        if isinstance(e, In):
            child = walk(e.child)
            return In(child, e.values) if child is not e.child else e
        if isinstance(e, Col):
            m = resolver.resolve(e.name, list(available))
            return Col(m) if m is not None and m != e.name else e
        return e

    return walk(expr)


def bind_string_literals(expr: Expr, batch: ColumnarBatch) -> Expr:
    """Rewrite ``expr`` so every string comparison becomes a pure code-space
    (int32) comparison against this batch's dictionary.

    The result references no vocabulary at evaluation time — string columns
    act as plain int32 code columns — which lets a jitted evaluator close
    over only the bound expression, not the (potentially file-sized) vocab.
    NULL codes (-1) are excluded exactly as eval_mask does."""

    def is_str_col(e: Expr) -> bool:
        return (
            isinstance(e, Col)
            and e.name in batch.columns
            and is_string(batch.columns[e.name].dtype_str)
        )

    def never(c: Col) -> Expr:
        return Cmp("lt", c, Lit(-1))  # codes are >= -1: always False

    def walk(e: Expr) -> Expr:
        if isinstance(e, And):
            return And(walk(e.left), walk(e.right))
        if isinstance(e, Or):
            return Or(walk(e.left), walk(e.right))
        if isinstance(e, Not):
            return Not(walk(e.child))
        if isinstance(e, Cmp):
            left, right, op = e.left, e.right, e.op
            if isinstance(left, Lit) and isinstance(right, Col):
                left, right, op = right, left, _SWAP[op]
            if is_str_col(left) and isinstance(right, Lit):
                vocab = batch.columns[left.name].vocab
                cop, bound, always = _string_cmp_codes(op, vocab, right.value)
                if always is False:
                    return never(left)
                if always is True:
                    return Cmp("ge", left, Lit(0))  # any non-NULL
                return And(Cmp(cop, left, Lit(bound)), Cmp("ge", left, Lit(0)))
            if is_str_col(left) and is_str_col(right):
                lc, rc = batch.columns[left.name], batch.columns[right.name]
                if lc.vocab is not rc.vocab and not np.array_equal(lc.vocab, rc.vocab):
                    raise HyperspaceException(
                        "String col-col comparison requires a unified dictionary."
                    )
                return And(
                    And(Cmp(op, left, right), Cmp("ge", left, Lit(0))),
                    Cmp("ge", right, Lit(0)),
                )
            return e
        if isinstance(e, In) and is_str_col(e.child):
            vocab = batch.columns[e.child.name].vocab
            out: Optional[Expr] = None
            for v in e.values:
                cop, bound, always = _string_cmp_codes("eq", vocab, v)
                if always is not None:
                    continue
                term = Cmp(cop, e.child, Lit(bound))
                out = term if out is None else Or(out, term)
            if out is None:
                return never(e.child)
            return And(out, Cmp("ge", e.child, Lit(0)))
        return e

    return walk(expr)


def pinned_values(expr: Expr, column: str):
    """Values ``column`` is pinned to by equality in ``expr``, or None if
    the expression does not pin it to a finite set. AND: either side's
    pins suffice (conjunction can only narrow); OR: both sides must pin
    (union). Used for hash-bucket pruning on the scan path."""
    if isinstance(expr, And):
        left = pinned_values(expr.left, column)
        right = pinned_values(expr.right, column)
        if left is None:
            return right
        if right is None:
            return left
        both = left & right
        return both if both else left  # disjoint pins: conservative
    if isinstance(expr, Or):
        left = pinned_values(expr.left, column)
        right = pinned_values(expr.right, column)
        if left is None or right is None:
            return None
        return left | right
    if isinstance(expr, Cmp) and expr.op == "eq":
        l, r = expr.left, expr.right
        if isinstance(l, Lit) and isinstance(r, Col):
            l, r = r, l
        if isinstance(l, Col) and l.name == column and isinstance(r, Lit):
            return {r.value}
        return None
    if isinstance(expr, In) and isinstance(expr.child, Col) and expr.child.name == column:
        return set(expr.values)
    return None


def bounds_for_column(expr: Expr, column: str):
    """Extract a conservative [lo, hi] numeric bound implied by ``expr`` for
    ``column`` (used for TCB min/max file pruning). Returns (lo, hi) with
    None meaning unbounded; only AND-connected conjuncts tighten bounds."""
    lo: Any = None
    hi: Any = None

    def visit(e: Expr) -> None:
        nonlocal lo, hi
        if isinstance(e, And):
            visit(e.left)
            visit(e.right)
            return
        if isinstance(e, Cmp):
            left, right, op = e.left, e.right, e.op
            if isinstance(left, Lit) and isinstance(right, Col):
                left, right, op = right, left, _SWAP[op]
            if (
                isinstance(left, Col)
                and left.name == column
                and isinstance(right, Lit)
                and isinstance(right.value, (int, float))
                and not isinstance(right.value, bool)
            ):
                v = right.value
                if op == "eq":
                    lo = v if lo is None else max(lo, v)
                    hi = v if hi is None else min(hi, v)
                elif op in ("gt", "ge"):
                    lo = v if lo is None else max(lo, v)
                elif op in ("lt", "le"):
                    hi = v if hi is None else min(hi, v)

    visit(expr)
    return lo, hi


def to_arrow_filter(expr: Expr):
    """Best-effort translation of a predicate into a pyarrow compute
    Expression for scanner-level pushdown (row-group stats pruning + page
    skipping inside the parquet reader). Partial translation is sound
    because callers ALWAYS re-apply the full predicate mask after the
    read: a conjunct that doesn't translate is simply not pushed, an Or or
    Not translates only when complete (pushing half a disjunction would
    drop rows). Returns None when nothing safely translates."""
    import pyarrow.compute as pc

    def lit_ok(v) -> bool:
        return isinstance(v, (bool, int, float, str, np.integer, np.floating))

    def full(e) -> "pc.Expression | None":
        # exact-or-superset translation, or None (used under Or where a
        # partial conjunct would be unsound). NULL semantics make two
        # shapes untranslatable/special:
        #   * Not is never pushed: arrow's ~(null) is null and the reader
        #     drops the row, while the engine's NULL-fails-inner-predicate
        #     rule KEEPS it under negation — rows the reader never
        #     materializes can't be resurrected by the re-applied mask;
        #   * ne keeps nulls explicitly ((x != v) | is_null(x)): float
        #     NULLs ingest as NaN, and NaN != v is True for the engine.
        if isinstance(e, And):
            l, r = full(e.left), full(e.right)
            return l & r if l is not None and r is not None else None
        if isinstance(e, Or):
            l, r = full(e.left), full(e.right)
            return l | r if l is not None and r is not None else None
        if isinstance(e, Not):
            return None
        if isinstance(e, In):
            if isinstance(e.child, Col) and e.values and all(
                lit_ok(v) for v in e.values
            ):
                return pc.field(e.child.name).isin(list(e.values))
            return None
        if isinstance(e, Cmp):
            ops = {
                "eq": lambda a, b: a == b,
                "lt": lambda a, b: a < b,
                "le": lambda a, b: a <= b,
                "gt": lambda a, b: a > b,
                "ge": lambda a, b: a >= b,
            }
            l, r = e.left, e.right
            if isinstance(l, Col) and isinstance(r, Lit) and lit_ok(r.value):
                if e.op == "ne":
                    f = pc.field(l.name)
                    return (f != r.value) | f.is_null()
                return ops[e.op](pc.field(l.name), r.value)
            if isinstance(l, Lit) and isinstance(r, Col) and lit_ok(l.value):
                if e.op == "ne":
                    f = pc.field(r.name)
                    return (l.value != f) | f.is_null()
                return ops[e.op](l.value, pc.field(r.name))
            return None
        return None

    def partial(e) -> "pc.Expression | None":
        if isinstance(e, And):
            l, r = partial(e.left), partial(e.right)
            if l is not None and r is not None:
                return l & r
            return l if l is not None else r
        return full(e)

    return partial(expr)
