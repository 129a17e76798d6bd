"""Order-preserving int64 encoding of float64 — the device transport format.

A copy of ``hyperspace_tpu.ops.floatbits``, including the two-plane int32
form the HBM-resident scan stores float64 columns in.

float64 does not survive a round trip through the TPU bit-exactly (v5e
emulates f64; even a plain transfer perturbs low bits — observed
3421.33 → 3421.3300000000017). An indexing framework cannot tolerate lossy
value columns, so float64 NEVER crosses the device boundary as float:
columns are encoded host-side into int64 whose *signed integer order equals
the float order* (IEEE total-order trick: negatives bit-flipped, positives
kept), moved/sorted/hashed as integers, and decoded after.

-0.0 normalizes to +0.0; NaNs sort above +inf and are preserved bit-wise.
"""

from __future__ import annotations

import numpy as np

_TOP = np.int64(np.uint64(0x8000000000000000).astype(np.int64))


def f64_to_ordered_i64(a: np.ndarray) -> np.ndarray:
    """Encode float64 -> int64 with order preserved (exact, invertible)."""
    a = np.asarray(a, dtype=np.float64)
    a = np.where(a == 0.0, 0.0, a)  # -0.0 -> +0.0
    bits = a.view(np.int64)
    return np.where(bits < 0, np.bitwise_xor(~bits, _TOP), bits)


def ordered_i64_to_f64(o: np.ndarray) -> np.ndarray:
    """Invert f64_to_ordered_i64."""
    o = np.asarray(o, dtype=np.int64)
    bits = np.where(o < 0, ~np.bitwise_xor(o, _TOP), o)
    return bits.view(np.float64)


def f64_scalar_to_ordered(v: float) -> np.int64:
    return f64_to_ordered_i64(np.array([v], dtype=np.float64))[0]


# Distinct quiet-NaN payloads, reserved as join-side NaN sentinels: after
# float_key_codes canonicalizes every data NaN to np.nan's bit pattern,
# no data code can collide with these — so poisoning the two sides of a
# join with DIFFERENT sentinels makes NaN match nothing, itself included.
NAN_KEY_LEFT = np.int64(0x7FF8000000000001)
NAN_KEY_RIGHT = np.int64(0x7FF8000000000002)


def float_key_codes(a: np.ndarray):
    """(int64 bit codes, NaN mask) for a float KEY column — the ONE
    float-key normalization shared by the join's exact codes and the
    aggregate's group keys (it used to live in two copies that could
    drift). -0.0 normalizes to +0.0 and every NaN canonicalizes to one
    bit pattern, so code equality ⟺ value equality with NaN == NaN;
    callers choose SQL semantics from there: joins poison the mask's
    rows with per-side sentinels (NaN never matches), aggregates keep
    the canonical code (NaN is one valid group key)."""
    f = np.asarray(a, dtype=np.float64)
    nan = np.isnan(f)
    f = np.where(f == 0.0, 0.0, f)
    if nan.any():
        f = np.where(nan, np.nan, f)
    return f.view(np.int64), nan


_TOP32 = np.int32(np.uint32(0x80000000).astype(np.int32))


def f32_to_ordered_i32(a: np.ndarray) -> np.ndarray:
    """32-bit twin of f64_to_ordered_i64: float32 -> int32 with order
    preserved (-0.0 normalized). Used by the Pallas predicate kernel's
    narrowing and the streaming build's merge keys."""
    a = np.asarray(a, dtype=np.float32)
    a = np.where(a == np.float32(0.0), np.float32(0.0), a)
    bits = a.view(np.int32)
    return np.where(bits < 0, np.bitwise_xor(~bits, _TOP32), bits)


# ---------------------------------------------------------------------------
# Two-plane int32 representation of the ordered-i64 encoding — float64 on
# the RESIDENT device path (an f64 conjunct must not evict the whole
# predicate to the host). The resident caches store int32 planes; an
# ordered-i64 value splits into a signed high plane and an
# offset-binary low plane such that LEXICOGRAPHIC (hi, lo) signed order
# equals the i64 order — so any comparison against an f64 literal becomes
# pure int32 arithmetic the mask kernels already evaluate.
# ---------------------------------------------------------------------------


def ordered_i64_planes(o: np.ndarray):
    """(hi, lo) int32 planes of ordered-i64 values: ``hi = o >> 32``
    (signed), ``lo = (o & 0xffffffff) ^ 0x80000000`` reinterpreted signed
    (offset-binary, so signed int32 compare == unsigned low-word
    compare)."""
    o = np.asarray(o, dtype=np.int64)
    hi = (o >> np.int64(32)).astype(np.int32)
    lo = (o & np.int64(0xFFFFFFFF)).astype(np.uint32)
    lo = np.bitwise_xor(lo, np.uint32(0x80000000)).view(np.int32)
    return hi, lo


def f64_literal_planes(v):
    """(hi, lo) int32 plane literals for an f64 comparison literal, or
    None when the literal cannot ride the encoding with unchanged
    comparison semantics (non-numeric, NaN, or a Python int float64
    would round — rounding a literal changes eq/range results)."""
    if isinstance(v, bool) or not isinstance(
        v, (int, float, np.floating, np.integer)
    ):
        return None
    try:
        f = np.float64(v)
    except (ValueError, TypeError, OverflowError):
        return None
    if np.isnan(f):
        return None  # NaN never compares equal to anything
    if isinstance(v, (int, np.integer)) and int(f) != int(v):
        return None  # literal not exactly representable in f64
    hi, lo = ordered_i64_planes(f64_to_ordered_i64(np.array([f])))
    return int(hi[0]), int(lo[0])


def plane_names(column: str):
    """The synthetic column names an f64 column's planes ride under in an
    expanded predicate ('\\x00' cannot appear in real column names)."""
    return f"{column}\x00hi", f"{column}\x00lo"


def expand_f64_predicate(expr, f64_cols):
    """Rewrite comparisons on float64 columns into equivalent two-plane
    int32 expressions over ``plane_names`` columns, or None when the
    predicate's shape cannot be expanded exactly (f64 col-col compares,
    unexpandable literals). Non-f64 subtrees pass through untouched; the
    result narrows under ops.kernels.narrow_expr_to_i32 like any int
    predicate."""
    from ..plan.expr import And, Cmp, Col, In, Lit, Not, Or, col

    I32_MIN, I32_MAX = -(2**31), 2**31 - 1

    # two-state combinators: Expr | None (constant false) — lo_eq always
    # yields an Expr and hi-plane compares never collapse, so a constant
    # TRUE cannot arise
    def and_(a, b):
        if a is None or b is None:
            return None
        return a & b

    def or_(a, b):
        if a is None:
            return b
        if b is None:
            return a
        return a | b

    def cmp_planes(op: str, name: str, v):
        """The kernel narrowing contract (ops.kernels._fits_i32) reserves
        the int32 endpoints, and LOW-plane literals land exactly there
        whenever the encoded low word is 0x00000000/0xffffffff (any
        literal with >= 32 trailing zero mantissa bits) — so endpoint
        low-plane comparisons are remapped algebraically instead of
        emitted. High-plane literals cannot hit the endpoints for
        non-NaN literals (the i64 encoding's top bits are exponent
        biased away from them)."""
        pl = f64_literal_planes(v)
        if pl is None:
            return None
        lh, ll = pl
        hi, lo = (col(n) for n in plane_names(name))

        def lo_eq():
            if ll == I32_MAX:
                return lo > (I32_MAX - 1)
            if ll == I32_MIN:
                return lo < (I32_MIN + 1)
            return lo == ll

        def lo_lt():
            if ll == I32_MIN:
                return None  # nothing below the minimum
            if ll == I32_MAX:
                return lo <= (I32_MAX - 1)
            return lo < ll

        def lo_gt():
            if ll == I32_MAX:
                return None  # nothing above the maximum
            if ll == I32_MIN:
                return lo >= (I32_MIN + 1)
            return lo > ll

        eq = and_(hi == lh, lo_eq())
        if op == "eq":
            return eq
        if op == "ne":
            return Not(eq)
        if op in ("lt", "le"):
            strict = or_(hi < lh, and_(hi == lh, lo_lt()))
            return strict if op == "lt" else or_(strict, eq)
        if op in ("gt", "ge"):
            strict = or_(hi > lh, and_(hi == lh, lo_gt()))
            return strict if op == "gt" else or_(strict, eq)
        return None

    def walk(e):
        if isinstance(e, (And, Or)):
            l, r = walk(e.left), walk(e.right)
            if l is None or r is None:
                return None
            return type(e)(l, r)
        if isinstance(e, Not):
            c = walk(e.child)
            return None if c is None else Not(c)
        if isinstance(e, Cmp):
            lc = isinstance(e.left, Col) and e.left.name in f64_cols
            rc = isinstance(e.right, Col) and e.right.name in f64_cols
            if not lc and not rc:
                return e
            if lc and rc:
                return None  # f64 col-col compare: planes don't compose
            if lc and isinstance(e.right, Lit):
                return cmp_planes(e.op, e.left.name, e.right.value)
            if rc and isinstance(e.left, Lit):
                flip = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le"}
                op = flip.get(e.op, e.op)
                return cmp_planes(op, e.right.name, e.left.value)
            return None
        if isinstance(e, In):
            if not (isinstance(e.child, Col) and e.child.name in f64_cols):
                return e
            if not e.values:
                return None
            parts = [cmp_planes("eq", e.child.name, v) for v in e.values]
            if any(p is None for p in parts):
                return None
            out = parts[0]
            for p in parts[1:]:
                out = out | p
            return out
        return e

    return walk(expr)
