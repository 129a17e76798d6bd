"""Order-preserving int64 encoding of float64 — the device transport format.

A copy of ``hyperspace_tpu.ops.floatbits`` (without the two-plane int32
form its residency caches use).

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
