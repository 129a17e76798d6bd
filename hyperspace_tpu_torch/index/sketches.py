"""Data-skipping sketches: per-source-file summaries that prune file lists.

A copy of ``hyperspace_tpu.index.sketches``. Instead of materializing a
covering copy of the data, a data-skipping index stores one small sketch per source
file per sketched column; at query time files whose sketches cannot
satisfy the predicate are never opened. Pruning is conservative — a bloom
filter has false positives but no false negatives, and min/max bounds are
exact — so query results are identical with and without the index (the
row-parity oracle of E2EHyperspaceRulesTest.scala:1004-1019 holds by
construction).

Three sketch kinds:
  * MinMaxSketch(column)          — file min/max, prunes range predicates;
  * ValueListSketch(column)       — exact distinct values while the file
                                    stays under ``max_size`` distincts;
  * BloomFilterSketch(column)     — bits sized from fpp/expected, prunes
                                    equality/IN predicates.

Hashing rides the framework's canonical key representation
(ops.hashing.key_repr / scalar_key_repr) so every dtype — including
dictionary-encoded strings — sketches through the same int64 lane, and a
bloom build over a large batch is one vectorized pass.
"""

from __future__ import annotations

import base64
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np

from ..exceptions import HyperspaceException
from ..ops.hashing import key_repr, scalar_key_repr
from ..storage.columnar import Column, is_string

_LN2 = float(np.log(2.0))


def _fmix64(h: np.ndarray) -> np.ndarray:
    """murmur3 64-bit finalizer, vectorized (wrapping uint64)."""
    h = h.astype(np.uint64)
    with np.errstate(over="ignore"):
        h ^= h >> np.uint64(33)
        h = (h * np.uint64(0xFF51AFD7ED558CCD)).astype(np.uint64)
        h ^= h >> np.uint64(33)
        h = (h * np.uint64(0xC4CEB9FE1A85EC53)).astype(np.uint64)
        h ^= h >> np.uint64(33)
    return h


def _bloom_positions(reprs: np.ndarray, num_bits: int, num_hashes: int) -> np.ndarray:
    """(n, k) bit positions via double hashing: h1 + i*h2 mod m."""
    u = reprs.view(np.uint64) if reprs.dtype == np.int64 else reprs.astype(np.uint64)
    h1 = _fmix64(u)
    h2 = _fmix64(u ^ np.uint64(0x9E3779B97F4A7C15)) | np.uint64(1)
    i = np.arange(num_hashes, dtype=np.uint64)
    with np.errstate(over="ignore"):
        return ((h1[:, None] + i[None, :] * h2[:, None]) % np.uint64(num_bits)).astype(
            np.int64
        )


def _json_value(v: Any, dtype_str: str) -> Any:
    if is_string(dtype_str):
        return v.decode("utf-8", "replace") if isinstance(v, bytes) else str(v)
    if isinstance(v, (np.floating, float)):
        return float(v)
    return int(v)


def _lit_comparable(v: Any, dtype_str: str) -> Any:
    """Normalize a predicate literal for comparison with stored JSON
    values."""
    if is_string(dtype_str):
        return v.decode("utf-8", "replace") if isinstance(v, bytes) else str(v)
    return float(v) if isinstance(v, (float, np.floating)) else int(v)


def _string_values(col: Column) -> np.ndarray:
    valid = col.data >= 0
    return col.vocab[col.data[valid]] if col.vocab.size else np.array([], dtype=object)


@dataclass(frozen=True)
class SketchSpec:
    """Base: one sketch over one column."""

    column: str

    kind = "Sketch"

    def to_json_dict(self) -> Dict[str, Any]:
        return {"kind": self.kind, "column": self.column}

    # -- per-file build / evaluation -----------------------------------------
    def build(self, col: Column) -> Dict[str, Any]:
        raise NotImplementedError

    def prepare_test(self, dtype_str: str, bounds, pins):
        """Normalize the predicate ONCE and return ``test(data) -> bool``
        for per-file evaluation — literal conversion (and bloom position
        hashing) are loop-invariant across a file list.

        Default: wrap a subclass's overridden ``can_match`` (the older
        extension point), so a can_match-only subclass still prunes
        instead of raising NotImplementedError, which the rule's error
        handling would turn into silently disabled skipping. The override
        check guards against recursing into the base can_match, which
        itself delegates here."""
        if type(self).can_match is not SketchSpec.can_match:
            return lambda data: self.can_match(data, dtype_str, bounds, pins)
        raise NotImplementedError(
            f"{type(self).__name__} must override prepare_test (preferred) "
            "or can_match"
        )

    def can_match(
        self,
        data: Dict[str, Any],
        dtype_str: str,
        bounds,  # (lo, hi) from expr.bounds_for_column; None = unbounded
        pins: Optional[set],  # from expr.pinned_values; None = not pinned
    ) -> bool:
        """False only when NO row of the file can satisfy the predicate."""
        return self.prepare_test(dtype_str, bounds, pins)(data)


@dataclass(frozen=True)
class MinMaxSketch(SketchSpec):
    kind = "MinMax"

    def build(self, col: Column) -> Dict[str, Any]:
        if is_string(col.dtype_str):
            vals = _string_values(col)
            if not len(vals):
                return {"min": None, "max": None}
            return {
                "min": _json_value(min(vals), col.dtype_str),
                "max": _json_value(max(vals), col.dtype_str),
            }
        if not len(col.data):
            return {"min": None, "max": None}
        return {
            "min": _json_value(col.data.min(), col.dtype_str),
            "max": _json_value(col.data.max(), col.dtype_str),
        }

    def prepare_test(self, dtype_str, bounds, pins):
        pin_vals = (
            [_lit_comparable(v, dtype_str) for v in pins]
            if pins is not None
            else None
        )
        lo = hi = None
        if bounds is not None:
            b_lo, b_hi = bounds
            lo = _lit_comparable(b_lo, dtype_str) if b_lo is not None else None
            hi = _lit_comparable(b_hi, dtype_str) if b_hi is not None else None

        def test(data) -> bool:
            lo_f, hi_f = data.get("min"), data.get("max")
            if lo_f is None or hi_f is None:
                return False  # empty file: nothing can match
            if pin_vals is not None and all(
                v < lo_f or v > hi_f for v in pin_vals
            ):
                return False
            if lo is not None and lo > hi_f:
                return False
            if hi is not None and hi < lo_f:
                return False
            return True

        return test


@dataclass(frozen=True)
class ValueListSketch(SketchSpec):
    max_size: int = 1024

    kind = "ValueList"

    def to_json_dict(self) -> Dict[str, Any]:
        return {**super().to_json_dict(), "maxSize": self.max_size}

    def build(self, col: Column) -> Dict[str, Any]:
        if is_string(col.dtype_str):
            uniq = np.unique(_string_values(col))
        else:
            uniq = np.unique(col.data)
        if len(uniq) > self.max_size:
            return {"values": None}  # too wide: sketch abstains
        return {"values": [_json_value(v, col.dtype_str) for v in uniq]}

    def prepare_test(self, dtype_str, bounds, pins):
        pin_vals = (
            {_lit_comparable(v, dtype_str) for v in pins}
            if pins is not None
            else None
        )
        lo = hi = None
        if bounds is not None:
            b_lo, b_hi = bounds
            lo = _lit_comparable(b_lo, dtype_str) if b_lo is not None else None
            hi = _lit_comparable(b_hi, dtype_str) if b_hi is not None else None

        def test(data) -> bool:
            values = data.get("values")
            if values is None:
                return True  # abstained at build time
            if not values:
                return False  # empty file: nothing can match
            if pin_vals is not None and pin_vals.isdisjoint(values):
                return False
            if lo is not None and all(v < lo for v in values):
                return False
            if hi is not None and all(v > hi for v in values):
                return False
            return True

        return test


@dataclass(frozen=True)
class BloomFilterSketch(SketchSpec):
    fpp: float = 0.01
    expected_items: int = 100_000

    kind = "BloomFilter"

    def to_json_dict(self) -> Dict[str, Any]:
        return {
            **super().to_json_dict(),
            "fpp": self.fpp,
            "expectedItems": self.expected_items,
        }

    def _sizes(self) -> tuple:
        n = max(self.expected_items, 1)
        m = int(np.ceil(-n * np.log(self.fpp) / (_LN2**2)))
        m = max(((m + 63) // 64) * 64, 64)  # word-align
        k = max(int(round((m / n) * _LN2)), 1)
        return m, k

    def build(self, col: Column) -> Dict[str, Any]:
        m, k = self._sizes()
        reprs = key_repr(col)
        bits = np.zeros(m, dtype=bool)
        if len(reprs):
            pos = _bloom_positions(reprs, m, k)
            bits[np.unique(pos)] = True
        packed = np.packbits(bits)
        return {
            "numBits": m,
            "numHashes": k,
            "bits": base64.b64encode(packed.tobytes()).decode("ascii"),
        }

    def prepare_test(self, dtype_str, bounds, pins):
        if pins is None:
            return lambda data: True  # bloom answers equality only
        # pin hashing is file-invariant; positions depend on the stored
        # (numBits, numHashes), identical across a sketch's files — cache
        # per distinct geometry so a 64-file prune hashes the pins once
        reprs = np.array(
            [scalar_key_repr(v, dtype_str) for v in pins], dtype=np.int64
        )
        pos_by_geom: Dict[tuple, np.ndarray] = {}

        def test(data) -> bool:
            m, k = int(data["numBits"]), int(data["numHashes"])
            pos = pos_by_geom.get((m, k))
            if pos is None:
                pos = _bloom_positions(reprs, m, k)  # (n_pins, k)
                pos_by_geom[(m, k)] = pos
            packed = np.frombuffer(base64.b64decode(data["bits"]), dtype=np.uint8)
            # packbits is MSB-first: global bit p = byte p>>3, bit 7-(p&7)
            hit_bits = (packed[pos >> 3] >> (7 - (pos & 7))) & 1
            # might contain v ⇔ all k bits set for some pin v
            return bool(hit_bits.all(axis=1).any())

        return test


_SKETCH_KINDS = {
    "MinMax": lambda d: MinMaxSketch(d["column"]),
    "ValueList": lambda d: ValueListSketch(d["column"], int(d.get("maxSize", 1024))),
    "BloomFilter": lambda d: BloomFilterSketch(
        d["column"], float(d.get("fpp", 0.01)), int(d.get("expectedItems", 100_000))
    ),
}


def sketch_from_json_dict(d: Dict[str, Any]) -> SketchSpec:
    try:
        return _SKETCH_KINDS[d["kind"]](d)
    except KeyError:
        raise HyperspaceException(f"Unknown sketch kind: {d.get('kind')!r}.")


# --- sketch-table persistence ----------------------------------------------
SKETCH_FILE_NAME = "sketches.json"


def sketch_key(spec_dict: Dict[str, Any]) -> str:
    """Stable per-sketch key inside the per-file table."""
    import json

    return json.dumps(spec_dict, sort_keys=True)


_sketch_table_cache: Dict[str, tuple] = {}


def load_sketch_table(content_files: List[str]) -> Optional[Dict[str, Dict]]:
    """The {file: {sketch key: data}} table from an index's content file
    list, or None if no sketch file is present. Parsed tables are cached
    per path, validated by (mtime, size) — sketch files live in immutable
    ``v__=k`` version dirs (a refresh writes a NEW dir, hence a new cache
    key), so hits are the common case and every query stops paying the
    JSON parse.

    CONTRACT: the returned object is the SHARED cached instance — treat it
    as frozen. Callers must never mutate the table or its nested dicts
    (incremental refresh copies entry references into a fresh dict and
    serializes; it does not modify them); an in-place edit would corrupt
    every later query's pruning in this process."""
    import json
    from pathlib import Path

    for f in content_files:
        if f.endswith(SKETCH_FILE_NAME):
            p = Path(f)
            # a listed-but-unreadable sketch file raises (like read_text
            # always did): the query rule catches and skips pruning, while
            # refresh fails loudly instead of silently dropping unchanged
            # files' sketches from the next version
            st = p.stat()
            stamp = (st.st_mtime_ns, st.st_size)
            hit = _sketch_table_cache.get(f)
            if hit is not None and hit[0] == stamp:
                return hit[1]
            table = json.loads(p.read_text(encoding="utf-8"))["files"]
            if len(_sketch_table_cache) >= 32:
                _sketch_table_cache.pop(next(iter(_sketch_table_cache)))
            _sketch_table_cache[f] = (stamp, table)
            return table
    return None
