"""Delta residency: the host-side encode and bind helpers of the hybrid
scan's device path between refreshes.

Counterpart of ``hyperspace_tpu.exec.delta``. The
appended side of a Hybrid Scan is small by construction (the rewrite caps
it at the appended-bytes ratio) yet the host union decodes it on every
query. Delta residency keeps it on the device beside the resident base
(``exec/hbm_cache.py:DeltaRegion``) so one K1h launch counts both:

* **numeric encode** rides the one narrowing contract
  (``ops/kernels.py:narrow_arrays_to_i32``, ``ops/floatbits.py``), which
  is value-independent, so a delta column encodes exactly as its base
  column does and one narrowed literal compares right over both;
* **string encode** maps the appended dictionary codes onto the base
  table's global vocab. Values the base never saw (out of vocabulary)
  get codes ``len(base_vocab) + i`` into a host-side sorted side table:
  no base row carries such a code, so equality against an OOV literal is
  exact on both sides. OOV codes do not keep the order of the base
  codes, so a range comparison over a column that has OOV values
  declines the device path (``prepare_hybrid_predicate``);
* **predicate prepare** is ``prepare_resident_predicate``'s bind, f64
  expand and int32 narrow with the OOV-aware binder, giving one bound
  expression for base and delta.

``resolve_hybrid_residency`` is the one eligibility procedure of the fused
path, on one device and on a mesh (``exec/mesh_cache.py``'s delta
regions). Nothing here touches the device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np

from ..config import ResidencyConf
from ..plan.expr import _SWAP, And, Cmp, Col, Expr, In, Lit, Not, Or, _string_cmp_codes
from ..storage.columnar import Column, is_string
from ..telemetry.metrics import metrics


def encode_delta_string(
    col: Column, base_vocab: np.ndarray
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """(int32 codes, sorted OOV side table) of a delta string column
    re-encoded against the base table's global vocab. In-vocab values get
    their base code, out-of-vocab values ``len(base_vocab) + i`` into the
    side table; NULL (-1) survives. None when the column is not a
    dictionary string column."""
    if not is_string(col.dtype_str) or col.vocab is None:
        return None
    vocab = col.vocab
    n_base = len(base_vocab)
    if len(vocab) == 0:
        return np.full(len(col.data), -1, dtype=np.int32), np.empty(0, dtype=object)
    if n_base:
        pos = np.searchsorted(base_vocab, vocab)
        posc = np.clip(pos, 0, n_base - 1)
        found = (pos < n_base) & (base_vocab[posc] == vocab)
    else:
        posc = np.zeros(len(vocab), dtype=np.int64)
        found = np.zeros(len(vocab), dtype=bool)
    oov = np.array(sorted(vocab[~found]), dtype=object)
    mapping = np.where(found, posc, 0).astype(np.int64)
    if oov.size:
        mapping = np.where(found, mapping, n_base + np.searchsorted(oov, vocab))
    valid = col.data >= 0
    out = np.full(len(col.data), -1, dtype=np.int32)
    out[valid] = mapping[col.data[valid]].astype(np.int32)
    return out, oov


def encode_delta_numeric(col: Column, base_enc: str):
    """The delta numeric column under its base column's contract:
    ``(flat, enc)`` for int/float32, ``((hi, lo), "f64")`` for float64, or
    None when the values cannot ride it (range overflow, NaN, dtype
    drift: the column is refused and the hybrid path routes host)."""
    from ..ops.kernels import narrow_arrays_to_i32

    if base_enc == "f64":
        from .hbm_cache import _encode_f64

        e = _encode_f64(col.data)
        return (e, "f64") if e is not None else None
    narrowed = narrow_arrays_to_i32({"c": col.data})
    if narrowed is None:
        return None
    enc = "float32" if col.data.dtype == np.float32 else "int"
    if enc != base_enc:
        return None
    return narrowed["c"], enc


def encode_delta_columns(host_batch, base_columns: Dict[str, object], with_zones: bool = False):
    """Encode every base-covered column of the decoded appended batch
    under its base column's contract. Returns ``(flats, encs, oov,
    planes, zones)``: per column the flat int32 array (an ``(hi, lo)``
    pair for f64), ``(dtype_str, enc)``, the string side table, the int32
    plane count, and (``with_zones``) per-block zone vectors. A column
    whose appended values cannot ride the base encoding is skipped."""
    from .hbm_cache import _block_zones

    flats: Dict[str, object] = {}
    encs: Dict[str, Tuple[str, str]] = {}
    oov: Dict[str, np.ndarray] = {}
    zones: Dict[str, Tuple[str, np.ndarray, np.ndarray]] = {}
    planes = 0
    for name, base_rc in base_columns.items():
        col = host_batch.columns.get(name)
        if col is None:
            continue
        if base_rc.enc == "string":
            e = encode_delta_string(col, base_rc.vocab)
            if e is None:
                continue
            flats[name], oov[name] = e
            encs[name] = (col.dtype_str, "string")
            planes += 1
        elif base_rc.enc == "f64":
            e = encode_delta_numeric(col, "f64")
            if e is None:
                continue
            hi, lo = e[0]
            flats[name] = (hi, lo)
            encs[name] = (col.dtype_str, "f64")
            if with_zones:
                ordered = (hi.astype(np.int64) << 32) | (
                    np.bitwise_xor(lo.view(np.uint32), np.uint32(0x80000000)).astype(np.int64)
                )
                zones[name] = ("f64ord", *_block_zones(ordered))
            planes += 2
        else:
            e = encode_delta_numeric(col, base_rc.enc)
            if e is None:
                continue
            flat, enc = e
            flats[name] = flat
            encs[name] = (col.dtype_str, enc)
            if with_zones and enc == "int":
                zones[name] = ("value", *_block_zones(flat))
            planes += 1
    return flats, encs, oov, planes, zones


def blocks_to_runs(cand: np.ndarray, block_rows: int, n_rows: int):
    """Candidate block indices merged into contiguous ``[lo, hi)`` row runs
    clipped to ``n_rows`` (pad-only tail blocks drop out)."""
    runs: list = []
    for b in cand:
        lo = int(b) * block_rows
        hi = min((int(b) + 1) * block_rows, n_rows)
        if lo >= hi:
            continue
        if runs and runs[-1][1] == lo:
            runs[-1][1] = hi
        else:
            runs.append([lo, hi])
    return runs


def _bind_oov_string_literals(
    expr: Expr, base_columns: Dict[str, object], oov: Dict[str, np.ndarray]
) -> Optional[Expr]:
    """``bind_string_literals``' twin for the hybrid path: literals bind
    against the base vocab and the OOV side table (codes ``V + i``). A
    range comparison over a column with OOV values returns None (the
    caller routes host). NULL (code -1) never passes, as in the standard
    binder."""

    def is_str_col(e: Expr) -> bool:
        return (isinstance(e, Col) and e.name in base_columns
                and getattr(base_columns[e.name], "enc", None) == "string")

    def has_oov(name: str) -> bool:
        ext = oov.get(name)
        return ext is not None and len(ext) > 0

    def code_of(name: str, value) -> Optional[int]:
        vocab = base_columns[name].vocab
        v = value.encode() if isinstance(value, str) else bytes(value)
        if len(vocab):
            pos = int(np.searchsorted(vocab, v))
            if pos < len(vocab) and vocab[pos] == v:
                return pos
        ext = oov.get(name)
        if ext is not None and len(ext):
            p = int(np.searchsorted(ext, v))
            if p < len(ext) and ext[p] == v:
                return len(vocab) + p
        return None

    def never(c: Col) -> Expr:
        return Cmp("lt", c, Lit(-1))  # codes are >= -1: always False

    def walk(e: Expr) -> Optional[Expr]:
        if isinstance(e, (And, Or)):
            left, right = walk(e.left), walk(e.right)
            if left is None or right is None:
                return None
            return And(left, right) if isinstance(e, And) else Or(left, right)
        if isinstance(e, Not):
            child = walk(e.child)
            return Not(child) if child is not None else None
        if isinstance(e, Cmp):
            left, right, op = e.left, e.right, e.op
            if isinstance(left, Lit) and isinstance(right, Col):
                left, right, op = right, left, _SWAP[op]
            if is_str_col(left) and isinstance(right, Lit):
                name = left.name
                if op in ("eq", "ne"):
                    code = code_of(name, right.value)
                    if code is None:
                        # on neither side: eq never matches, ne any non-NULL
                        return never(left) if op == "eq" else Cmp("ge", left, Lit(0))
                    return And(Cmp(op, left, Lit(code)), Cmp("ge", left, Lit(0)))
                if has_oov(name):
                    return None  # a range over OOV codes: their order is broken
                cop, bound, always = _string_cmp_codes(op, base_columns[name].vocab, right.value)
                if always is False:
                    return never(left)
                if always is True:
                    return Cmp("ge", left, Lit(0))
                return And(Cmp(cop, left, Lit(bound)), Cmp("ge", left, Lit(0)))
            if is_str_col(left) or is_str_col(right):
                # col-col string compares need one shared code space
                return None
            return e
        if isinstance(e, In) and is_str_col(e.child):
            out: Optional[Expr] = None
            for v in e.values:
                code = code_of(e.child.name, v)
                if code is None:
                    continue
                term = Cmp("eq", e.child, Lit(code))
                out = term if out is None else Or(out, term)
            if out is None:
                return never(e.child)
            return And(out, Cmp("ge", e.child, Lit(0)))
        return e

    return walk(expr)


def prepare_hybrid_predicate(
    base_columns: Dict[str, object], oov: Dict[str, np.ndarray], predicate: Expr
):
    """(narrowed expr, names) for the fused base + delta launch, or None
    when the predicate cannot ride the shared encodings. Without OOV
    values in the string columns it reads, this is
    ``prepare_resident_predicate``; otherwise the OOV-aware binder runs."""
    from ..ops import kernels as K
    from .hbm_cache import prepare_resident_predicate

    names = tuple(sorted(predicate.columns()))
    if any(n not in base_columns for n in names):
        metrics.incr("hbm.delta.declined.columns")
        return None
    hot = [n for n in names if getattr(base_columns[n], "enc", None) == "string"
           and oov.get(n) is not None and len(oov[n]) > 0]
    if not hot:
        return prepare_resident_predicate(base_columns, predicate)
    bound = _bind_oov_string_literals(predicate, base_columns, oov)
    if bound is None:
        metrics.incr("hbm.delta.oov_shape_declined")
        return None
    f64_cols = {n for n in names if base_columns[n].enc == "f64"}
    if f64_cols:
        from ..ops.floatbits import expand_f64_predicate

        bound = expand_f64_predicate(bound, f64_cols)
        if bound is None:
            metrics.incr("hbm.delta.declined.f64_shape")
            return None
    f32 = {n: "float32" for n in names if base_columns[n].enc == "float32"}
    narrowed = K.narrow_expr_to_i32(bound, f32 or None)
    if narrowed is None:
        metrics.incr("hbm.delta.declined.narrow")
        return None
    return narrowed, tuple(sorted(narrowed.columns()))


@dataclass
class HybridResidency:
    """Outcome of the fused-hybrid eligibility resolution."""

    status: str  # "ok" | "no_table" | "no_delta" | "gated" | "ineligible"
    files: Optional[list] = None  # pruned base files (from "no_table" on)
    table: object = None  # resident base (from "no_delta" on)
    delta: object = None  # delta region ("gated" / "ok")
    host_predicate: object = None  # the base's exact host-leg predicate ("ok")


def resolve_hybrid_residency(
    info, predicate: Expr, device=None, conf: ResidencyConf = ResidencyConf(), mesh=None,
) -> HybridResidency:
    """Whether a hybrid union can take the fused base + delta path on
    ``device``, or on ``mesh`` through the mesh cache: residency mode and
    an empty cache first (before any pruning), predicate-column coverage,
    base-file pruning, the table and delta lookups, the delta-aware zone
    gate (single device only: the mesh's resident path has no gate, its
    fallback ships every row), and the exact host predicate (the lineage
    NOT IN re-applied for deletes)."""
    from pathlib import Path

    from .. import constants as C
    from ..plan.expr import col, is_in
    from .hbm_cache import hbm_cache
    from .mesh_cache import mesh_cache
    from .scan import prune_index_files

    cache = hbm_cache if mesh is None else mesh_cache
    if conf.mode == "off" or cache.empty():
        return HybridResidency("ineligible")
    entry = info.entry
    pred_cols = sorted(predicate.columns())
    if any(c not in set(info.user_cols) for c in pred_cols):
        return HybridResidency("ineligible")
    files = prune_index_files(
        [Path(p) for p in entry.content.files()],
        predicate,
        entry.indexed_columns,
        entry.schema,
        entry.num_buckets,
    )
    if not files:
        return HybridResidency("ineligible")
    if mesh is None:
        table = hbm_cache.resident_for(files, pred_cols, device, conf)
    else:
        table = mesh_cache.resident_for(files, pred_cols, mesh, conf)
    if table is None:
        return HybridResidency("no_table", files)
    if table.tier != "resident":
        # K1h reads raw base planes: a compressed or streaming base declines
        # (and no delta is scheduled: it could never register)
        metrics.incr(f"{cache._metric_prefix}.delta.declined.tier")
        return HybridResidency("ineligible", files)
    delta = cache.delta_for(table, info.appended, pred_cols, info.deleted_ids, conf)
    if delta is None:
        return HybridResidency("no_delta", files, table)
    if mesh is None:
        frac = hybrid_zone_block_fraction(table, delta, predicate)
        if frac is not None and conf.max_block_frac < 1.0 and frac >= conf.max_block_frac:
            return HybridResidency("gated", files, table, delta)
    host_predicate = predicate
    if info.deleted_ids:
        host_predicate = predicate & Not(is_in(col(C.DATA_FILE_NAME_ID), list(info.deleted_ids)))
    return HybridResidency("ok", files, table, delta, host_predicate)


def hybrid_zone_block_fraction(table, delta, predicate) -> Optional[float]:
    """Upper bound on the fraction of base + delta blocks the predicate
    can match: a side with no zone information counts as all candidates;
    None when neither side has zones."""
    from .hbm_cache import BLOCK_ROWS, zone_block_fraction

    fb = zone_block_fraction(table, predicate)
    fd = zone_block_fraction(delta, predicate)
    if fb is None and fd is None:
        return None
    nb = -(-table.n_rows // BLOCK_ROWS)
    nd = -(-delta.n_rows // BLOCK_ROWS)
    fb = 1.0 if fb is None else fb
    fd = 1.0 if fd is None else fd
    return (fb * nb + fd * nd) / max(nb + nd, 1)
