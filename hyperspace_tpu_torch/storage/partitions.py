"""Hive-style partitioned source layout: discovery, values, pruning.

Parity: the reference indexes hive-partitioned sources through Spark's
``PartitioningAwareFileIndex`` — partition columns live in directory names
(``.../date=2024-01-01/part-0.parquet``), are appended to the relation's
schema, and missing partition columns are materialized into the index at
build time (CreateActionBase.scala:164-208 "appends missing partition
columns"; basePath inference DefaultFileBasedSource.scala:235-250; the
HybridScanForPartitionedDataTest matrix exercises mutations per partition).

This module owns the layout rules:

* a file's partition segments are the maximal TRAILING run of
  ``name=value`` directory components BELOW the relation's root path
  (Spark's basePath bound: components of the root itself are never
  partitions, so ``read.parquet('/data/run=5')`` with files directly in
  that root has no partition columns, and reading a single partition
  directory of a table does not resurrect its ``date=...`` component);
* values are URL-unquoted (Spark escapes ``/ =`` etc. on write);
  ``__HIVE_DEFAULT_PARTITION__`` is NULL (forces the column to string);
* column dtypes are inferred int64 → float64 → string over ALL files'
  values; a user-declared schema pins dtypes instead (string/int*/float*/
  bool/date32 supported) and is pinned thereafter by the logged schema —
  refresh re-parses under the logged dtype, so a later file ``k=oops``
  under an int64 column fails loudly instead of silently re-typing.

Partition pruning is vectorized: one row per file in a small columnar
batch, one ``eval_mask`` call — not a per-file Python loop.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple
from urllib.parse import unquote

import numpy as np

from ..exceptions import HyperspaceException
from .columnar import Column, ColumnarBatch, numpy_dtype

HIVE_NULL = "__HIVE_DEFAULT_PARTITION__"


@dataclass(frozen=True)
class PartitionSpec:
    """Ordered (name, dtype_str) pairs plus the concrete base directories
    partition components are resolved against."""

    columns: Tuple[Tuple[str, str], ...]
    bases: Tuple[str, ...] = ()

    @property
    def names(self) -> List[str]:
        return [n for n, _ in self.columns]

    def schema(self) -> Dict[str, str]:
        return dict(self.columns)


def _norm(p: str) -> str:
    return os.path.abspath(str(p).replace("\\", "/"))


def _relative_dir_parts(path: str, bases: Sequence[str]) -> Optional[List[str]]:
    """Directory components of ``path`` strictly below the longest
    matching base, excluding the filename. None when no base contains the
    path."""
    parts = _norm(path).split("/")
    best: Optional[List[str]] = None
    for b in bases:
        bparts = _norm(b).split("/")
        if len(bparts) < len(parts) and parts[: len(bparts)] == bparts:
            rel = parts[len(bparts) : -1]
            if best is None or len(rel) < len(best):
                best = rel  # longest base = shortest relative remainder
    return best


def partition_segments(path: str, bases: Sequence[str]) -> List[Tuple[str, str]]:
    """The trailing ``name=value`` directory run containing ``path``'s
    file, bounded below the matching base. Raw (still-quoted) values.
    A path outside every base has no partition segments."""
    parts = _relative_dir_parts(path, bases)
    if parts is None:
        return []
    run: List[Tuple[str, str]] = []
    for seg in reversed(parts):
        eq = seg.find("=")
        if eq <= 0 or eq != seg.rfind("="):
            break
        run.append((seg[:eq], seg[eq + 1 :]))
    return list(reversed(run))


def _raw_value(raw: str) -> Optional[str]:
    v = unquote(raw)
    return None if v == HIVE_NULL else v


def _infer_dtype(raws: Sequence[Optional[str]]) -> str:
    if any(v is None for v in raws):
        return "string"
    try:
        for v in raws:
            int(np.int64(int(v)))  # parses AND fits int64
        return "int64"
    except (ValueError, OverflowError):
        pass
    try:
        for v in raws:
            float(v)
        return "float64"
    except ValueError:
        return "string"


def discover_partition_spec(
    file_paths: Sequence[str],
    bases: Sequence[str],
    declared_schema: Optional[Dict[str, str]] = None,
) -> Optional[PartitionSpec]:
    """Infer the partition spec for a file snapshot. ``bases`` are the
    relation's concrete root directories (post glob expansion) — only
    components below them count. ``declared_schema`` (a user-declared or
    logged relation schema) pins dtypes; without it they are inferred from
    the values. Returns None when no file carries partition segments.

    Every file must agree on the partition column sequence — a source
    where some files are partitioned and some are not (or partition
    depth/names differ) is rejected, as mixed layouts would silently
    produce NULLs (Spark raises on conflicting partition directory
    structures for the same reason)."""
    if not file_paths:
        return None
    per_file = [partition_segments(p, bases) for p in file_paths]
    names = [n for n, _ in per_file[0]]
    if not names and all(not s for s in per_file):
        return None
    for p, segs in zip(file_paths, per_file):
        if [n for n, _ in segs] != names:
            raise HyperspaceException(
                "Conflicting partition directory structures: expected "
                f"columns {names}, but {p} has {[n for n, _ in segs]}."
            )
    cols: List[Tuple[str, str]] = []
    for i, name in enumerate(names):
        if declared_schema is not None and name in declared_schema:
            cols.append((name, declared_schema[name]))
            continue
        raws = [_raw_value(segs[i][1]) for segs in per_file]
        cols.append((name, _infer_dtype(raws)))
    return PartitionSpec(tuple(cols), tuple(_norm(b) for b in bases))


def _cast(name: str, dtype_str: str, raw: Optional[str], path: str) -> Any:
    if raw is None:
        if dtype_str != "string":
            raise HyperspaceException(
                f"NULL partition value for non-string column {name} in {path}."
            )
        return None
    try:
        if dtype_str == "string":
            return raw
        if dtype_str == "bool":
            if raw.lower() in ("true", "1"):
                return True
            if raw.lower() in ("false", "0"):
                return False
        elif dtype_str == "date32":
            # ISO date → days since epoch (arrow date32 semantics)
            return int(
                np.datetime64(raw, "D").astype("datetime64[D]").astype(np.int64)
            )
        elif dtype_str.startswith("int") or dtype_str.startswith("uint"):
            return int(raw)
        elif dtype_str.startswith("float"):
            return float(raw)
        else:
            raise HyperspaceException(
                f"Partition column {name} has unsupported dtype {dtype_str} "
                "(string/int*/uint*/float*/bool/date32 are partitionable)."
            )
    except (ValueError, OverflowError):
        pass
    raise HyperspaceException(
        f"Partition value {raw!r} of column {name} in {path} does not parse "
        f"as the logged dtype {dtype_str}."
    )


def partition_values_for(path: str, spec: PartitionSpec) -> Dict[str, Any]:
    """``{column: typed value}`` for one file, validated against the spec."""
    segs = partition_segments(path, spec.bases)
    by_name = {n: v for n, v in segs}
    if [n for n, _ in segs] != spec.names:
        raise HyperspaceException(
            f"File {path} does not match partition columns {spec.names}."
        )
    return {
        name: _cast(name, dt, _raw_value(by_name[name]), path)
        for name, dt in spec.columns
    }


def _typed_column(dt: str, values: Sequence[Any]) -> Column:
    if dt == "string":
        return Column.from_optional_values(list(values))
    return Column(dt, np.asarray(values, dtype=numpy_dtype(dt)))


def _constant_column(dt: str, value: Any, n_rows: int) -> Column:
    """One repeated value, without a boxed n-element Python list (this runs
    per chunk on the streaming-ingest hot path)."""
    from .columnar import CODE_DTYPE

    if dt == "string":
        if value is None:
            return Column(
                "string",
                np.full(n_rows, -1, dtype=CODE_DTYPE),
                np.array([], dtype=object),
            )
        v = value.encode() if isinstance(value, str) else bytes(value)
        return Column(
            "string",
            np.zeros(n_rows, dtype=CODE_DTYPE),
            np.array([v], dtype=object),
        )
    return Column(dt, np.full(n_rows, value, dtype=numpy_dtype(dt)))


def constant_columns(
    spec: PartitionSpec, values: Dict[str, Any], n_rows: int
) -> Dict[str, Column]:
    """Materialize one file's partition values as constant columns."""
    return {
        name: _constant_column(dt, values[name], n_rows)
        for name, dt in spec.columns
    }


def partition_batch(spec: PartitionSpec, paths: Sequence[str]) -> ColumnarBatch:
    """One row per path holding its partition values — the vectorized input
    to partition pruning."""
    rows = [partition_values_for(p, spec) for p in paths]
    return ColumnarBatch(
        {
            name: _typed_column(dt, [r[name] for r in rows])
            for name, dt in spec.columns
        }
    )


def prune_files(files: Sequence, spec: PartitionSpec, predicate) -> List:
    """Keep only files whose partition values can satisfy ``predicate``
    (conjuncts over partition columns only — the caller splits). One
    vectorized mask over a one-row-per-file batch."""
    from ..plan.expr import eval_mask

    if not files:
        return list(files)
    batch = partition_batch(spec, [f.name for f in files])
    mask = np.asarray(eval_mask(predicate, batch), dtype=bool)
    return [f for f, keep in zip(files, mask) if keep]
