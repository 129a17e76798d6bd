"""The in-memory columnar substrate: host batches that feed the device.

A copy of ``hyperspace_tpu.storage.columnar`` whose ``device_arrays``
returns torch tensors:

* every column is a dense numpy array with a fixed-width dtype, so a batch
  moves to the device as one copy per column;
* strings are **order-preserving dictionary encoded** — codes are the rank
  of the value in the sorted per-batch vocabulary, so comparisons and sorts
  on codes agree with lexicographic string order *within a batch*;
* cross-batch string equality (joins) re-encodes through a shared
  vocabulary on the host — see ``unify_dictionaries``.

A "schema" is an ordered ``{name: dtype_str}`` mapping using the dtype
names below (the same strings stored in IndexLogEntry.schema).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from ..exceptions import HyperspaceException

# ---------------------------------------------------------------------------
# dtype registry
# ---------------------------------------------------------------------------
_NUMERIC_DTYPES: Dict[str, np.dtype] = {
    "bool": np.dtype(np.bool_),
    "int8": np.dtype(np.int8),
    "int16": np.dtype(np.int16),
    "int32": np.dtype(np.int32),
    "int64": np.dtype(np.int64),
    "uint8": np.dtype(np.uint8),
    "uint16": np.dtype(np.uint16),
    "uint32": np.dtype(np.uint32),
    "uint64": np.dtype(np.uint64),
    "float32": np.dtype(np.float32),
    "float64": np.dtype(np.float64),
    # Dates are stored as int32 days-since-epoch (arrow date32 semantics).
    "date32": np.dtype(np.int32),
}
STRING = "string"
CODE_DTYPE = np.dtype(np.int32)  # dictionary codes


def numpy_dtype(dtype_str: str) -> np.dtype:
    if dtype_str == STRING:
        return CODE_DTYPE
    try:
        return _NUMERIC_DTYPES[dtype_str]
    except KeyError:
        raise HyperspaceException(f"Unsupported dtype: {dtype_str}")


def is_string(dtype_str: str) -> bool:
    return dtype_str == STRING


def dtype_str_of(np_dtype: np.dtype) -> str:
    if np_dtype.kind in ("U", "S", "O"):
        return STRING
    for name, dt in _NUMERIC_DTYPES.items():
        if name != "date32" and dt == np_dtype:
            return name
    raise HyperspaceException(f"Unsupported numpy dtype: {np_dtype}")


# ---------------------------------------------------------------------------
# Column
# ---------------------------------------------------------------------------
class Column:
    """One column: a dense numpy ``data`` array plus, for strings, the
    order-preserving dictionary ``vocab`` (numpy array of bytes objects).

    For string columns ``data`` holds int32 codes; code ``-1`` is reserved
    for values absent from the vocab (appears only transiently during
    re-encoding)."""

    __slots__ = ("dtype_str", "data", "vocab")

    def __init__(self, dtype_str: str, data: np.ndarray, vocab: Optional[np.ndarray] = None):
        self.dtype_str = dtype_str
        self.data = data
        self.vocab = vocab
        if is_string(dtype_str):
            if vocab is None:
                raise HyperspaceException("String column requires a vocab.")
            if data.dtype != CODE_DTYPE:
                raise HyperspaceException("String column codes must be int32.")
        else:
            expected = numpy_dtype(dtype_str)
            if data.dtype != expected:
                raise HyperspaceException(
                    f"Column dtype mismatch: declared {dtype_str}, got {data.dtype}."
                )

    def __len__(self) -> int:
        return len(self.data)

    @staticmethod
    def from_values(values: np.ndarray | Sequence, dtype_str: Optional[str] = None) -> "Column":
        """Build a column from raw values; strings are dictionary-encoded
        with a sorted (order-preserving) vocab."""
        arr = np.asarray(values)
        if dtype_str is None:
            dtype_str = dtype_str_of(arr.dtype)
        if is_string(dtype_str):
            as_bytes = np.array(
                [v.encode() if isinstance(v, str) else bytes(v) for v in arr],
                dtype=object,
            )
            vocab, codes = np.unique(as_bytes, return_inverse=True)
            return Column(STRING, codes.astype(CODE_DTYPE), vocab)
        return Column(dtype_str, arr.astype(numpy_dtype(dtype_str), copy=False))

    @staticmethod
    def from_optional_values(values: Sequence) -> "Column":
        """Build a string column where ``None`` values become NULL (code -1),
        preserving the NULL vs empty-string distinction through indexing."""
        as_bytes = np.array(
            [
                None
                if v is None
                else (v.encode() if isinstance(v, str) else bytes(v))
                for v in values
            ],
            dtype=object,
        )
        valid = np.array([v is not None for v in as_bytes], dtype=bool)
        vocab, inv = np.unique(as_bytes[valid], return_inverse=True)
        codes = np.full(len(as_bytes), -1, dtype=CODE_DTYPE)
        codes[valid] = inv.astype(CODE_DTYPE)
        return Column(STRING, codes, vocab)

    def to_values(self) -> np.ndarray:
        """Materialize back to user values (decoding dictionaries). NULL
        string codes (-1) come back as None."""
        if is_string(self.dtype_str):
            out = np.empty(len(self.data), dtype=object)
            valid = self.data >= 0
            out[valid] = self.vocab[self.data[valid]]
            out[~valid] = None
            return np.array(
                [
                    v.decode("utf-8", "surrogateescape")
                    if isinstance(v, bytes)
                    else v
                    for v in out
                ],
                dtype=object,
            )
        return self.data

    def take(self, indices: np.ndarray) -> "Column":
        return Column(self.dtype_str, self.data[indices], self.vocab)

    def min_max(self) -> Optional[Tuple[float, float]]:
        """(min, max) for footer pruning; None for empty or string columns
        (string min/max over codes is batch-local and not comparable across
        files, so it is not persisted)."""
        if len(self.data) == 0 or is_string(self.dtype_str):
            return None
        return (self.data.min().item(), self.data.max().item())

    def reencode(self, new_vocab: np.ndarray) -> "Column":
        """Map this string column's codes onto ``new_vocab`` (sorted).
        Values missing from new_vocab get code -1."""
        if not is_string(self.dtype_str):
            raise HyperspaceException("reencode only applies to string columns.")
        if len(new_vocab) == 0:
            return Column(
                STRING, np.full(len(self.data), -1, dtype=CODE_DTYPE), new_vocab
            )
        pos = np.searchsorted(new_vocab, self.vocab)
        pos_clipped = np.clip(pos, 0, len(new_vocab) - 1)
        ok = (pos < len(new_vocab)) & (new_vocab[pos_clipped] == self.vocab)
        mapping = np.where(ok, pos_clipped, -1).astype(CODE_DTYPE)
        valid = self.data >= 0
        new_codes = np.full(len(self.data), -1, dtype=CODE_DTYPE)
        new_codes[valid] = mapping[self.data[valid]]
        return Column(STRING, new_codes, new_vocab)


def unify_dictionaries(columns: Sequence[Column]) -> List[Column]:
    """Re-encode string columns onto one shared sorted vocab so codes are
    comparable across batches (the host-side step before a cross-index
    string join; SURVEY.md §7 hard-parts list)."""
    vocabs = [c.vocab for c in columns if c.vocab is not None and len(c.vocab)]
    if not vocabs:
        return list(columns)
    merged = np.unique(np.concatenate(vocabs))
    return [c.reencode(merged) for c in columns]


# ---------------------------------------------------------------------------
# ColumnarBatch
# ---------------------------------------------------------------------------
class ColumnarBatch:
    """An ordered set of equal-length named columns."""

    def __init__(self, columns: Dict[str, Column]):
        lengths = {len(c) for c in columns.values()}
        if len(lengths) > 1:
            raise HyperspaceException(f"Ragged columns: lengths {lengths}.")
        self.columns: Dict[str, Column] = dict(columns)

    # -- construction --------------------------------------------------------
    @staticmethod
    def from_pydict(data: Dict[str, Sequence], schema: Optional[Dict[str, str]] = None) -> "ColumnarBatch":
        cols = {}
        for name, values in data.items():
            dt = schema.get(name) if schema else None
            cols[name] = Column.from_values(values, dt)
        return ColumnarBatch(cols)

    @staticmethod
    def empty(schema: Dict[str, str]) -> "ColumnarBatch":
        """A 0-row batch with the given schema (string columns get an empty
        vocab)."""
        import numpy as _np

        return ColumnarBatch(
            {
                name: Column(
                    dt,
                    _np.empty(0, dtype=numpy_dtype(dt)),
                    _np.array([], dtype=object) if is_string(dt) else None,
                )
                for name, dt in schema.items()
            }
        )

    @staticmethod
    def from_arrow(table) -> "ColumnarBatch":
        """Ingest a pyarrow Table (the parquet read path)."""
        import pyarrow as pa

        cols: Dict[str, Column] = {}
        for name in table.column_names:
            arr = table.column(name).combine_chunks()
            t = arr.type
            if (
                pa.types.is_string(t)
                or pa.types.is_large_string(t)
                or pa.types.is_binary(t)
                or pa.types.is_dictionary(t)
            ):
                cols[name] = Column.from_optional_values(arr.to_pylist())
            elif pa.types.is_date32(t):
                np_arr = arr.to_numpy(zero_copy_only=False).astype("datetime64[D]").astype(np.int32)
                cols[name] = Column("date32", np_arr)
            elif pa.types.is_decimal(t):
                np_arr = np.array([float(v) for v in arr.to_pylist()], dtype=np.float64)
                cols[name] = Column("float64", np_arr)
            else:
                if arr.null_count > 0 and (
                    pa.types.is_integer(t) or pa.types.is_boolean(t)
                ):
                    # pyarrow would silently widen to float64 (NaN for null),
                    # rounding keys above 2^53 — refuse rather than corrupt.
                    raise HyperspaceException(
                        f"Column {name!r} has {arr.null_count} null(s) in "
                        f"integer/boolean type {t}; numeric NULLs are not "
                        "supported in indexed data."
                    )
                np_arr = arr.to_numpy(zero_copy_only=False)
                if np_arr.dtype == np.dtype("datetime64[ns]"):
                    np_arr = np_arr.astype("datetime64[D]").astype(np.int32)
                    cols[name] = Column("date32", np_arr)
                else:
                    cols[name] = Column(dtype_str_of(np_arr.dtype), np_arr)
        return ColumnarBatch(cols)

    # -- properties ----------------------------------------------------------
    @property
    def num_rows(self) -> int:
        if not self.columns:
            return 0
        return len(next(iter(self.columns.values())))

    @property
    def column_names(self) -> List[str]:
        return list(self.columns.keys())

    def schema(self) -> Dict[str, str]:
        return {name: c.dtype_str for name, c in self.columns.items()}

    # -- ops ------------------------------------------------------------------
    def select(self, names: Iterable[str]) -> "ColumnarBatch":
        names = list(names)
        missing = [n for n in names if n not in self.columns]
        if missing:
            raise HyperspaceException(f"Unknown columns: {missing}.")
        return ColumnarBatch({n: self.columns[n] for n in names})

    def with_column(self, name: str, column: Column) -> "ColumnarBatch":
        cols = dict(self.columns)
        cols[name] = column
        return ColumnarBatch(cols)

    def take(self, indices: np.ndarray) -> "ColumnarBatch":
        return ColumnarBatch({n: c.take(indices) for n, c in self.columns.items()})

    def to_pydict(self) -> Dict[str, np.ndarray]:
        return {n: c.to_values() for n, c in self.columns.items()}

    def to_pandas(self):
        """Needs ``pandas``, imported only here."""
        import pandas as pd

        return pd.DataFrame({n: c.to_values() for n, c in self.columns.items()})

    @staticmethod
    def concat(batches: Sequence["ColumnarBatch"]) -> "ColumnarBatch":
        """Concatenate batches with identical schemas, unifying string
        dictionaries so codes stay comparable."""
        batches = [b for b in batches if b.num_rows > 0] or list(batches[:1])
        if not batches:
            raise HyperspaceException("concat of zero batches")
        if len(batches) == 1:
            # batches are immutable by convention (every transform builds
            # new ones) — a single-batch concat returns it as-is instead
            # of deep-copying every column (measured 8ms on a 2M-row
            # 2-column join result)
            return batches[0]
        first = batches[0]
        names = first.column_names
        for b in batches[1:]:
            if b.column_names != names or b.schema() != first.schema():
                raise HyperspaceException(
                    f"Schema mismatch in concat: {first.schema()} vs {b.schema()}."
                )
        out: Dict[str, Column] = {}
        for n in names:
            cols = [b.columns[n] for b in batches]
            if is_string(cols[0].dtype_str):
                cols = unify_dictionaries(cols)
                out[n] = Column(
                    STRING,
                    np.concatenate([c.data for c in cols]).astype(CODE_DTYPE),
                    cols[0].vocab,
                )
            else:
                out[n] = Column(cols[0].dtype_str, np.concatenate([c.data for c in cols]))
        return ColumnarBatch(out)

    @staticmethod
    def gather_concat(
        batches: Sequence["ColumnarBatch"], indices: np.ndarray
    ) -> "ColumnarBatch":
        """``concat(batches).take(indices)`` without materializing the
        concatenation: each output row is gathered straight from its source
        batch, so every row moves once. The streaming build gathers a
        staged run's R chunks in merged order this way. The same result as
        concat().take(): string dictionaries unify exactly as concat does."""
        batches = [b for b in batches if b.num_rows > 0] or list(batches[:1])
        if len(batches) == 1:
            return batches[0].take(indices)
        first = batches[0]
        names = first.column_names
        for b in batches[1:]:
            if b.column_names != names or b.schema() != first.schema():
                raise HyperspaceException(
                    f"Schema mismatch in gather_concat: {first.schema()} "
                    f"vs {b.schema()}."
                )
        sizes = np.array([b.num_rows for b in batches])
        ends = np.cumsum(sizes)
        chunk_ix = np.searchsorted(ends, indices, side="right")
        local_ix = indices - (ends - sizes)[chunk_ix]
        masks = [chunk_ix == ci for ci in range(len(batches))]
        out: Dict[str, Column] = {}
        for n in names:
            cols = [b.columns[n] for b in batches]
            vocab = None
            if is_string(cols[0].dtype_str):
                cols = unify_dictionaries(cols)
                vocab = cols[0].vocab
            acc = np.empty(len(indices), dtype=cols[0].data.dtype)
            for c, m in zip(cols, masks):
                acc[m] = c.data[local_ix[m]]
            out[n] = Column(cols[0].dtype_str, acc, vocab)
        return ColumnarBatch(out)

    def device_arrays(self, names: Optional[Iterable[str]] = None, device=None):
        """Copy columns to ``device`` (ops.resolve_device: cuda unless the
        caller names the cpu) as a dict of torch tensors (codes for
        strings).

        float64 columns travel in the order-preserving int64 encoding
        (ops.floatbits), the same transport format ``hyperspace_tpu``
        uses, so device-side hashing and sorting see identical bits.
        Decode results with ``decode_device_array``."""
        import torch

        from ..ops import resolve_device
        from ..ops.floatbits import f64_to_ordered_i64

        dev = resolve_device(device)
        names = list(names) if names is not None else self.column_names
        out = {}
        for n in names:
            col = self.columns[n]
            data = (
                f64_to_ordered_i64(col.data)
                if col.dtype_str == "float64"
                else col.data
            )
            out[n] = torch.from_numpy(
                np.require(data, requirements=["C", "W"])
            ).to(dev)
        return out


def decode_device_array(dtype_str: str, host_array: np.ndarray) -> np.ndarray:
    """Invert the device transport encoding applied by ``device_arrays``."""
    if dtype_str == "float64":
        from ..ops.floatbits import ordered_i64_to_f64

        return ordered_i64_to_f64(host_array)
    return host_array
