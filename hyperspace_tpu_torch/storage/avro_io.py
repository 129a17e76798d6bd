"""Avro ingest: a self-contained object-container-file (OCF) reader/writer.

A copy of ``hyperspace_tpu.storage.avro_io`` (which implements the OCF
wire format from the Avro 1.11 spec, needing nothing but numpy) with two
additions for data at benchmark scale:

* records of primitives: null, boolean, int, long, float, double, bytes,
  string, plus enum and fixed; nullable fields as ``["null", T]`` unions
  (nulls become NULL strings / NaN floats; nullable ints promote to
  float64); codecs ``null`` and ``deflate``;
* the Avro ``date`` logical type (an int of days) reads as date32 — the
  reference reads the same field as int64;
* files whose fields are all non-null primitives and that hold several
  data blocks decode with numpy, all blocks in lockstep; the writer
  encodes all-numeric batches with numpy. Both give the values the
  per-value codec gives.

Arrays, maps, and nested records are rejected loudly.
"""

from __future__ import annotations

import io
import json
import os
import struct
import zlib
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from ..exceptions import HyperspaceException
from .columnar import Column, ColumnarBatch

MAGIC = b"Obj\x01"


# ---------------------------------------------------------------------------
# primitive binary codecs (Avro spec: zigzag varints, IEEE754 LE floats)
# ---------------------------------------------------------------------------
def _read_long(buf: io.BytesIO) -> int:
    shift = 0
    acc = 0
    while True:
        b = buf.read(1)
        if not b:
            raise HyperspaceException("avro: truncated varint.")
        byte = b[0]
        acc |= (byte & 0x7F) << shift
        if not byte & 0x80:
            break
        shift += 7
    return (acc >> 1) ^ -(acc & 1)  # zigzag decode


def _write_long(out: io.BytesIO, v: int) -> None:
    v = (v << 1) ^ (v >> 63) if v >= 0 else ((-v - 1) << 1 | 1)
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.write(bytes([b | 0x80]))
        else:
            out.write(bytes([b]))
            return


def _read_bytes(buf: io.BytesIO) -> bytes:
    n = _read_long(buf)
    data = buf.read(n)
    if len(data) != n:
        raise HyperspaceException("avro: truncated bytes value.")
    return data


def _write_bytes(out: io.BytesIO, data: bytes) -> None:
    _write_long(out, len(data))
    out.write(data)


# ---------------------------------------------------------------------------
# schema handling
# ---------------------------------------------------------------------------
_PRIMITIVES = {
    "null",
    "boolean",
    "int",
    "long",
    "float",
    "double",
    "bytes",
    "string",
}


def _normalize_field_type(t) -> Tuple[str, Optional[int], dict]:
    """→ (base type name, union index of the null branch or None, full
    type dict for enum/fixed). The null branch is whichever position
    "null" occupies in the union — ["long","null"] is as legal as
    ["null","long"]."""
    null_idx: Optional[int] = None
    if isinstance(t, list):  # union
        branches = [b for b in t if b != "null"]
        if "null" in t:
            null_idx = t.index("null")
        if len(branches) != 1:
            raise HyperspaceException(
                f"avro: only two-branch [null, T] unions are supported, got {t}."
            )
        t = branches[0]
    if isinstance(t, dict):
        kind = t.get("type")
        if kind in ("enum", "fixed") or kind in _PRIMITIVES:
            return kind, null_idx, t
        raise HyperspaceException(
            f"avro: unsupported complex type {kind!r} (flat tabular data only)."
        )
    if t not in _PRIMITIVES:
        raise HyperspaceException(f"avro: unsupported type {t!r}.")
    return t, null_idx, {}


def _decode_value(buf: io.BytesIO, base: str, meta: dict):
    if base == "null":
        return None
    if base == "boolean":
        return buf.read(1)[0] != 0
    if base in ("int", "long"):
        return _read_long(buf)
    if base == "float":
        return struct.unpack("<f", buf.read(4))[0]
    if base == "double":
        return struct.unpack("<d", buf.read(8))[0]
    if base in ("bytes", "string"):
        return _read_bytes(buf)
    if base == "enum":
        return meta["symbols"][_read_long(buf)].encode()
    if base == "fixed":
        return buf.read(int(meta["size"]))
    raise HyperspaceException(f"avro: unsupported type {base!r}.")


_DTYPE_OF = {
    "boolean": "bool",
    "int": "int64",
    "long": "int64",
    "float": "float32",
    "double": "float64",
    "bytes": "string",
    "string": "string",
    "enum": "string",
    "fixed": "string",
    "null": "string",
}


def _is_date(base: str, meta: dict) -> bool:
    """The Avro ``date`` logical type: an int of days since the epoch,
    read as this package's date32."""
    return base == "int" and meta.get("logicalType") == "date"


def _dtype_of(name: str, base: str, null_idx: Optional[int], meta: dict) -> str:
    if null_idx is not None and base == "boolean":
        raise HyperspaceException(
            f"avro: nullable boolean field {name} is not representable."
        )
    if _is_date(base, meta) and null_idx is None:
        return "date32"
    if null_idx is not None and base in ("int", "long"):
        return "float64"
    return _DTYPE_OF[base]


def infer_schema(path: str | Path) -> Dict[str, str]:
    """Column schema from the OCF header alone — no data block is decoded.
    Dtypes follow the same schema-determined rules as ingest (nullable int
    → float64, non-null ``date`` ints → date32)."""
    with open(path, "rb") as f:
        buf = io.BytesIO(f.read(1 << 20))  # header fits well within 1MB
    schema, _codec, _sync = _read_header(buf)
    if schema.get("type") != "record":
        raise HyperspaceException("avro: top-level schema must be a record.")
    out: Dict[str, str] = {}
    for f_ in schema["fields"]:
        base, null_idx, meta = _normalize_field_type(f_["type"])
        out[f_["name"]] = _dtype_of(f_["name"], base, null_idx, meta)
    return out


# ---------------------------------------------------------------------------
# reader
# ---------------------------------------------------------------------------
def _read_header(buf: io.BytesIO) -> Tuple[dict, str, bytes]:
    if buf.read(4) != MAGIC:
        raise HyperspaceException("avro: bad magic (not an OCF file).")
    meta: Dict[str, bytes] = {}
    while True:
        count = _read_long(buf)
        if count == 0:
            break
        if count < 0:  # negative count: block byte size follows (skip it)
            count = -count
            _read_long(buf)
        for _ in range(count):
            key = _read_bytes(buf).decode()
            meta[key] = _read_bytes(buf)
    schema = json.loads(meta["avro.schema"].decode())
    codec = meta.get("avro.codec", b"null").decode()
    sync = buf.read(16)
    return schema, codec, sync


def read_avro(
    paths: Iterable[str | Path], columns: Optional[List[str]] = None
) -> ColumnarBatch:
    """Read OCF files into one ColumnarBatch (column projection applied
    after decode — rows are row-major on the wire, so every field is
    decoded regardless)."""
    paths = [str(p) for p in paths]
    if not paths:
        raise HyperspaceException("read_avro: no paths.")
    batches = [_read_one(p) for p in paths]
    out = ColumnarBatch.concat(batches)
    return out.select(columns) if columns is not None else out


# fixed byte widths of the primitives the vectorized decoder handles
# (0 = zigzag varint)
_VEC_WIDTH = {"int": 0, "long": 0, "float": 4, "double": 8, "boolean": 1}
# below this many data blocks the per-value decoder is the faster one
_VEC_MIN_BLOCKS = 8


def _read_blocks(buf: io.BytesIO, codec: str, sync: bytes) -> List[Tuple[int, bytes]]:
    blocks = []
    while True:
        head = buf.read(1)
        if not head:
            break
        buf.seek(-1, os.SEEK_CUR)
        n_rows = _read_long(buf)
        n_bytes = _read_long(buf)
        block = buf.read(n_bytes)
        if codec == "deflate":
            block = zlib.decompress(block, -15)
        elif codec != "null":
            raise HyperspaceException(f"avro: unsupported codec {codec!r}.")
        if buf.read(16) != sync:
            raise HyperspaceException("avro: sync marker mismatch.")
        blocks.append((n_rows, block))
    return blocks


def _read_one(path: str) -> ColumnarBatch:
    buf = io.BytesIO(Path(path).read_bytes())
    schema, codec, sync = _read_header(buf)
    if schema.get("type") != "record":
        raise HyperspaceException("avro: top-level schema must be a record.")
    fields = [
        (f["name"], *_normalize_field_type(f["type"])) for f in schema["fields"]
    ]
    blocks = _read_blocks(buf, codec, sync)
    vectorizable = all(
        null_idx is None and base in _VEC_WIDTH for _n, base, null_idx, _m in fields
    )
    if vectorizable and len(blocks) >= _VEC_MIN_BLOCKS:
        arrays = _decode_blocks_vectorized(fields, blocks)
        out = {
            name: _to_column_array(name, base, meta, arrays[name])
            for name, base, _null_idx, meta in fields
        }
        return ColumnarBatch(out)
    cols: Dict[str, list] = {name: [] for name, *_ in fields}
    for n_rows, block in blocks:
        bbuf = io.BytesIO(block)
        for _ in range(n_rows):
            for name, base, null_idx, meta in fields:
                if null_idx is not None:
                    if _read_long(bbuf) == null_idx:
                        cols[name].append(None)
                        continue
                cols[name].append(_decode_value(bbuf, base, meta))
    out: Dict[str, Column] = {}
    for name, base, null_idx, meta in fields:
        out[name] = _to_column(name, base, null_idx is not None, cols[name], meta)
    return ColumnarBatch(out)


def _decode_blocks_vectorized(fields, blocks) -> Dict[str, np.ndarray]:
    """Decode non-null primitive records with numpy: blocks holding the
    same row count are walked in lockstep, one cursor per block, so each
    step decodes one field of one row in EVERY block at once. The values
    equal the per-value decoder's (varints are zigzag-decoded exactly;
    floats are reinterpreted from their little-endian bytes)."""
    out_parts: Dict[str, List[Tuple[int, np.ndarray]]] = {n: [] for n, *_ in fields}
    offsets = np.cumsum([0] + [n for n, _ in blocks])
    groups: Dict[int, List[int]] = {}
    for i, (n_rows, _b) in enumerate(blocks):
        if n_rows:
            groups.setdefault(n_rows, []).append(i)
    shifts = (np.arange(10, dtype=np.uint64) * np.uint64(7))
    k10 = np.arange(10)
    for n_rows, idxs in groups.items():
        data = np.frombuffer(
            b"".join(blocks[i][1] for i in idxs) + b"\0" * 16, dtype=np.uint8
        )
        sizes = np.array([len(blocks[i][1]) for i in idxs], dtype=np.int64)
        cur = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
        vals = {
            name: np.empty((len(idxs), n_rows), dtype=_vec_dtype(base))
            for name, base, _ni, _m in fields
        }
        for r in range(n_rows):
            for name, base, _ni, _m in fields:
                w = _VEC_WIDTH[base]
                if w == 0:
                    win = data[cur[:, None] + k10]
                    cont = (win & 0x80) != 0
                    length = np.argmin(cont, axis=1) + 1
                    keep = k10[None, :] < length[:, None]
                    z = (((win & 0x7F).astype(np.uint64) << shifts) * keep).sum(
                        axis=1, dtype=np.uint64
                    )
                    v = (z >> np.uint64(1)).astype(np.int64) ^ -(
                        (z & np.uint64(1)).astype(np.int64)
                    )
                    vals[name][:, r] = v
                    cur += length
                elif base == "boolean":
                    vals[name][:, r] = data[cur] != 0
                    cur += 1
                else:
                    win = np.ascontiguousarray(data[cur[:, None] + np.arange(w)])
                    vals[name][:, r] = win.view("<f4" if w == 4 else "<f8")[:, 0]
                    cur += w
        if not np.array_equal(cur, np.cumsum(sizes)):
            raise HyperspaceException("avro: block size does not match its rows.")
        for name in vals:
            for j, i in enumerate(idxs):
                out_parts[name].append((int(offsets[i]), vals[name][j]))
    arrays = {}
    for name, base, _ni, _m in fields:
        parts = sorted(out_parts[name], key=lambda t: t[0])
        arrays[name] = (
            np.concatenate([p for _o, p in parts])
            if parts
            else np.empty(0, dtype=_vec_dtype(base))
        )
    return arrays


def _vec_dtype(base: str):
    return {
        "int": np.int64,
        "long": np.int64,
        "float": np.float32,
        "double": np.float64,
        "boolean": np.bool_,
    }[base]


def _to_column_array(name: str, base: str, meta: dict, arr: np.ndarray) -> Column:
    """Column of a vectorized-decoded non-null field (dtypes as _to_column)."""
    if _is_date(base, meta):
        return Column("date32", arr.astype(np.int32))
    if base == "float":
        return Column.from_values(arr.astype(np.float64).astype(np.float32))
    return Column.from_values(arr)


def _to_column(
    name: str, base: str, nullable: bool, values: list, meta: Optional[dict] = None
) -> Column:
    """Column dtype is a function of the SCHEMA alone (never of observed
    values): a nullable int/long field is float64 whether or not this
    particular file contains a null — otherwise two files of the same
    schema could disagree and fail to concat."""
    if base in ("string", "bytes", "enum", "fixed", "null"):
        return Column.from_optional_values(values)
    if base == "boolean":
        if nullable:
            raise HyperspaceException(
                f"avro: nullable boolean field {name} is not representable."
            )
        return Column.from_values(np.array(values, dtype=np.bool_))
    if base in ("int", "long"):
        if nullable:  # arrow's pandas-bridge promotion: int + nulls → float
            arr = np.array(
                [np.nan if v is None else float(v) for v in values],
                dtype=np.float64,
            )
            return Column.from_values(arr)
        if _is_date(base, meta or {}):
            return Column("date32", np.array(values, dtype=np.int32))
        return Column.from_values(np.array(values, dtype=np.int64))
    if base in ("float", "double"):
        arr = np.array(
            [np.nan if v is None else v for v in values], dtype=np.float64
        )
        return Column.from_values(
            arr.astype(np.float32) if base == "float" else arr
        )
    raise HyperspaceException(f"avro: unsupported type {base!r}.")


# ---------------------------------------------------------------------------
# writer (tests, data generation and round-trips; null codec)
# ---------------------------------------------------------------------------
_WRITE_TYPES = {
    "int64": "long",
    "int32": "int",
    "int16": "int",
    "int8": "int",
    "float64": "double",
    "float32": "float",
    "bool": "boolean",
    "string": "string",
    "date32": {"type": "int", "logicalType": "date"},
}
# rows per data block of the vectorized writer (all-numeric batches): many
# small blocks let the vectorized reader decode wide lockstep steps
WRITE_BLOCK_ROWS = 512
_ENCODE_CHUNK_ROWS = 1 << 16


def _header(schema: dict, sync: bytes) -> bytes:
    out = io.BytesIO()
    out.write(MAGIC)
    _write_long(out, 2)
    _write_bytes(out, b"avro.schema")
    _write_bytes(out, json.dumps(schema).encode())
    _write_bytes(out, b"avro.codec")
    _write_bytes(out, b"null")
    _write_long(out, 0)
    out.write(sync)
    return out.getvalue()


def _encode_field(col: Column, s: int, e: int) -> Tuple[np.ndarray, np.ndarray]:
    """(bytes matrix, per-row byte count) of one numeric column's rows
    [s, e) in Avro binary encoding."""
    d = col.data[s:e]
    if col.dtype_str == "bool":
        return d.astype(np.uint8)[:, None], np.ones(len(d), dtype=np.int64)
    if col.dtype_str == "float32":
        m = np.ascontiguousarray(d.astype("<f4")).view(np.uint8).reshape(-1, 4)
        return m, np.full(len(d), 4, dtype=np.int64)
    if col.dtype_str == "float64":
        m = np.ascontiguousarray(d.astype("<f8")).view(np.uint8).reshape(-1, 8)
        return m, np.full(len(d), 8, dtype=np.int64)
    v = d.astype(np.int64)
    z = ((v << np.int64(1)) ^ (v >> np.int64(63))).view(np.uint64)
    groups = (z[:, None] >> (np.arange(10, dtype=np.uint64) * np.uint64(7))[None, :])
    length = np.maximum((groups != 0).sum(axis=1), 1).astype(np.int64)
    m = (groups & np.uint64(0x7F)).astype(np.uint8)
    cont = np.arange(10)[None, :] < (length[:, None] - 1)
    m |= cont.astype(np.uint8) << np.uint8(7)
    return m, length


def write_avro(path: str | Path, batch: ColumnarBatch) -> None:
    """Write ``batch`` as one OCF file. All-numeric batches are encoded
    with numpy into blocks of ``WRITE_BLOCK_ROWS`` rows; batches with a
    string column are written row by row into one block."""
    schema = {
        "type": "record",
        "name": "row",
        "fields": [],
    }
    for name, col in batch.columns.items():
        if col.dtype_str not in _WRITE_TYPES:
            raise HyperspaceException(
                f"avro writer: unsupported dtype {col.dtype_str}."
            )
        t = _WRITE_TYPES[col.dtype_str]
        schema["fields"].append(
            {"name": name, "type": ["null", "string"] if t == "string" else t}
        )
    sync = b"hyperspace-sync!"  # any 16 bytes
    parts = [_header(schema, sync)]
    n = batch.num_rows
    if not any(c.dtype_str == "string" for c in batch.columns.values()):
        cols = list(batch.columns.values())
        for cs in range(0, n, _ENCODE_CHUNK_ROWS):
            ce = min(cs + _ENCODE_CHUNK_ROWS, n)
            enc = [_encode_field(c, cs, ce) for c in cols]
            mat = np.concatenate([m for m, _l in enc], axis=1)
            keep = np.concatenate(
                [np.arange(m.shape[1])[None, :] < ln[:, None] for m, ln in enc],
                axis=1,
            )
            payload = mat[keep].tobytes()
            row_end = np.concatenate([[0], np.cumsum(keep.sum(axis=1))])
            for s in range(0, ce - cs, WRITE_BLOCK_ROWS):
                e = min(s + WRITE_BLOCK_ROWS, ce - cs)
                block = payload[int(row_end[s]):int(row_end[e])]
                head = io.BytesIO()
                _write_long(head, e - s)
                _write_long(head, len(block))
                parts += [head.getvalue(), block, sync]
    elif n:
        parts.append(_encode_rows(batch, sync))
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_bytes(b"".join(parts))


def _encode_rows(batch: ColumnarBatch, sync: bytes) -> bytes:
    """One data block holding every row, encoded value by value."""
    writers = []
    for _name, col in batch.columns.items():
        if col.dtype_str == "string":
            vals = col.to_values()

            def w(out, i, vals=vals):
                v = vals[i]
                if v is None:
                    _write_long(out, 0)
                else:
                    _write_long(out, 1)
                    _write_bytes(
                        out, v.encode() if isinstance(v, str) else bytes(v)
                    )

        else:
            t = _WRITE_TYPES[col.dtype_str]
            avro_t = "int" if isinstance(t, dict) else t
            data = col.data

            def w(out, i, data=data, avro_t=avro_t):
                v = data[i]
                if avro_t in ("long", "int"):
                    _write_long(out, int(v))
                elif avro_t == "double":
                    out.write(struct.pack("<d", float(v)))
                elif avro_t == "float":
                    out.write(struct.pack("<f", float(v)))
                else:  # boolean
                    out.write(b"\x01" if v else b"\x00")

        writers.append(w)
    block = io.BytesIO()
    n = batch.num_rows
    for i in range(n):
        for w in writers:
            w(block, i)
    payload = block.getvalue()
    out = io.BytesIO()
    _write_long(out, n)
    _write_long(out, len(payload))
    out.write(payload)
    out.write(sync)
    return out.getvalue()
