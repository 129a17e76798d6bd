"""Avro object container files, written with numpy.

Grown from a frozen copy of the port's writer (``hyperspace_tpu_torch/
storage/avro_io.py:write_avro``, its all-numeric arm: zigzag varints for
long/int/date, little-endian doubles, blocks of 512 rows, null codec),
with text columns encoded the same vectorised way (a varint length, then
the bytes) where the port's writer goes row by row. The sources are part
of the yardstick, so the bytes the index build reads may not move with
the program. Files are written by a few threads; numpy releases the GIL
in the encode.
"""

from __future__ import annotations

import io
import json
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

MAGIC = b"Obj\x01"
SYNC = b"hyperspace-sync!"  # any 16 bytes
WRITE_BLOCK_ROWS = 512
ENCODE_CHUNK_ROWS = 1 << 16
_TYPES = {
    "int64": "long",
    "int32": "int",
    "float64": "double",
    "date32": {"type": "int", "logicalType": "date"},
    "string": "string",
}


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


def _write_bytes(out: io.BytesIO, data: bytes) -> None:
    _write_long(out, len(data))
    out.write(data)


def _header(schema: dict) -> bytes:
    out = io.BytesIO()
    out.write(MAGIC)
    _write_long(out, 2)
    _write_bytes(out, b"avro.schema")
    _write_bytes(out, json.dumps(schema).encode())
    _write_bytes(out, b"avro.codec")
    _write_bytes(out, b"null")
    _write_long(out, 0)
    out.write(SYNC)
    return out.getvalue()


def _varints(v: np.ndarray):
    """(bytes matrix, bytes per row) of zigzag varints of int64 ``v``."""
    z = ((v << np.int64(1)) ^ (v >> np.int64(63))).view(np.uint64)
    groups = z[:, None] >> (np.arange(10, dtype=np.uint64) * np.uint64(7))[None, :]
    length = np.maximum((groups != 0).sum(axis=1), 1).astype(np.int64)
    m = (groups & np.uint64(0x7F)).astype(np.uint8)
    cont = np.arange(10)[None, :] < (length[:, None] - 1)
    m |= cont.astype(np.uint8) << np.uint8(7)
    return m, length


def _encode_field(dtype: str, d: np.ndarray) -> list:
    """One column's rows as (bytes matrix, bytes per row) parts, in the
    order they go on the wire."""
    if dtype == "float64":
        m = np.ascontiguousarray(d.astype("<f8")).view(np.uint8).reshape(-1, 8)
        return [(m, np.full(len(d), 8, dtype=np.int64))]
    if dtype == "string":  # numpy S array: the bytes, NUL-padded to its width
        m = np.ascontiguousarray(d).view(np.uint8).reshape(len(d), -1)
        length = (m != 0).sum(axis=1).astype(np.int64)
        return [_varints(length), (m, length)]
    return [_varints(d.astype(np.int64))]


def write_file(path: Path, table: dict, schema: dict, start: int, end: int) -> int:
    """Rows [start, end) of ``table`` as one file; returns its bytes."""
    fields = [{"name": n, "type": _TYPES[t]} for n, t in schema.items()]
    parts = [_header({"type": "record", "name": "row", "fields": fields})]
    for cs in range(start, end, ENCODE_CHUNK_ROWS):
        ce = min(cs + ENCODE_CHUNK_ROWS, end)
        enc = [part for n, t in schema.items() for part in _encode_field(t, table[n][cs:ce])]
        mat = np.concatenate([m for m, _l in enc], axis=1)
        keep = np.concatenate(
            [np.arange(m.shape[1])[None, :] < ln[:, None] for m, ln in enc], axis=1)
        payload = mat[keep].tobytes()
        row_end = np.concatenate([[0], np.cumsum(keep.sum(axis=1))])
        for s in range(0, ce - cs, WRITE_BLOCK_ROWS):
            e = min(s + WRITE_BLOCK_ROWS, ce - cs)
            head = io.BytesIO()
            _write_long(head, e - s)
            _write_long(head, int(row_end[e] - row_end[s]))
            parts += [head.getvalue(), payload[int(row_end[s]):int(row_end[e])], SYNC]
    data = b"".join(parts)
    path.write_bytes(data)
    return len(data)


def write_dir(root: Path, table: dict, schema: dict, n_files: int, threads: int = 8) -> int:
    """``table`` split evenly into ``n_files`` files ``part-NNN.avro``
    under ``root``; returns the bytes written."""
    root.mkdir(parents=True, exist_ok=True)
    n = len(next(iter(table.values())))
    bounds = np.linspace(0, n, n_files + 1).astype(np.int64)
    with ThreadPoolExecutor(max_workers=threads) as pool:
        sizes = pool.map(
            lambda i: write_file(root / f"part-{i:03d}.avro", table, schema,
                                 int(bounds[i]), int(bounds[i + 1])),
            range(n_files))
        return sum(sizes)
