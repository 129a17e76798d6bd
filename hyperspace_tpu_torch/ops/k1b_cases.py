"""Inputs of K1b and K1hb aimed at their range test.

The kernels judge each warp's chunk of a sub-tile (``max(sub_rows // 8,
128)`` consecutive rows) from every plane's (min, max) over it before they
count a program row by row; a chunk the intervals decide is never
evaluated. One generator serves the card test
(``tests/test_torch_serve.py``), ``chip_smoke.py`` and the CPU parity
tests against the reference's batched programs, so all hold the same
numpy planes and programs:

- ``raw``: three raw planes over 3 blocks whose last 777 rows are pad
  rows (zeros): ``a`` key-sorted with constant runs (a whole 2,048-row run
  of 7, runs of INT32_MIN and INT32_MAX), ``b`` of few values with a
  constant 4,096-row run, ``c`` constant over every 256 rows; literals at
  chunk minima and maxima and one past each, 7, the int32 extremes and
  their neighbours, under every compare, then column compares and
  programs mixing NOT, AND and OR (more than 300 programs: a batch of 300
  rides a device buffer, one of 64 one-compare programs the parameter
  block);
- ``packed``: planes of every width 1-16 bits with ref0 below zero, the
  odd widths sorted (their chunks resolve), the even ones random, real
  rows ending mid-word (pad rows decode to ref0); literals at each frame's
  ends and one past them;
- ``hybrid``: ``raw``'s planes as a 2-block base and a 1-block delta under
  deletions of none, the whole first block (whole chunks), part of every
  chunk, and every base row.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from .kernels import BLOCK_ROWS, OP_AND, OP_CMP_COL, OP_CMP_LIT, OP_NOT, OP_OR

I32_MIN, I32_MAX = -(2**31), 2**31 - 1
N_BLOCKS = 3
PAD_ROWS = 777  # pad rows (zeros raw, ref0 packed) at the end of the planes
CHUNK_ROWS = (512, 256, 128)  # a warp's chunk at sub-tiles of 4096, 2048, <= 1024 rows
DELETIONS = ("none", "whole_block", "part_of_every_chunk", "every_row")
# (sub_rows, stages) forced on each case (None: the plan's own): every
# sub-tile and ring the planes fit (16 packed planes fit no 4096-row ring)
PLANS = {"raw": ((None, None), (4096, 2), (2048, 4), (1024, 3), (512, 2), (128, 2)),
         "packed": ((None, None), (2048, 2), (1024, 4), (512, 3), (256, 2), (128, 2))}


def _lit(col: int, op: int, lit: int) -> List[List[int]]:
    return [[OP_CMP_LIT, col, op, int(lit)]]


def _raw_planes(rng) -> List[np.ndarray]:
    n = N_BLOCKS * BLOCK_ROWS
    real = n - PAD_ROWS
    a = np.sort(rng.integers(-500, 500, real))
    a[:2048] = 7
    a[5000:5100] = I32_MIN
    a[9000:9050] = I32_MAX
    b = rng.integers(-3, 3, real)
    b[4096:8192] = -1
    c = np.repeat(np.arange(-(-real // 256)), 256)[:real] - 40
    out = []
    for v in (a, b, c):
        p = np.zeros(n, dtype=np.int64)
        p[:real] = v
        out.append(p)
    return out


def _edge_literals(plane: np.ndarray) -> List[int]:
    """Chunk minima and maxima at every chunk size and one past each, for a
    sample of chunks, with 7, 0, the extremes and their neighbours."""
    lits = {7, 0, -1, I32_MIN, I32_MAX, I32_MIN + 1, I32_MAX - 1}
    for rows in CHUNK_ROWS:
        ch = plane.reshape(-1, rows)
        for i in (0, 5, len(ch) // 2, len(ch) - 1):
            lo, hi = int(ch[i].min()), int(ch[i].max())
            lits |= {lo, hi, lo - 1, hi + 1}
    return sorted(x for x in lits if I32_MIN <= x <= I32_MAX)


def _raw_programs(planes: List[np.ndarray]) -> List[np.ndarray]:
    progs = [np.array(_lit(col, op, x), np.int32)
             for x in _edge_literals(planes[0])[:24] for op in range(6) for col in (0, 2)]
    progs += [np.array(_lit(1, op, x), np.int32) for x in (-4, -3, -1, 2, 3) for op in range(6)]
    col_cmp = [[[OP_CMP_COL, 0, op, 2]] for op in range(6)]
    col_cmp += [[[OP_CMP_COL, 2, 1, 2]], [[OP_CMP_COL, 0, 0, 0]], [[OP_CMP_COL, 1, 5, 0]]]
    progs += [np.array(p, np.int32) for p in col_cmp]
    progs += [np.array(p, np.int32) for p in (
        _lit(0, 2, I32_MAX) + _lit(1, 5, I32_MIN) + [[OP_AND, 0, 0, 0], [OP_NOT, 0, 0, 0]],
        _lit(0, 5, 0) + _lit(0, 2, 100) + [[OP_AND, 0, 0, 0]] + _lit(1, 1, -1)
        + [[OP_OR, 0, 0, 0]],
        _lit(2, 0, -40) + [[OP_NOT, 0, 0, 0]] + _lit(0, 4, 7) + [[OP_AND, 0, 0, 0]],
        [[OP_CMP_COL, 0, 3, 2]] + _lit(1, 0, -1) + [[OP_OR, 0, 0, 0], [OP_NOT, 0, 0, 0]],
    )]
    return progs


def _packed(rng) -> Dict[str, object]:
    from . import bitpack

    n = N_BLOCKS * BLOCK_ROWS
    real = n - PAD_ROWS
    planes, specs, values, frames = [], [], [], []
    for bits in range(1, 17):
        lo = -int(rng.integers(1, 900))
        v = rng.integers(lo, lo + (1 << bits), real)
        if bits % 2:
            v = np.sort(v)
        spec = bitpack.pack_spec(lo, lo + (1 << bits) - 1, n)
        full = np.full(n, spec.ref0, dtype=np.int64)
        full[:real] = v
        planes.append(bitpack.pack_plain(full, spec))
        specs.append(spec)
        values.append(full)
        frames.append((lo, lo + (1 << bits) - 1))
    progs = []
    for i in range(320):
        c = i % 16
        lo, hi = frames[c]
        x = (lo, hi, lo - 1, hi + 1, (lo + hi) // 2)[i % 5]
        p = _lit(c, i % 6, x)
        if i % 3 == 1:
            d = (c + 5) % 16
            p += _lit(d, (i + 2) % 6, frames[d][0] + 1) + [[OP_OR, 0, 0, 0]]
        if i % 7 == 2:
            p += [[OP_CMP_COL, c, 2, (c + 1) % 16], [OP_AND, 0, 0, 0], [OP_NOT, 0, 0, 0]]
        progs.append(np.array(p, np.int32))
    return {"planes": planes, "specs": specs, "values": values, "progs": progs}


def deletion_rows(name: str, n_base: int) -> np.ndarray:
    """The deleted base rows of ``DELETIONS[name]`` (bool, ``n_base``)."""
    rows = np.zeros(n_base, dtype=bool)
    if name == "whole_block":
        rows[:BLOCK_ROWS] = True
    elif name == "part_of_every_chunk":
        rows[np.arange(n_base) % 128 < 37] = True
    elif name == "every_row":
        rows[:] = True
    return rows


def k1b_range_cases(seed: int = 0) -> Dict[str, Dict[str, object]]:
    """``{"raw": ..., "packed": ..., "hybrid": ...}``: planes (int32 raw
    arrays or packed words), their specs (None: raw), the decoded values
    (int64) and raw ``(n, 4)`` programs over them; ``hybrid`` adds
    ``base``/``delta`` (lists of int32 arrays) and ``n_base``."""
    rng = np.random.default_rng(seed)
    raw = _raw_planes(rng)
    progs = _raw_programs(raw)
    assert len(progs) > 300
    out = {
        "raw": {"planes": [p.astype(np.int32) for p in raw], "specs": [None] * 3,
                "values": raw, "progs": progs},
        "packed": _packed(rng),
    }
    n_base = 2 * BLOCK_ROWS
    out["hybrid"] = {"base": [p[:n_base].astype(np.int32) for p in raw],
                     "delta": [p[n_base:].astype(np.int32) for p in raw],
                     "progs": progs[:64], "n_base": n_base}
    return out
