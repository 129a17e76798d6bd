"""Edge-case inputs of K2, the sorted-intersect join kernel.

One generator serves the CPU parity tests (the reference's Pallas kernel,
interpreted, against the port's plain versions), the card test and
``chip_smoke.py`` (the CUDA kernel against its plain versions), so all
three hold the same numpy keys. Each case is ``(left keys, ascending
right keys)``, int64, small (at most one tile spanning 64 right tiles),
and accepted by the join plan with no wide tile:

- ``long_runs``: runs of equal right keys of 9, 20 and 5,000 copies
  (longer than a fence line, than a 1024-key tile, or both), left keys on
  and around them;
- ``fence_values``: left keys equal to fence values (every ``K2_FENCE``-th
  right key) and one off them, keys just below a span's first right key
  and just above its last, keys above every right key (the span then
  holds right pads);
- ``span_64_and_1``: a tile whose span is exactly 64 right tiles and two
  tiles spanning one;
- ``shuffled``: bucket-laid-out keys permuted within each tile (the spans
  stay the same);
- ``ragged``: a short tail tile (so pad rows) and a right side whose
  length is a multiple of neither ``K2_FENCE`` nor the tile.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from .kernels import K2_FENCE, SMJ_TILE

CASES = ("long_runs", "fence_values", "span_64_and_1", "shuffled", "ragged")


def _tiles(*tiles: np.ndarray) -> np.ndarray:
    for t in tiles[:-1]:
        assert len(t) == SMJ_TILE
    return np.concatenate(tiles).astype(np.int64)


def _fill(rng, must: np.ndarray, lo: int, hi: int, n: int = SMJ_TILE) -> np.ndarray:
    """``n`` sorted keys: ``must`` and random ones in ``[lo, hi]``."""
    rest = rng.integers(lo, hi + 1, n - len(must))
    return np.sort(np.concatenate([must, rest]))


def k2_edge_cases(seed: int = 0) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    """``{name: (left keys, ascending right keys)}`` for each of ``CASES``."""
    rng = np.random.default_rng(seed)
    F = K2_FENCE
    cases = {}

    # runs of 5,000, 20 and 9 equal keys among even keys 0..11,998
    r = np.sort(np.concatenate([
        np.arange(6000, dtype=np.int64) * 2,
        np.full(5000, 4001), np.full(20, 6001), np.full(9, 7001)]))
    t0 = _fill(rng, np.array([4001] * 40 + [4000, 4002, 3999, 3001]), 3000, 4600)
    t1 = _fill(rng, np.array([6001] * 9 + [7001] * 9 + [6000, 6002, 7000, 7002]), 5500, 8000)
    cases["long_runs"] = (_tiles(t0, t1), r)

    # unique keys with gaps of 3: r[k] = 3k + 5, fences r[k * F]
    n_r = 9000
    r = np.arange(n_r, dtype=np.int64) * 3 + 5
    # tile 0: min just below r[1024] (the span's first key), max just above
    # r[3071] (its last): the span is right tiles [1, 3)
    fence = r[np.arange(1024, 3072, F)]
    must = np.unique(np.concatenate([
        [r[1024] - 1, r[3071] + 1], fence[::2], fence[1::4] - 1, fence[3::4] + 1]))
    t0 = _fill(rng, must, int(r[1024] - 1), int(r[3071] + 1))
    # tile 1: up to keys above every right key; the span ends in r's pads
    fence = r[np.arange(7168, n_r, F)]
    must = np.concatenate([[r[7168], r[-1], r[-1] + 1, r[-1] + 1, r[-1] + 30], fence[::3]])
    t1 = _fill(rng, must, int(r[7168]), int(r[-1] + 30))
    cases["fence_values"] = (_tiles(t0, t1), r)

    # even keys: tile 0 spans right tiles [0, 64), tiles 1 and 2 one each
    r = np.arange(70_000, dtype=np.int64) * 2
    t0 = _fill(rng, np.array([r[0], r[65535]]), int(r[0]), int(r[65535]))
    t1 = _fill(rng, np.array([r[66560], r[67583]]), int(r[66560]), int(r[67583]))
    t2 = rng.permutation(_fill(rng, np.array([r[67584]]), int(r[67584]), int(r[68607])))
    cases["span_64_and_1"] = (_tiles(t0, t1, t2), r)

    # bucket layout (hash buckets, key-sorted within), then each tile shuffled
    r = np.sort(rng.choice(np.arange(20_000, dtype=np.int64), 3000, replace=False))
    l = rng.choice(r, 3072) + rng.integers(0, 2, 3072)
    bucket = (l * 2654435761) % 3
    l = l[np.lexsort((l, bucket))]
    cases["shuffled"] = (np.concatenate(
        [rng.permutation(l[i:i + SMJ_TILE]) for i in range(0, len(l), SMJ_TILE)]), r)

    # 2,500 left keys (a tail tile of 452 and 572 pad rows), 3,001 right
    r = np.sort(rng.integers(0, 12_000, 3001)).astype(np.int64)
    cases["ragged"] = (np.sort(rng.choice(r, 2500) + rng.integers(-1, 2, 2500)), r)
    assert tuple(cases) == CASES
    return cases


# K2p's vpw values and the widths that give them (bitpack._vpw)
K2P_BITS = {2: 10, 4: 6, 8: 4, 16: 2, 32: 1}


def k2p_edge_cases(seed: int = 0) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    """``{"vpw_<v>": (left keys, ascending right keys)}`` for K2p, the K2
    entry over FoR-packed right keys (block 128): for each vpw a right
    side whose widest FoR block needs exactly the bits that give it, runs
    of equal keys across a line of 8 and across a block boundary, left
    keys on every fence value, beside and between right keys, and above
    every right key (a tail of pad rows, the right length a multiple of
    neither 8 nor 1024). Accepted by the join plan with no wide tile."""
    rng = np.random.default_rng(seed + 17)
    cases = {}
    for vpw, bits in K2P_BITS.items():
        top = (1 << bits) - 1
        n_blocks = 37
        blocks = []
        last = int(rng.integers(-5000, 5000))
        for b in range(n_blocks):
            off = np.sort(rng.integers(0, top + 1, 128))
            off[0], off[-1] = 0, top  # the block's span needs all the bits
            if b % 3 == 1:
                off[40:60] = off[40]  # a run across lines 5 to 7
            if b % 4 == 2:
                # the previous block's last key runs on across the boundary
                off[:12] = 0
                ref = last
            else:
                ref = last + int(rng.integers(1, 3))
            blocks.append(ref + off)
            last = int(blocks[-1][-1])
        r = np.concatenate(blocks)[: n_blocks * 128 - 45].astype(np.int64)
        fences = r[::K2_FENCE]
        extra = np.concatenate([fences, fences - 1, fences + 1, r[rng.integers(0, len(r), 500)],
                                [r[-1], r[-1] + 1, r[-1] + 1000]])
        l = np.sort(extra)
        cases[f"vpw_{vpw}"] = (l.astype(np.int64), r)
    return cases


# K2p's region cases and the vpw each packs at
K2P_REGION_VPW = {"index_vpw2": 2, "index_vpw4": 4, "span_cap": 2, "wide_and_idle": 2,
                  "duplicates": 4, "ragged": 2}


def _index_layout(rng, r: np.ndarray, n_l: int, buckets: int) -> np.ndarray:
    """``n_l`` left keys drawn from ``r`` (a quarter of them one off, so
    misses too) laid out as the index stores them: grouped by hash bucket,
    key-sorted within."""
    l = rng.choice(r, n_l) + np.where(rng.random(n_l) < 0.25, rng.integers(-1, 2, n_l), 0)
    bucket = (l * 2654435761) % buckets
    return l[np.lexsort((l, bucket))].astype(np.int64)


def _span_tile(rng, r: np.ndarray, first: int, n_tiles: int) -> np.ndarray:
    """A sorted left tile whose keys run from right tile ``first``'s first
    key to right tile ``first + n_tiles - 1``'s last: its span is exactly
    ``n_tiles`` right tiles."""
    a, b = int(r[first * SMJ_TILE]), int(r[(first + n_tiles) * SMJ_TILE - 1])
    return _fill(rng, np.array([a, b]), a, b)


def k2p_region_cases(seed: int = 0) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    """``{name: (left keys, ascending right keys)}`` for K2p at the join
    region's layout, small: what its group plan (``plan_k2p_groups``)
    must cut right. Each right side packs at ``K2P_REGION_VPW[name]``.

    - ``index_vpw2``/``index_vpw4``: the index layout over 64 and 80
      hash buckets (tiles of one bucket span a fifth to a sixth of the
      right side, neighbouring buckets' tiles almost the same right keys;
      the tiles straddling two buckets are wide);
    - ``span_cap``: tiles spanning exactly 64 right tiles (the plan's cap)
      beside spans of 63, 33, 17, 2 and 1, at staggered starts;
    - ``wide_and_idle``: wide tiles and span-0 tiles (every key in the gap
      between two right tiles) interleaved with ordinary ones;
    - ``duplicates``: runs of 9 to 300 equal right keys across lines of 8
      and FoR blocks of 128, left keys on, beside and between them;
    - ``ragged``: a right length that is a multiple of neither 8 nor 1,024
      and a short left tail tile (pad rows).
    """
    rng = np.random.default_rng(seed + 29)
    cases = {}

    # gaps of 1..7: blocks of 128 span ~512 (9-10 bits, vpw 2)
    r = np.cumsum(rng.integers(1, 8, 100_000)).astype(np.int64)
    cases["index_vpw2"] = (_index_layout(rng, r, 64 * 6 * SMJ_TILE, 64), r)
    # gaps of 1..2: blocks span ~190 (8 bits, vpw 4)
    r = np.cumsum(rng.integers(1, 3, 110_000)).astype(np.int64)
    cases["index_vpw4"] = (_index_layout(rng, r, 80 * 5 * SMJ_TILE, 80), r)

    r = np.cumsum(rng.integers(1, 8, 150 * SMJ_TILE)).astype(np.int64)
    tiles = [_span_tile(rng, r, first, n) for first, n in (
        (0, 64), (3, 64), (40, 63), (86, 64), (10, 33), (20, 17), (5, 2), (140, 1),
        (149, 1), (60, 64), (77, 17), (2, 64))]
    cases["span_cap"] = (np.concatenate(tiles), r)

    # gaps of 1..7, and of 50 before right tiles 10, 30 and 50: a tile of
    # keys inside such a gap has span 0 (its base counts every key below)
    gaps = rng.integers(1, 8, 80 * SMJ_TILE)
    gaps[[10 * SMJ_TILE, 30 * SMJ_TILE, 50 * SMJ_TILE]] = 50
    r = np.cumsum(gaps).astype(np.int64)
    idle = lambda k: np.sort(rng.integers(r[k * SMJ_TILE - 1] + 1, r[k * SMJ_TILE], SMJ_TILE))  # noqa: E731
    wide = lambda: _fill(rng, np.array([r[0], r[-1]]), int(r[0]), int(r[-1]))  # noqa: E731
    tiles = [_span_tile(rng, r, 0, 3), wide(), _span_tile(rng, r, 8, 5), idle(10),
             _span_tile(rng, r, 9, 2), idle(30), wide(), _span_tile(rng, r, 29, 4),
             _span_tile(rng, r, 60, 20), idle(50), _span_tile(rng, r, 45, 12), wide(),
             _span_tile(rng, r, 70, 10), idle(10)[:700]]
    cases["wide_and_idle"] = (np.concatenate(tiles), r)

    # gaps of 0..3 with runs of 9..300 equal keys: 8 bits, vpw 4
    g = rng.integers(1, 3, 40_000)
    for at in rng.choice(len(g) - 300, 120, replace=False):
        g[at: at + int(rng.integers(8, 300))] = 0
    r = np.cumsum(g).astype(np.int64)
    runs = np.flatnonzero(np.diff(r) == 0)
    must = np.concatenate([r[runs], r[runs] - 1, r[runs] + 1])
    l = np.concatenate([must, rng.choice(r, 3 * SMJ_TILE)])
    cases["duplicates"] = (np.sort(l[: 6 * SMJ_TILE - 5]).astype(np.int64), r)

    r = np.sort(rng.choice(np.arange(600_000, dtype=np.int64), 50_001, replace=False))
    cases["ragged"] = (_index_layout(rng, r, 40 * SMJ_TILE + 333, 8), r)
    assert tuple(cases) == tuple(K2P_REGION_VPW)
    return cases
