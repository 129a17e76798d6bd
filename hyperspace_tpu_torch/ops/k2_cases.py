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
