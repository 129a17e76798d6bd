"""Shared integer helpers."""

from __future__ import annotations


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (1 for n <= 1): the one quantization rule
    of the mesh's packers (shard rows, exchange capacity) and the shuffle
    planner's histogram classes."""
    return 1 << (n - 1).bit_length() if n > 1 else 1
