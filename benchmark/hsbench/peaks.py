"""Published peaks of one NVIDIA H100 and the least time a piece of work
needs on it.

Frozen copy of ``chip_smoke.py:bound`` and its constants (NVIDIA's data
sheet, SXM part, at the full 700 W limit; a card set lower runs below
them, so the result line carries the card's power limit beside any share
of them). Part of the yardstick: later changes to the program are held to
the same arithmetic.
"""

from __future__ import annotations

H100_BYTES_PER_S = 3.35e12
H100_OPS_PER_S = 67e12  # 32-bit, outside the tensor cores


def bound_s(nbytes: float, ops: float = 0.0):
    """(seconds, "bytes" | "operations"): the larger of the two floors."""
    t_bytes = nbytes / H100_BYTES_PER_S
    t_ops = ops / H100_OPS_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def packed_plane_bytes(n_rows: int, lo: int, hi: int) -> int:
    """Bytes of an int column frame-of-reference packed into 32-bit words
    (values per word 32 // bits, at least 1): the compressed tier's unit."""
    bits = max(1, int(hi - lo).bit_length())
    per_word = max(1, 32 // bits)
    return -(-n_rows // per_word) * 4
