"""Bounded exponential backoff with deterministic jitter.

Counterpart of ``hyperspace_tpu.reliability.retry``'s ``RetryPolicy``:
the delay before each retry, its jitter a stable hash of (seed key,
attempt), so a replayed schedule replays its timing while distinct
callers still spread out. The serve client (``serve/client.py``) backs
off with it. The error classification and the retrying file-system
decorator over the storage seam come with the reliability slice.
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass


@dataclass(frozen=True)
class RetryPolicy:
    """Bounded exponential backoff. ``max_attempts`` counts the first try:
    ``max_attempts=1`` disables retrying."""

    max_attempts: int = 4
    base_delay_s: float = 0.05
    max_delay_s: float = 2.0
    jitter: float = 0.25  # +/- fraction of the computed delay

    def delay_for(self, attempt: int, seed_key: str = "") -> float:
        """Delay before retry number ``attempt`` (1-based): a deterministic
        function of (seed_key, attempt)."""
        base = min(self.base_delay_s * (2 ** (attempt - 1)), self.max_delay_s)
        if not self.jitter:
            return base
        h = zlib.crc32(f"{seed_key}#{attempt}".encode("utf-8"))
        frac = (h / 0xFFFFFFFF) * 2.0 - 1.0  # crc32 -> [-1, 1]
        return max(0.0, base * (1.0 + self.jitter * frac))


DEFAULT_RETRY_POLICY = RetryPolicy()
