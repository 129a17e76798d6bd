"""Device layer: where engine work runs, how kernel launches are counted,
and how a caller waits for the card.

Every engine entry point takes a ``device`` argument (or the session's
``hyperspace.torch.device`` conf). ``resolve_device`` turns it into a
``torch.device``: ``cuda`` unless the caller asked for ``cpu``, and an
error, never a quiet CPU run, when CUDA was asked for and is absent.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Union

import torch

from ..exceptions import HyperspaceException

DeviceLike = Union[None, str, torch.device]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``cuda`` unless ``device`` names the CPU. Raises when a CUDA device
    is requested and this process has none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise HyperspaceException(
            f"Device {dev} requested but torch.cuda.is_available() is False; "
            "pass device='cpu' (conf hyperspace.torch.device=cpu) to run on "
            "the CPU."
        )
    if dev.type not in ("cuda", "cpu"):
        raise HyperspaceException(f"Unsupported device {dev}.")
    return dev


# Launch counts of the hand-written CUDA kernels: each wrapper adds one
# exactly where it launches its kernel (the plain CPU versions never
# count), so a run can show that the main path went through the kernels.
# The lock keeps a count whole when two threads launch at once (the two
# sides of a hybrid union run concurrently).
_LAUNCHES: Dict[str, int] = {}
_LAUNCHES_LOCK = threading.Lock()


def count_launch(kernel: str) -> None:
    with _LAUNCHES_LOCK:
        _LAUNCHES[kernel] = _LAUNCHES.get(kernel, 0) + 1


def launch_counts() -> Dict[str, int]:
    with _LAUNCHES_LOCK:
        return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    with _LAUNCHES_LOCK:
        _LAUNCHES.clear()


def fence(device: Optional[torch.device] = None) -> None:
    """Block until every kernel queued on ``device`` has finished (no-op
    on the CPU, where torch runs synchronously)."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


# the kernels' launch-count names, and the entry points of the residency
# tiers' kernels (K1p: packed planes; K1h: base + delta)
from .kernels import (  # noqa: E402,F401
    K1,
    K1C,
    K1H,
    K1P,
    K2,
    K2F,
    hybrid_block_counts_tensor,
    predicate_block_counts_packed_tensor,
)
