"""The bucket mesh: one controller driving D shards, and its collectives.

Counterpart of ``hyperspace_tpu.parallel.mesh`` (its single-controller
part). The reference's mesh is a 1-D ``jax.sharding.Mesh`` whose one axis
carries bucket parallelism, and each mesh program is one ``shard_map``.
Here a ``Mesh`` is an ordered list of D torch devices, one shard each, and
a mesh program is a loop that issues each shard's work on that shard's
device, with that device current (``Mesh.scope``), then waits once per
device:

* placement: bucket b of an index lives on shard ``owner_of_bucket(b, D)
  = b % D``: build and query consult the same rule (its scalar, numpy
  and torch forms below), so a bucketed filter, aggregate or join needs
  no collective at all;
* ``all_to_all(blocks)``: shard s holds a ``(D, cap, ...)`` block on its
  device; shard d receives the ``(D * cap, ...)`` concatenation over s of
  ``blocks[s][d]`` on its device (``lax.all_to_all(split_axis=0,
  concat_axis=0, tiled=False)`` followed by the reference's reshape).
  Between shards of one device the moves are local copies; between
  devices, ``.to(dst, non_blocking=True)`` peer copies;
* ``all_reduce(parts, op)``: SUM, MIN or MAX over per-shard tensors,
  the result on every shard's device.

Several shards may share one device (``make_mesh(n, device=...)``): the
counterpart of XLA's forced host device count, which the reference's
tests run on. Placement is explicit, so the reference's ``row_sharding``
and ``replicated`` have no counterpart, and neither has its axis name
(conf ``hyperspace.tpu.mesh.bucketAxis``): no program here names an axis.
The multi-controller tier (``initialize_multihost``, a
``torch.distributed`` process group) is not part of this module.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..exceptions import HyperspaceException


class Mesh:
    """D shards, shard i on ``devices[i]`` (a device may carry several)."""

    __slots__ = ("devices",)

    def __init__(self, devices: Sequence[torch.device]):
        if not devices:
            raise HyperspaceException("A mesh needs at least one device.")
        self.devices = tuple(torch.device(d) for d in devices)
        kinds = {d.type for d in self.devices}
        if len(kinds) != 1 or kinds - {"cuda", "cpu"}:
            raise HyperspaceException(
                f"A mesh's devices must all be cuda or all be cpu (got {self.devices})."
            )

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def device_type(self) -> str:
        return self.devices[0].type

    def scope(self, dev: torch.device):
        """Make ``dev``, a shard's device, current for the work issued
        inside: the kernels' C entries launch on the current device, and
        torch's current stream and events are the current device's. A
        no-op on the CPU."""
        if dev.type != "cuda":
            return contextlib.nullcontext()
        return torch.cuda.device(dev)

    def __repr__(self) -> str:
        return f"Mesh({self.size}, devices={[str(d) for d in self.devices]})"


def _index_cuda(dev: torch.device) -> torch.device:
    return torch.device("cuda", torch.cuda.current_device() if dev.index is None else dev.index)


def make_mesh(
    n_devices: Optional[int] = None,
    device=None,
) -> Mesh:
    """A mesh of ``n_devices`` shards. ``device`` None: one shard on each of
    the first ``n_devices`` CUDA devices (all of them by default), raising
    when fewer exist, as the reference does. ``device`` given: all
    ``n_devices`` shards on that one device (``cuda:0``, ``cpu``)."""
    if device is not None:
        dev = torch.device(device)
        if dev.type == "cuda":
            if not torch.cuda.is_available():
                raise HyperspaceException(
                    f"Device {dev} requested but torch.cuda.is_available() is False."
                )
            dev = _index_cuda(dev)
        return Mesh([dev] * int(n_devices or 1))
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    want = count if n_devices is None else int(n_devices)
    if want > count or want < 1:
        raise ValueError(f"Requested {want} devices but only {count} present.")
    return Mesh([torch.device("cuda", i) for i in range(want)])


def owner_of_bucket(bucket: int, n_devices: int) -> int:
    """THE bucket→shard placement rule. Build and query must agree (a
    silent divergence corrupts joins), so the rule exists once: this
    scalar form, ``owner_of_bucket_array`` (the numpy twin the build's
    capacity planner and the shuffle planner use) and
    ``owner_of_bucket_device`` (the torch twin inside the exchanges). All
    three are the same modular expression."""
    return bucket % n_devices


def owner_of_bucket_array(buckets: np.ndarray, n_devices: int) -> np.ndarray:
    return buckets % n_devices


def owner_of_bucket_device(buckets: torch.Tensor, n_devices: int) -> torch.Tensor:
    return buckets % n_devices


def process_info() -> dict:
    """This process's place in the job: the single controller, process 0
    of 1, driving every local CUDA device."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return {"process_index": 0, "process_count": 1, "local_devices": n, "global_devices": n}


# ---------------------------------------------------------------------------
# collectives over per-shard tensors
# ---------------------------------------------------------------------------
def all_to_all(blocks: Sequence[torch.Tensor], mesh: Mesh) -> List[torch.Tensor]:
    """Shard s sends ``blocks[s][d]`` (a ``(D, cap, ...)`` block on its
    device) to shard d, which receives the ``(D * cap, ...)``
    concatenation over s on ``mesh.devices[d]``. The copies are queued
    without waiting; a consumer on the receiving device is ordered after
    them by its stream."""
    D = mesh.size
    if len(blocks) != D:
        raise HyperspaceException(f"all_to_all: {len(blocks)} blocks for {D} shards.")
    out = []
    for d, dev in enumerate(mesh.devices):
        with mesh.scope(dev):
            parts = [blocks[s][d].to(dev, non_blocking=True) for s in range(D)]
            out.append(torch.cat(parts, dim=0))
    return out


_REDUCE = {"sum": torch.add, "min": torch.minimum, "max": torch.maximum}


def all_reduce(parts: Sequence[torch.Tensor], op: str, mesh: Mesh) -> List[torch.Tensor]:
    """``op`` (sum, min or max) over one tensor per shard, reduced on the
    first shard's device, the result on every shard's device."""
    fn = _REDUCE.get(op)
    if fn is None:
        raise HyperspaceException(f"all_reduce: unknown op {op!r}; expected sum, min or max.")
    if len(parts) != mesh.size:
        raise HyperspaceException(f"all_reduce: {len(parts)} parts for {mesh.size} shards.")
    home = mesh.devices[0]
    acc = parts[0].to(home, non_blocking=True)
    for p in parts[1:]:
        acc = fn(acc, p.to(home, non_blocking=True))
    return [acc if dev == home else acc.to(dev, non_blocking=True) for dev in mesh.devices]
