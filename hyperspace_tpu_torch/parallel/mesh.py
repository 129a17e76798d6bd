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

The multi-controller tier (the reference's ``initialize_multihost`` and
``process_info`` over ``jax.distributed``): several OS processes, each
driving its own L shards, form one job through a ``torch.distributed``
process group (``initialize_multihost``). ``ProcessMesh`` is the global
mesh of D = P x L shards over P processes, process-major as the
reference's ``Mesh(np.array(jax.devices()))``: shard d lives on process
``d // L``, local slot ``d % L``, so placement stays ``owner_of_bucket(b,
D)``. Its collectives run between processes:

* ``ProcessMesh.all_to_all(blocks)``: one ``dist.all_to_all_single`` per
  plane with equal splits; shard d receives the concatenation over every
  source shard in global order (process, then local shard);
* ``ProcessMesh.consensus(values, op)``: SUM, MIN or MAX of small int64
  vectors over the processes (``dist.all_reduce``);
* ``ProcessMesh.barrier()``.

With NCCL the collectives take the shards' CUDA tensors (gathered on the
process's first device). With gloo every operand of a CUDA mesh is copied
into pinned host memory and back around the collective, and those bytes
are counted (``staged_bytes``, ``mesh.collective.staged_bytes``): two
processes sharing one card cannot share an NCCL communicator, so such a
run names gloo. Nothing switches backend on its own.
"""

from __future__ import annotations

import contextlib
import time
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


# ---------------------------------------------------------------------------
# multi-controller: the process group and the global mesh
# ---------------------------------------------------------------------------
def _group_up() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    init_method: Optional[str] = None,
    local_mesh: Optional[Mesh] = None,
) -> None:
    """Join this process to the job's ``torch.distributed`` process group.
    Call once per process; a no-op when the group is already up.
    ``coordinator_address`` ``"host:port"`` becomes ``tcp://host:port``;
    ``init_method`` (``file://...``, ``tcp://...``) is passed through; with
    neither, the group reads ``MASTER_ADDR``/``MASTER_PORT`` (``env://``).
    ``backend`` defaults to ``nccl`` for CUDA shards (``local_mesh``, every
    CUDA card when None) and ``gloo`` for CPU shards. Under NCCL the
    process's first shard's card is made current before the group forms."""
    import torch.distributed as dist

    if _group_up():
        return
    if coordinator_address is not None and init_method is not None:
        raise HyperspaceException(
            "initialize_multihost takes coordinator_address or init_method, not both."
        )
    if coordinator_address is not None:
        init_method = f"tcp://{coordinator_address}"
    device_type = "cuda" if local_mesh is None else local_mesh.device_type
    if backend is None:
        backend = "nccl" if device_type == "cuda" else "gloo"
    if backend == "nccl":
        if device_type != "cuda":
            raise HyperspaceException("The nccl backend needs CUDA shards.")
        torch.cuda.set_device(
            _index_cuda(local_mesh.devices[0]) if local_mesh is not None else 0
        )
    dist.init_process_group(
        backend=backend,
        init_method=init_method,
        world_size=-1 if num_processes is None else int(num_processes),
        rank=-1 if process_id is None else int(process_id),
    )


def process_info(local_mesh: Optional[Mesh] = None) -> dict:
    """This process's place in the job: its rank and the group's size when
    a process group is up, else process 0 of 1. ``local_devices`` counts
    this process's shards (``local_mesh``, every CUDA card when None) and
    ``global_devices`` every process's (the global mesh makes them equal)."""
    import torch.distributed as dist

    if local_mesh is not None:
        n = local_mesh.size
    else:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if _group_up():
        rank, world = dist.get_rank(), dist.get_world_size()
    else:
        rank, world = 0, 1
    return {"process_index": rank, "process_count": world, "local_devices": n,
            "global_devices": n * world}


_REDUCE_OPS = ("sum", "min", "max")


class ProcessMesh:
    """The global mesh: D = P x L shards over P processes with L local
    shards each (``local``), shard d on process ``d // L``, local slot
    ``d % L``. Without a process group it is process 0 of 1 and its
    collectives are local."""

    def __init__(self, local: Mesh):
        import torch.distributed as dist

        self.local = local
        if _group_up():
            self.process_index, self.process_count = dist.get_rank(), dist.get_world_size()
            self.backend = str(dist.get_backend())
        else:
            self.process_index, self.process_count, self.backend = 0, 1, None
        self.staged_bytes = 0
        self._pool: dict = {}  # role -> pinned uint8 staging buffer
        self.staging_alloc_s = 0.0  # seconds spent pinning staging buffers
        if self.backend == "nccl" and local.device_type != "cuda":
            raise HyperspaceException("An nccl process group needs CUDA shards.")
        hi, neg_lo = self.consensus([local.size, -local.size], "max")
        lo = -neg_lo
        if lo != hi:
            raise HyperspaceException(
                f"Every process must bring the same number of local shards: this process "
                f"has {local.size}, the group's range is {lo}..{hi}."
            )

    @property
    def local_size(self) -> int:
        return self.local.size

    @property
    def size(self) -> int:
        return self.local.size * self.process_count

    def process_of_shard(self, shard: int) -> int:
        return shard // self.local.size

    def local_shards(self) -> range:
        """The global ids of this process's shards, in local slot order."""
        base = self.process_index * self.local.size
        return range(base, base + self.local.size)

    def device_of_shard(self, shard: int) -> Optional[torch.device]:
        """The torch device of a shard of this process (None for another's)."""
        if self.process_of_shard(shard) != self.process_index:
            return None
        return self.local.devices[shard % self.local.size]

    # -- collectives ----------------------------------------------------------
    def _collective_device(self) -> torch.device:
        if self.backend == "nccl":
            return _index_cuda(self.local.devices[0])
        return torch.device("cpu")

    def _pinned(self, role: str, shape, dtype: torch.dtype) -> torch.Tensor:
        """A pinned host buffer of ``shape`` and ``dtype``: one a ``role``
        (send, recv), grown to the largest plane and reused by every plane
        after it, so an exchange pins its host memory once, not twice a
        plane. ``release_staging`` frees it."""
        nbytes = int(np.prod(shape)) * dtype.itemsize
        buf = self._pool.get(role)
        if buf is None or buf.numel() < nbytes:
            self._pool[role] = None  # the old buffer goes before the new one is pinned
            t = time.perf_counter()
            buf = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
            self.staging_alloc_s += time.perf_counter() - t
            self._pool[role] = buf
        return buf[:nbytes].view(dtype).view(shape)

    def release_staging(self) -> None:
        """Frees the pinned staging buffers (the end of an exchange)."""
        self._pool.clear()

    def _staged(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` where the backend can take it: a copy of a CUDA tensor in
        the pinned send buffer under gloo (its bytes counted), the tensor
        itself otherwise."""
        if self.backend == "gloo" and x.device.type == "cuda":
            host = self._pinned("send", tuple(x.shape), x.dtype)
            host.copy_(x)
            self._count_staged(host.numel() * host.element_size())
            return host
        return x

    def _count_staged(self, nbytes: int) -> None:
        from ..telemetry.metrics import metrics

        self.staged_bytes += int(nbytes)
        metrics.incr("mesh.collective.staged_bytes", int(nbytes))

    def consensus(self, values: Sequence[int], op: str) -> List[int]:
        """``op`` (sum, min or max) of each of ``values`` over the processes,
        the same list on every process."""
        if op not in _REDUCE_OPS:
            raise HyperspaceException(f"consensus: unknown op {op!r}; expected sum, min or max.")
        if self.process_count == 1:
            return [int(v) for v in values]
        import torch.distributed as dist

        t = torch.tensor([int(v) for v in values], dtype=torch.int64,
                         device=self._collective_device())
        dist.all_reduce(t, op={"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
                               "max": dist.ReduceOp.MAX}[op])
        return [int(v) for v in t.tolist()]

    def barrier(self) -> None:
        """Returns once every process has entered it (a one-element
        all_reduce, so it runs on the collectives' own device)."""
        self.consensus([0], "max")

    def all_to_all(self, blocks: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Local shard s sends ``blocks[s][d]`` (a ``(D, cap, ...)`` block on
        its device) to global shard d; local shard l receives the ``(D *
        cap, ...)`` concatenation over every global source shard, in global
        order, on its device. One ``all_to_all_single`` with equal splits:
        the send buffer is laid out (destination process, local source,
        local destination, cap, ...)."""
        L, P, D = self.local.size, self.process_count, self.size
        if len(blocks) != L:
            raise HyperspaceException(f"all_to_all: {len(blocks)} blocks for {L} local shards.")
        if P == 1:
            return all_to_all(blocks, self.local)
        import torch.distributed as dist

        home = self.local.devices[0]
        if home.type == "cuda":
            home = _index_cuda(home)
        dtype = blocks[0].dtype
        tail = tuple(blocks[0].shape[2:])
        cap = int(blocks[0].shape[1])
        x = torch.stack([b.to(home) for b in blocks])  # (L_src, D, cap, ...)
        if dtype == torch.bool:
            x = x.view(torch.uint8)
        x = x.view((L, P, L, cap) + tail).transpose(0, 1).contiguous()
        send = self._staged(x)
        if send is x:
            recv = torch.empty(send.shape, dtype=send.dtype, device=send.device)
        else:
            recv = self._pinned("recv", tuple(send.shape), send.dtype)
        dist.all_to_all_single(recv, send)
        if recv.device != x.device:
            self._count_staged(recv.numel() * recv.element_size())
            recv = recv.to(home)
        if dtype == torch.bool:
            recv = recv.view(torch.bool)
        recv = recv.view((P, L, L, cap) + tail)  # (src process, L_src, L_dst, cap, ...)
        out = []
        for l, dev in enumerate(self.local.devices):
            part = recv[:, :, l].reshape((D * cap,) + tail)
            out.append(part.to(dev, non_blocking=True))
        return out

    def __repr__(self) -> str:
        return (f"ProcessMesh({self.size} shards, process {self.process_index} of "
                f"{self.process_count}, local={self.local!r}, backend={self.backend})")


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
