"""The multi-process control plane: the fabric a job of several
processes stands on.

Counterpart of ``hyperspace_tpu.distributed.fabric``. ``QueryFabric`` is
one process's front door: it brings up the ``torch.distributed`` process
group (``parallel.mesh.initialize_multihost``, idempotent) when a
coordinator or an ``init_method`` is given, builds the global bucket mesh
(``parallel.mesh.ProcessMesh``: D = P x L shards, process-major) over the
local shards the caller passes, gives this process's place in it, and
answers placement questions: which shard owns a bucket (the shared
``owner_of_bucket`` rule), hence which process, which is what a
multi-process builder needs to write only its own buckets and what the
router's partition map says one level up, at host granularity.

Where the reference returns a JAX device that carries its
``process_index``, ``owner_device_of_bucket`` returns a ``ShardPlacement``
record (shard, process, and for a local shard its torch device). A job of
one process connects without a group: its mesh is its local shards.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import torch

from ..exceptions import HyperspaceException
from ..parallel.mesh import (
    Mesh,
    ProcessMesh,
    initialize_multihost,
    make_mesh,
    owner_of_bucket,
    process_info,
)
from ..telemetry.metrics import metrics

__all__ = ["QueryFabric", "ShardPlacement"]


@dataclass(frozen=True)
class ShardPlacement:
    """Where one shard of the global mesh lives: its global id, its
    process, and (for a shard of this process) its torch device."""

    shard: int
    process_index: int
    device: Optional[torch.device]


class QueryFabric:
    """One process's handle on the job's execution fabric. ``local_mesh``
    is this process's shards (default ``make_mesh()``: every CUDA card);
    ``backend`` the group's (default by the shards' device type:
    ``parallel.mesh.initialize_multihost``)."""

    def __init__(
        self,
        coordinator_address: Optional[str] = None,
        num_processes: Optional[int] = None,
        process_id: Optional[int] = None,
        init_method: Optional[str] = None,
        local_mesh: Optional[Mesh] = None,
        backend: Optional[str] = None,
    ):
        self.coordinator_address = coordinator_address
        self.num_processes = num_processes
        self.process_id = process_id
        self.init_method = init_method
        self.backend = backend
        self._local_mesh = local_mesh
        self._mesh: Optional[ProcessMesh] = None

    # -- lifecycle ------------------------------------------------------------
    def connect(self) -> "QueryFabric":
        """Join the job: bring up the process group (only when a
        coordinator or ``init_method`` is given; a no-op when it is up)
        and build the global mesh over every process's shards."""
        local = self._local_mesh if self._local_mesh is not None else make_mesh()
        if self.coordinator_address is not None or self.init_method is not None:
            initialize_multihost(
                coordinator_address=self.coordinator_address,
                num_processes=self.num_processes,
                process_id=self.process_id,
                backend=self.backend,
                init_method=self.init_method,
                local_mesh=local,
            )
        self._local_mesh = local
        self._mesh = ProcessMesh(local)
        metrics.incr("mesh.fabric.connected")
        return self

    @property
    def connected(self) -> bool:
        return self._mesh is not None

    @property
    def mesh(self) -> ProcessMesh:
        if self._mesh is None:
            raise HyperspaceException("Fabric not connected; call connect().")
        return self._mesh

    # -- placement ------------------------------------------------------------
    def info(self) -> dict:
        return process_info(self._local_mesh)

    def owner_device_of_bucket(self, bucket: int) -> ShardPlacement:
        """The shard a bucket lives on, by the one shared rule."""
        mesh = self.mesh
        shard = owner_of_bucket(bucket, mesh.size)
        return ShardPlacement(shard, mesh.process_of_shard(shard), mesh.device_of_shard(shard))

    def owner_process_of_bucket(self, bucket: int) -> int:
        return self.owner_device_of_bucket(bucket).process_index

    def local_buckets(self, num_buckets: int) -> List[int]:
        """Buckets owned by THIS process's shards: the set a multi-process
        builder writes."""
        me = self.mesh.process_index
        return [b for b in range(num_buckets) if self.owner_process_of_bucket(b) == me]

    # -- serving --------------------------------------------------------------
    def make_router(
        self,
        sessions,
        serve_config=None,
        health_policy=None,
        retry_policy=None,
        hedging: bool = True,
    ):
        """The serve front over ``{host: session}``: one QueryServer per
        host session and the health-directed QueryRouter before them, the
        one assembly path every multi-host serving test and a real job
        share, so the failure-domain wiring (health director, hedges,
        retry budgets) is never re-plumbed by hand."""
        from ..serve.server import QueryServer, ServeConfig
        from .router import QueryRouter

        if not sessions:
            raise HyperspaceException("make_router needs at least one session.")
        servers = {
            name: QueryServer(sess, serve_config or ServeConfig())
            for name, sess in sessions.items()
        }
        return QueryRouter(
            servers,
            health_policy=health_policy,
            retry_policy=retry_policy,
            hedging=hedging,
        )

    # -- build ----------------------------------------------------------------
    def build_sharded(self, batch, key_names, num_buckets, scratch_dir=None):
        """The multi-process sharded build on the fabric's mesh: each
        process feeds its own rows and gets its local shards' bucket
        slices and the global counts
        (``ops.build.build_partition_sharded_multihost``)."""
        from ..ops.build import build_partition_sharded_multihost

        return build_partition_sharded_multihost(
            batch, key_names, num_buckets, self.mesh, scratch_dir=scratch_dir
        )
