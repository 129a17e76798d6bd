"""The bucketed all_to_all shuffle: repartitioning one join side on the mesh.

Counterpart of ``hyperspace_tpu.distributed.shuffle``. Build-time
``b % D`` placement makes co-partitioned joins exchange-free, which leaves
one hole: two indexes bucketed with DIFFERENT ``num_buckets`` share no
bucket space. This module closes it with the build's own exchange:

* the moved side's columns travel in the device transport encoding
  (``ops.build.encode_for_device``: float64 as ordered int64, strings as
  dictionary codes with the vocab reattached on the host);
* rows scatter into ``(D, cap)`` blocks (``ops.build.scatter_blocks``),
  the capacity from the build's ``_exchange_cap`` and ``next_pow2``;
* each row's destination is the shared placement rule
  (``parallel.mesh.owner_of_bucket_array``) applied to its bucket in the
  TARGET side's bucket space; the hash is value-stable
  (``ops.hashing.key_repr``), so equal join keys land in equal buckets
  whichever index they came from;
* ONE round moves everything: every payload plane, the target bucket ids
  and the validity plane ride the same ``all_to_all``, every shard issued
  before the first wait.

After the exchange both sides are co-partitioned in the target bucket
space and the join rides the existing arms (``exec.distributed.
distributed_bucketed_join`` over ``dist_min_rows``, else the bucketed
join). A device error mid-exchange (a ``RuntimeError``; a
``HyperspaceException`` such as ``KernelBuildError`` is never caught)
counts ``shuffle.device_failed``, freezes a flight-recorder snapshot and
returns None: the caller's exact join answers.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch

from ..exceptions import HyperspaceException
from ..ops.build import DeviceFetch, _exchange_cap, _to_device, encode_for_device, scatter_blocks
from ..ops.hashing import bucket_ids_host, key_repr
from ..parallel.mesh import all_to_all, owner_of_bucket_array
from ..storage.columnar import Column, ColumnarBatch, decode_device_array
from ..telemetry.metrics import metrics
from ..telemetry.recorder import flight_recorder
from ..telemetry.trace import add_bytes as _trace_bytes
from ..telemetry.trace import span
from ..utils.intmath import next_pow2

__all__ = ["repartition_by_bucket", "try_shuffle_join"]


def _exchange(planes: List[np.ndarray], dest: np.ndarray, mesh, cap: int,
              shard_rows: int) -> List[np.ndarray]:
    """The one-round repartition program (the reference's ``_shuffle_fn``):
    each source shard uploads its contiguous row range and scatters every
    plane into ``(D, cap)`` blocks by destination; one ``all_to_all`` per
    plane moves them (each plane's send blocks freed once received); each
    shard's receive comes home through pinned, non-blocking copies. Returns
    every plane received, validity last, as ``(D * D * cap,)`` host arrays
    in shard order."""
    D, n = mesh.size, int(dest.shape[0])
    sends = []
    for s, dev in enumerate(mesh.devices):
        lo, hi = min(s * shard_rows, n), min((s + 1) * shard_rows, n)
        with mesh.scope(dev):
            up = [_to_device(p[lo:hi], dev) for p in planes]
            d_dev = _to_device(dest[lo:hi], dev).to(torch.int64)
            sends.append(scatter_blocks(up, d_dev, D, cap))
    recv: List[List[torch.Tensor]] = [[] for _ in range(D)]
    for p in range(len(planes) + 1):
        got = all_to_all([sends[s][p] for s in range(D)], mesh)
        for s in range(D):
            sends[s][p] = None
        for d in range(D):
            recv[d].append(got[d])
    fetches = []
    for d, dev in enumerate(mesh.devices):
        with mesh.scope(dev):
            fetches.append(DeviceFetch(recv[d]))
    parts = [f.wait() for f in fetches]
    return [np.concatenate([parts[d][p] for d in range(D)]) for p in range(len(planes) + 1)]


def repartition_by_bucket(
    by_bucket: Dict[int, ColumnarBatch],
    key_cols: List[str],
    target_num_buckets: int,
    mesh,
) -> Optional[Dict[int, ColumnarBatch]]:
    """Move one join side into ``target_num_buckets`` bucket space over a
    single all_to_all round: rows land on their new bucket's owner shard
    (``b % D``) and come back grouped by new bucket id, each bucket's rows
    in their input order. None on a device error mid-exchange (the caller
    takes the exact join); raises only on row loss, which would mean the
    exchange itself is wrong."""
    if not by_bucket:
        return {}
    whole = ColumnarBatch.concat([by_bucket[b] for b in sorted(by_bucket)])
    n = whole.num_rows
    D = mesh.size
    if n == 0:
        return {}
    # every row's bucket in the target space, by the value-stable host hash
    # the unmoved side's build used
    target_bucket = bucket_ids_host(
        [key_repr(whole.columns[k]) for k in key_cols], target_num_buckets
    )
    dest = owner_of_bucket_array(target_bucket, D).astype(np.int32)
    shard_rows = next_pow2(max(math.ceil(n / D), 1))
    cap = next_pow2(_exchange_cap(dest, shard_rows, n, D, D))
    names = list(whole.columns)
    planes = [encode_for_device(whole.columns[name]) for name in names]
    planes.append(target_bucket.astype(np.int32))
    # the port ships each plane's rows and the destinations, no pad rows;
    # between shards move D x D blocks of cap rows a plane, validity as 1 byte
    h2d = sum(int(p.nbytes) for p in planes) + int(dest.nbytes)
    ici = (sum(p.itemsize for p in planes) + 1) * D * D * cap

    with span("shuffle.all_to_all", devices=D, rows=n, capacity=cap,
              planes=len(names), target_buckets=target_num_buckets):
        try:
            metrics.incr("shuffle.rounds")
            recv = _exchange(planes, dest, mesh, cap, shard_rows)
        except HyperspaceException:
            raise
        except RuntimeError as e:  # device loss or a fenced card mid-exchange
            metrics.incr("shuffle.device_failed")
            flight_recorder.snapshot(f"shuffle_device_loss: {type(e).__name__}")
            return None
        d2h = sum(int(x.nbytes) for x in recv)
        metrics.incr("shuffle.h2d_bytes", h2d)
        metrics.incr("shuffle.ici_bytes", ici)
        metrics.incr("shuffle.d2h_bytes", d2h)
        metrics.incr("shuffle.rows_moved", n)
        _trace_bytes("h2d_bytes", h2d)
        _trace_bytes("ici_bytes", ici)
        _trace_bytes("d2h_bytes", d2h)

    vmask = recv[-1]
    got = int(vmask.sum())
    if got != n:
        raise HyperspaceException(f"Shuffle lost rows: sent {n}, received {got}.")
    keep = np.flatnonzero(vmask)
    kept_bucket = recv[-2][keep]
    # received rows are grouped by owner shard; a stable sort on bucket id
    # gives each bucket's rows in a run, in their input order
    order = np.argsort(kept_bucket, kind="stable")
    kept_bucket = kept_bucket[order]
    uniq, starts = np.unique(kept_bucket, return_index=True)
    bounds = list(starts) + [kept_bucket.size]
    decoded = {name: recv[i][keep][order] for i, name in enumerate(names)}
    out: Dict[int, ColumnarBatch] = {}
    for i, b in enumerate(uniq):
        lo, hi = bounds[i], bounds[i + 1]
        cols: Dict[str, Column] = {}
        for name in names:
            src = whole.columns[name]
            seg = decoded[name][lo:hi]
            if src.vocab is not None:
                cols[name] = Column(src.dtype_str, seg.astype(np.int32), vocab=src.vocab)
            else:
                cols[name] = Column(src.dtype_str, decode_device_array(src.dtype_str, seg))
        out[int(b)] = ColumnarBatch(cols)
    return out


def try_shuffle_join(
    l_by_bucket: Dict[int, ColumnarBatch],
    r_by_bucket: Dict[int, ColumnarBatch],
    l_keys: List[str],
    r_keys: List[str],
    moved_side: str,
    target_num_buckets: int,
    mesh,
    dist_min_rows: int,
) -> Optional[List[ColumnarBatch]]:
    """Repartition ``moved_side`` into the other side's bucket space, then
    ride the co-partitioned join arms. ``l_keys``/``r_keys`` are in the
    UNMOVED side's index order (the caller reorders). Returns the join's
    parts, or None when the exchange failed (the caller's exact join
    answers)."""
    if moved_side == "right":
        moved = repartition_by_bucket(r_by_bucket, r_keys, target_num_buckets, mesh)
        if moved is None:
            return None
        r_by_bucket = moved
    else:
        moved = repartition_by_bucket(l_by_bucket, l_keys, target_num_buckets, mesh)
        if moved is None:
            return None
        l_by_bucket = moved
    total_rows = sum(b.num_rows for b in l_by_bucket.values()) + sum(
        b.num_rows for b in r_by_bucket.values()
    )
    if total_rows >= dist_min_rows:
        from ..exec.distributed import distributed_bucketed_join

        parts = distributed_bucketed_join(l_by_bucket, r_by_bucket, l_keys, r_keys, mesh)
    else:
        from ..exec.joins import bucketed_join_pairs

        parts = bucketed_join_pairs(l_by_bucket, r_by_bucket, l_keys, r_keys,
                                    mesh.devices[0])
    metrics.incr("scan.path.resident_join_shuffle")
    return parts
