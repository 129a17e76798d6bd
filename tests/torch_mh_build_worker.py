"""One process of the port's multi-process sharded build: it joins a
``torch.distributed`` group through a ``file://`` store, feeds ONLY its
own share of a seeded table to ``QueryFabric.build_sharded`` and writes
ONLY the buckets its shards own, then its global counts. Imports only the
port (and numpy). Driven by ``tests/test_torch_multihost.py``, which also
imports ``table`` and ``share`` from here to build the same rows whole.

    python tests/torch_mh_build_worker.py PID NPROC INIT_FILE OUT_DIR CASE \\
        DEVICE LOCAL_SHARDS BACKEND

CASE is one of ``CASES`` (``lost`` drops each source shard's first row
from its send blocks, as an overflowing block would; ``astray`` shifts the host's owner map by one
shard, so each shard receives other rows than it counted); DEVICE is ``cpu`` or ``cuda`` (one card a
process, ``cuda:<PID * LOCAL_SHARDS + l>`` for its shard l) or ``cuda:0``
(every shard on that card); BACKEND is ``gloo`` or ``nccl``. Exit code 0
on success, 3 when the build refused with a HyperspaceException (printed).
"""

import json
import sys
from pathlib import Path

import numpy as np

TOTAL = 3000
NUM_BUCKETS = 16
MODES = np.array([b"AIR", b"SHIP", b"RAIL", b"MAIL", b"TRUCK"], dtype=object)
CASES = ("base", "vocab", "negative", "empty", "mismatch", "lost", "astray")


def table(case: str) -> dict:
    """The whole table of ``case`` (numpy columns), made from one seed."""
    rng = np.random.default_rng(42)
    orderkey = rng.integers(0, 10**9, TOTAL).astype(np.int64)
    qty = rng.integers(0, 50, TOTAL).astype(np.int64)
    mode = MODES[rng.integers(0, 5, TOTAL)]
    half = TOTAL // 2
    if case == "vocab":  # the halves' dictionaries differ: {AIR, SHIP, RAIL} | {RAIL, MAIL, TRUCK}
        mode[:half] = MODES[rng.integers(0, 3, half)]
        mode[half:] = MODES[rng.integers(2, 5, TOTAL - half)]
    if case == "negative":  # only the second half holds negative keys
        orderkey[half:] -= 10**9 // 2
    return {"orderkey": orderkey, "qty": qty, "mode": mode}


def share(case: str, pid: int, nproc: int):
    """This process's contiguous row range of the table."""
    if case == "empty":  # process 0 holds every row, the others none
        return (0, TOTAL) if pid == 0 else (TOTAL, TOTAL)
    return pid * TOTAL // nproc, (pid + 1) * TOTAL // nproc


def main(argv) -> int:
    pid, nproc, init_file, out_dir, case, device, local_shards, backend = argv
    pid, nproc, local_shards = int(pid), int(nproc), int(local_shards)
    import torch.distributed

    from hyperspace_tpu_torch.distributed import QueryFabric
    from hyperspace_tpu_torch.exceptions import HyperspaceException
    from hyperspace_tpu_torch.parallel.mesh import Mesh, make_mesh
    from hyperspace_tpu_torch.storage import layout
    from hyperspace_tpu_torch.storage.columnar import Column, ColumnarBatch

    if case == "mismatch" and pid == 1:
        local_shards -= 1
    if case in ("lost", "astray"):
        from hyperspace_tpu_torch.ops import build
        from hyperspace_tpu_torch.parallel import mesh

        if case == "lost":
            scatter = build.scatter_blocks

            def dropping(planes, dest, D, cap):
                dest = dest.clone()
                dest[:1] = D  # a source shard's first row: the trash slot
                return scatter(planes, dest, D, cap)

            build.scatter_blocks = dropping
        else:  # blocks wide enough for any shard's rows, so only the owners differ
            build._exchange_cap = lambda host_dest, shard_rows, *a: shard_rows
            owner = mesh.owner_of_bucket_array
            mesh.owner_of_bucket_array = lambda b, d: (owner(b, d) + 1) % d
    if device == "cuda":  # a card of its own for each shard
        local = Mesh([f"cuda:{pid * local_shards + i}" for i in range(local_shards)])
    else:
        local = make_mesh(local_shards, device=device)
    t = table(case)
    lo, hi = share(case, pid, nproc)
    batch = ColumnarBatch({
        "orderkey": Column.from_values(t["orderkey"][lo:hi]),
        "qty": Column.from_values(t["qty"][lo:hi]),
        "mode": Column.from_values(t["mode"][lo:hi], "string"),
    })
    out = Path(out_dir)
    try:
        fabric = QueryFabric(init_method=f"file://{init_file}", num_processes=nproc,
                             process_id=pid, local_mesh=local, backend=backend).connect()
        info = fabric.info()
        assert info["process_count"] == nproc and info["process_index"] == pid, info
        per_local, global_counts = fabric.build_sharded(
            batch, ["orderkey"], NUM_BUCKETS, scratch_dir=out / ".vocab")
    except HyperspaceException as e:
        print(f"proc {pid}: HyperspaceException: {e}", flush=True)
        return 3
    mine = set(fabric.local_buckets(NUM_BUCKETS))
    written = []
    for dev_batch, bucket_ids in per_local:
        for b in np.unique(bucket_ids):
            b = int(b)
            assert b in mine, (b, sorted(mine))
            rows = np.flatnonzero(bucket_ids == b)
            layout.write_batch(out / layout.bucket_file_name(b), dev_batch.take(rows),
                               sorted_by=["orderkey"], bucket=b)
            written.append(b)
    (out / f"counts-{pid}.json").write_text(json.dumps({
        "global_counts": [int(c) for c in global_counts], "buckets": sorted(written),
        "staged_bytes": fabric.mesh.staged_bytes}))
    print(f"proc {pid}: wrote {len(written)} bucket files", flush=True)
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
