"""The index-build device programs: hash-bucketize + per-bucket sort on the
card, the streaming build's staged chunk sort and on-card run merge, and
the host engine that computes the same orders with numpy.

Counterpart of ``hyperspace_tpu.ops.build`` (its single-device arms:
``build_partition_single`` with ``_single_perm_kernel_packed`` /
``_single_perm_kernel``, the staged ``_single_staged_kernel_packed`` and
``_staged_merge_fn``, ``build_partition_host(_parallel)``). Those are XLA
programs, not Pallas kernels, so torch ops carry them here:

* bucket ids: the murmur3-fmix32 mix of ops.hashing in int64 lanes;
* ordering: a stable sort by (bucket, key...) with the input position as
  the final tie-break — when the keys and the bucket id fit one 63-bit
  composite, ONE stable ``torch.sort`` of the packed composite; otherwise
  successive stable sorts from the last key to the bucket (least to most
  significant), which is the same lexicographic order;
* per-bucket counts: ``torch.bincount``;
* the staged run merge: each chunk's sorted composite re-packed on the
  run's plan, then a pairwise ``torch.searchsorted`` tournament (the left
  run wins ties) scattered with ``index_put_``.

Only key columns move to the device and only an int32/int64 order and the
counts come back; the host applies one gather to the rows it already
holds. The orders are exactly the reference's: its ``lax.sort`` keyed on
(bucket, keys..., iota) and a stable sort give the same order, and float
keys compare through the same ordered-int encodings (-0.0 == +0.0).

Device work may be queued on a caller's CUDA stream (the streaming
writer's own), and results come back through ``DeviceFetch``: pinned host
buffers filled by non-blocking copies and an event recorded after them,
so a spill worker thread waits on that event and nothing else.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..exceptions import HyperspaceException
from ..storage.columnar import Column, ColumnarBatch, is_string
from . import DeviceLike, resolve_device
from .hashing import fnv1a64, hash32_device


# ---------------------------------------------------------------------------
# device-side key representation (twin of hashing.key_repr)
# ---------------------------------------------------------------------------
def vocab_hashes(col: Column) -> Optional[np.ndarray]:
    """Per-dictionary-entry FNV hashes for a string column (host, O(vocab));
    gathered on device through the codes."""
    if not is_string(col.dtype_str):
        return None
    return np.array([fnv1a64(v) for v in col.vocab], dtype=np.uint64).astype(np.int64)


def key_repr_device(arr: torch.Tensor, dtype_str: str, vhash=None) -> torch.Tensor:
    """int64 key representation on device (twin of hashing.key_repr).
    float64 columns arrive already encoded as ordered int64 (the transport
    format, ops.floatbits): their repr is the identity."""
    if is_string(dtype_str):
        if vhash is None:
            raise HyperspaceException("String key column needs vocab hashes.")
        n_v = int(vhash.shape[0])
        if not n_v:
            return torch.full_like(arr, -1, dtype=torch.int64)
        gathered = vhash[arr.clamp(0, n_v - 1).long()]
        return torch.where(arr >= 0, gathered, torch.full_like(gathered, -1))
    if dtype_str == "float64":
        if arr.dtype != torch.int64:
            raise HyperspaceException(
                "float64 must be pre-encoded to ordered int64 before device "
                "transport (ops.floatbits)."
            )
        return arr
    if dtype_str == "float32":
        a = torch.where(arr == 0.0, torch.zeros_like(arr), arr)
        return a.view(torch.int32).to(torch.int64)
    return arr.to(torch.int64)


def encode_for_device(col: Column) -> np.ndarray:
    """Host buffer in device transport encoding (float64 → ordered int64;
    everything else raw). Same encoding ColumnarBatch.device_arrays applies."""
    if col.dtype_str == "float64":
        from .floatbits import f64_to_ordered_i64

        return f64_to_ordered_i64(col.data)
    return col.data


def device_bucket_ids(
    arrays: Dict[str, torch.Tensor],
    dtypes: Dict[str, str],
    key_names: List[str],
    vhashes: Dict[str, torch.Tensor],
    num_buckets: int,
) -> torch.Tensor:
    reprs = [
        key_repr_device(arrays[k], dtypes[k], vhashes.get(k)) for k in key_names
    ]
    return hash32_device(reprs) % int(num_buckets)


def _ordered_sort_operand(x: torch.Tensor) -> torch.Tensor:
    """Order-preserving integer view of a float sort operand, matching
    ops.floatbits' host encodings bit for bit (including the -0.0
    canonicalization, so -0.0 and +0.0 are equal ties kept in input
    order). Integers pass through."""
    if x.dtype == torch.float32:
        x = torch.where(x == 0.0, torch.zeros_like(x), x)
        bits = x.view(torch.int32)
        return torch.where(bits < 0, (~bits) ^ torch.tensor(-(2**31), dtype=torch.int32, device=x.device), bits)
    if x.dtype == torch.float64:
        x = torch.where(x == 0.0, torch.zeros_like(x), x)
        bits = x.view(torch.int64)
        return torch.where(bits < 0, (~bits) ^ torch.tensor(-(2**63), dtype=torch.int64, device=x.device), bits)
    return x


def _packed_minmax(arr: np.ndarray) -> Optional[Tuple[int, int]]:
    """(min, max) of a key's transport buffer as Python ints, or None for
    shapes the packed sort declines: floats (their sort operand is a bit
    transform) and uint64 values beyond int64."""
    if arr.dtype == np.float32 or arr.dtype == np.float64:
        return None
    if arr.size == 0:
        return None
    mn, mx = int(arr.min()), int(arr.max())
    if mx > (1 << 63) - 1 or mn < -(1 << 63):
        return None
    return mn, mx


def _pack_plan(
    bounds: List[Tuple[int, int]], bucket_bits: int
) -> Optional[List[Tuple[int, int]]]:
    """[(min, bits)] per key for the (bucket, keys...) radix pack, or None
    when ``bucket_bits`` plus the key widths don't fit 63 bits (the rule
    of the reference's ``_pack_plan``)."""
    total_bits = bucket_bits
    plan: List[Tuple[int, int]] = []
    for mn, mx in bounds:
        kb = max(mx - mn, 1).bit_length()
        total_bits += kb
        if total_bits > 63:
            return None
        plan.append((mn, kb))
    return plan


def _single_perm_kernel_packed(
    arrays: Dict[str, torch.Tensor],
    bucket: torch.Tensor,
    key_names: List[str],
    plan: List[Tuple[int, int]],
) -> torch.Tensor:
    """Permutation of ONE stable sort of the bit-packed composite
    (bucket, key1-min1, key2-min2, ...): the pack is order-preserving and
    a stable sort breaks ties by input position, as the reference's iota
    operand does."""
    packed = bucket.to(torch.int64)
    for k, (mn, kb) in zip(key_names, plan):
        enc = _ordered_sort_operand(arrays[k]).to(torch.int64)
        packed = (packed << kb) | (enc - mn)
    return torch.sort(packed, stable=True).indices


def _single_perm_kernel(
    arrays: Dict[str, torch.Tensor],
    bucket: torch.Tensor,
    key_names: List[str],
) -> torch.Tensor:
    """Permutation of the lexicographic (bucket, keys..., position) order
    by successive stable sorts, least significant key first."""
    n = bucket.shape[0]
    perm = torch.arange(n, dtype=torch.int64, device=bucket.device)
    for k in reversed(key_names):
        op = _ordered_sort_operand(arrays[k])[perm]
        perm = perm[torch.sort(op, stable=True).indices]
    perm = perm[torch.sort(bucket[perm], stable=True).indices]
    return perm


class DeviceFetch:
    """Device tensors on their way to the host. On a CUDA device the copies
    go into pinned host buffers with ``non_blocking=True`` on the source
    device's current stream, and an event is recorded after them there; ``wait()`` blocks on that
    event alone, from any thread, then hands back numpy views. Reading the
    buffers before the event would give stale rows and no error. On the
    CPU the tensors are the host arrays already."""

    __slots__ = ("_src", "_host", "_event")

    def __init__(self, tensors: Sequence[torch.Tensor]):
        self._src = list(tensors)  # alive until the copies complete
        if self._src and self._src[0].device.type == "cuda":
            self._host = [
                torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                for t in self._src
            ]
            for h, t in zip(self._host, self._src):
                h.copy_(t, non_blocking=True)
            # the copies ran on the source device's current stream, which
            # need not be the current device's
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(self._src[0].device))
        else:
            self._host = self._src
            self._event = None

    def wait(self) -> List[np.ndarray]:
        if self._event is not None:
            self._event.synchronize()
        self._src = []
        return [h.numpy() for h in self._host]


def on_stream(stream: Optional["torch.cuda.Stream"]):
    """Queue the enclosed device work on ``stream`` (None: the current
    stream; always None on the CPU)."""
    if stream is None:
        return contextlib.nullcontext()
    return torch.cuda.stream(stream)


def _to_device(buf, dev: torch.device) -> torch.Tensor:
    """A host buffer (numpy, or a pinned tensor of the writer's slab pair)
    on ``dev``. A pinned source copies asynchronously; its slot must not be
    refilled before an event recorded after the copy has completed."""
    if not isinstance(buf, torch.Tensor):
        buf = torch.from_numpy(np.require(buf, requirements=["C", "W"]))
    return buf.to(dev, non_blocking=buf.is_pinned())


def build_partition_single(
    batch: ColumnarBatch,
    key_names: List[str],
    num_buckets: int,
    device: DeviceLike = None,
    defer: bool = False,
    stream: Optional["torch.cuda.Stream"] = None,
):
    """Returns the batch reordered so rows are grouped by bucket
    (ascending) and sorted by the key columns within each bucket, plus
    per-bucket row counts. Bucketize and sort run on ``device``.

    ``defer=True`` returns a zero-arg ``finish()`` instead: the device work
    is queued (on ``stream`` when given) with its D2H in flight, and
    ``finish`` waits for the copy and gathers the rows on the host — the
    streaming writer calls it on a spill thread, so the copy overlaps the
    next chunk's dispatch."""
    from ..telemetry.metrics import metrics

    dev = resolve_device(device)
    dtypes = batch.schema()
    n = batch.num_rows
    if n == 0:
        empty = (batch, np.zeros(num_buckets, dtype=np.int64))
        return (lambda: empty) if defer else empty
    host_bufs = {k: encode_for_device(batch.columns[k]) for k in key_names}
    bounds = [_packed_minmax(host_bufs[k]) for k in key_names]
    plan = (
        _pack_plan(bounds, max(int(num_buckets), 1).bit_length())
        if all(b is not None for b in bounds)
        else None
    )
    with on_stream(stream):
        arrays = {k: _to_device(b, dev) for k, b in host_bufs.items()}
        vh = {
            k: torch.from_numpy(vocab_hashes(batch.columns[k])).to(dev)
            for k in key_names
            if is_string(dtypes[k])
        }
        if defer:
            metrics.incr(
                "build.stream.h2d_bytes",
                sum(int(b.nbytes) for b in host_bufs.values()),
            )
        bucket = device_bucket_ids(arrays, dtypes, list(key_names), vh, num_buckets)
        if plan is not None:
            metrics.incr("build.engine.device_radix")
            perm_dev = _single_perm_kernel_packed(
                arrays, bucket, list(key_names), plan
            )
        else:
            metrics.incr("build.engine.device_sortfull")
            perm_dev = _single_perm_kernel(arrays, bucket, list(key_names))
        counts_dev = torch.bincount(bucket, minlength=num_buckets)[:num_buckets]
        fetch = DeviceFetch([perm_dev, counts_dev])

    def finish() -> Tuple[ColumnarBatch, np.ndarray]:
        perm, counts = fetch.wait()
        if defer:
            # one blocking round trip per chunk: the call count the staged
            # run merge divides by runChunks
            metrics.incr("build.stream.d2h_calls")
            metrics.incr("build.stream.d2h_bytes", 8 * n + 8 * num_buckets)
        out = batch.take(perm.astype(np.int64, copy=False))
        _canonicalize_f64(out)
        return out, counts.astype(np.int64, copy=False)

    return finish if defer else finish()


# ---------------------------------------------------------------------------
# device-resident run staging (the streaming build's device engine)
# ---------------------------------------------------------------------------
def _single_staged_kernel_packed(
    arrays: Dict[str, torch.Tensor],
    dtypes: Dict[str, str],
    key_names: List[str],
    num_buckets: int,
    plan: List[Tuple[int, int]],
):
    """Run-staging twin of _single_perm_kernel_packed: the same bucketize +
    radix pack + ONE stable sort, but the sorted packed composite stays on
    the device beside the permutation — the merge operand of the on-card
    run merge. Staged chunks are always full (the tail routes per chunk),
    so every row is real. Returns (sorted composite, permutation, counts)."""
    bucket = device_bucket_ids(arrays, dtypes, key_names, {}, num_buckets)
    packed = bucket.to(torch.int64)
    for k, (mn, kb) in zip(key_names, plan):
        enc = _ordered_sort_operand(arrays[k]).to(torch.int64)
        packed = (packed << kb) | (enc - mn)
    packed_sorted, perm = torch.sort(packed, stable=True)
    counts = torch.bincount(bucket, minlength=num_buckets)
    return packed_sorted, perm, counts


def _staged_merge(
    staged: List["StagedChunk"], run_plan: List[Tuple[int, int]]
) -> torch.Tensor:
    """The on-card k-way run merge: each staged chunk's sorted composite
    (packed with its own chunk plan) is unpacked with the chunk's mins and
    shifts and re-packed on the run's plan — an order-preserving change of
    field offsets, so each chunk stays sorted — then the chunks merge by
    the stable pairwise searchsorted tournament of the host's
    ``merge_sorted_orders`` (adjacent pairs, the left run wins ties).
    Returns the run's row order into the R concatenated chunks, int32 (the
    reference's transport width: R x capacity stays under 2^31)."""
    cap = int(staged[0].packed.shape[0])
    runs = []
    for c, s in enumerate(staged):
        rem = s.packed
        fields = []
        for mn, kb in reversed(s.plan):
            # masks from Python ints: a shift of 63 stays exact
            fields.append((rem & ((1 << kb) - 1)) + mn)
            rem = rem >> kb
        fields.reverse()
        comp = rem  # what remains above the key fields is the bucket id
        for (mn, kb), f in zip(run_plan, fields):
            comp = (comp << kb) | (f - mn)
        runs.append((comp, (s.perm + c * cap).to(torch.int32)))
    while len(runs) > 1:
        nxt = []
        for j in range(0, len(runs) - 1, 2):
            (ak, ai), (bk, bi) = runs[j], runs[j + 1]
            dev = ak.device
            # merged position of a[x] = x + |b strictly before a[x]|; of
            # b[y] = y + |a at or before b[y]| (ties: a first)
            pos_a = torch.arange(ak.shape[0], device=dev) + torch.searchsorted(
                bk, ak, right=False
            )
            pos_b = torch.arange(bk.shape[0], device=dev) + torch.searchsorted(
                ak, bk, right=True
            )
            mk = torch.empty(ak.shape[0] + bk.shape[0], dtype=ak.dtype, device=dev)
            mi = torch.empty(ak.shape[0] + bk.shape[0], dtype=ai.dtype, device=dev)
            mk.index_put_((pos_a,), ak)
            mk.index_put_((pos_b,), bk)
            mi.index_put_((pos_a,), ai)
            mi.index_put_((pos_b,), bi)
            nxt.append((mk, mi))
        if len(runs) % 2:
            nxt.append(runs[-1])
        runs = nxt
    return runs[0][1]


class StagedChunk:
    """One device-resident sorted chunk awaiting its run merge: the packed
    composite, permutation and counts stay on the card; the host keeps the
    pack plan (the merge's unpack operands). The device footprint is
    charged up front by the writer's all-or-nothing reservation
    (residency.slabs)."""

    __slots__ = ("packed", "perm", "counts", "plan")

    def __init__(self, packed, perm, counts, plan):
        self.packed = packed
        self.perm = perm
        self.counts = counts
        self.plan = plan


def stage_encode(
    batch: ColumnarBatch, key_names: List[str]
) -> Tuple[Dict[str, np.ndarray], Optional[List[Tuple[int, int]]]]:
    """Host transport buffers + per-key (min, max) bounds of a full chunk —
    the staged path's routing input, computed before any upload so an
    ineligible chunk never touches the device. ``bounds`` is None when a
    key declines the 63-bit pack (floats, uint64 beyond int64)."""
    encoded = {k: encode_for_device(batch.columns[k]) for k in key_names}
    bounds = []
    for k in key_names:
        b = _packed_minmax(encoded[k])
        if b is None:
            return encoded, None
        bounds.append(b)
    return encoded, bounds


def run_pack_plan(
    bounds: List[Tuple[int, int]], num_buckets: int
) -> Optional[List[Tuple[int, int]]]:
    """The run-level pack plan over accumulated per-chunk bound unions —
    the same budget rule and bucket ceiling as the per-chunk sort, so chunk
    and run composites share one field layout. None: the union overflows
    63 bits and the pending run must flush first."""
    return _pack_plan(bounds, max(int(num_buckets), 1).bit_length())


def stage_chunk_packed(
    host_bufs: Dict[str, object],
    dtypes: Dict[str, str],
    key_names: List[str],
    num_buckets: int,
    plan: List[Tuple[int, int]],
    device: DeviceLike = None,
    stream: Optional["torch.cuda.Stream"] = None,
) -> Tuple[StagedChunk, int]:
    """Upload one full chunk's key buffers (the writer's pinned slab slot,
    or the chunk's own encoded arrays) and leave its sorted composite,
    permutation and counts on the device. Returns the staged handle and
    the H2D byte count. The caller guarantees: no string keys, a full
    chunk, ``plan`` fits 63 bits."""
    from ..telemetry.metrics import metrics

    dev = resolve_device(device)
    with on_stream(stream):
        arrays = {k: _to_device(host_bufs[k], dev) for k in key_names}
        metrics.incr("build.engine.device_radix")
        packed, perm, counts = _single_staged_kernel_packed(
            arrays, dtypes, list(key_names), num_buckets, plan
        )
    h2d_bytes = sum(int(a.nbytes) for a in arrays.values())
    return StagedChunk(packed, perm, counts, plan), h2d_bytes


def merge_staged_chunks(
    staged: List[StagedChunk],
    run_plan: List[Tuple[int, int]],
    num_buckets: int,
    stream: Optional["torch.cuda.Stream"] = None,
) -> DeviceFetch:
    """Queue the on-card merge of R staged chunks into one sorted run and
    its non-blocking D2H. Returns the fetch of (order, counts): the order
    indexes the concatenation of the R original chunks, int32; the counts
    are the per-bucket sums."""
    with on_stream(stream):
        order = _staged_merge(staged, run_plan)
        counts = torch.stack([s.counts[:num_buckets] for s in staged]).sum(0)
        return DeviceFetch([order, counts])


# ---------------------------------------------------------------------------
# host merge of key-sorted runs (optimize's per-bucket merge)
# ---------------------------------------------------------------------------
def _pack_sort_keys(
    encs: List[np.ndarray],
    bucket: Optional[np.ndarray],
    num_buckets: int,
) -> Optional[np.ndarray]:
    """Bit-pack (bucket?, enc1-min1, enc2-min2, ...) into one int64 whose
    ascending order equals the lexicographic order of the inputs, or None
    when the widths don't fit 63 bits (the caller then lexsorts). The
    budget rule is ``_pack_plan``'s, shared with the device build."""
    if not encs or not len(encs[0]):
        return None
    bounds = []
    i64_max, i64_min = (1 << 63) - 1, -(1 << 63)
    for e in encs:
        mn = int(e.min())
        mx = int(e.max())
        if mx > i64_max or mn < i64_min:
            return None  # uint64 beyond int64: the bias cast would raise
        bounds.append((mn, mx))
    bucket_bits = (
        max(int(num_buckets - 1), 1).bit_length() if bucket is not None else 0
    )
    plan = _pack_plan(bounds, bucket_bits)
    if plan is None:
        return None
    comp = (
        bucket.astype(np.int64)
        if bucket is not None
        else np.zeros(len(encs[0]), dtype=np.int64)
    )
    for e, (mn, kb) in zip(encs, plan):
        comp = (comp << np.int64(kb)) | (e.astype(np.int64) - np.int64(mn))
    return comp


def merge_sorted_orders(
    runs: List[Tuple[np.ndarray, np.ndarray]],
) -> np.ndarray:
    """Merge per-run (sorted_keys, row_indices) pairs into one global
    row-index order, stably: ties keep run order (run i's rows before run
    j's for i < j), exactly like a stable argsort over the concatenation.
    A pairwise searchsorted tournament: each pass is a few vectorized
    binary-search merges instead of a full re-sort."""
    runs = [r for r in runs if len(r[1])]
    if not runs:
        return np.empty(0, dtype=np.int64)
    while len(runs) > 1:
        nxt: List[Tuple[np.ndarray, np.ndarray]] = []
        # adjacent pairs only: merging (0,1),(2,3)... keeps the global run
        # order that makes the merge stable
        for i in range(0, len(runs) - 1, 2):
            (ak, ai), (bk, bi) = runs[i], runs[i + 1]
            la, lb = len(ak), len(bk)
            # merged position of a[x] = x + |b strictly before a[x]|;
            # of b[y] = y + |a at-or-before b[y]| (ties: a first)
            pos_a = np.arange(la, dtype=np.int64) + np.searchsorted(
                bk, ak, side="left"
            )
            pos_b = np.arange(lb, dtype=np.int64) + np.searchsorted(
                ak, bk, side="right"
            )
            mk = np.empty(la + lb, dtype=ak.dtype)
            mi = np.empty(la + lb, dtype=np.int64)
            mk[pos_a] = ak
            mk[pos_b] = bk
            mi[pos_a] = ai
            mi[pos_b] = bi
            nxt.append((mk, mi))
        if len(runs) % 2:
            nxt.append(runs[-1])
        runs = nxt
    return np.asarray(runs[0][1], dtype=np.int64)


def build_partition_host(
    batch: ColumnarBatch,
    key_names: List[str],
    num_buckets: int,
) -> Tuple[ColumnarBatch, np.ndarray]:
    """Host twin of build_partition_single: the same hash, the same
    (bucket, keys...) order and the same stable tie-break, computed with
    numpy — one stable argsort of the packed composite when it fits 63
    bits, a lexsort otherwise. The streaming build's ``host`` engine, and
    the in-memory build's with ``engine=host``."""
    from ..index.stream_builder import sort_encoding
    from .hashing import bucket_ids_host, key_repr

    bucket = bucket_ids_host(
        [key_repr(batch.columns[k]) for k in key_names], num_buckets
    )
    encs = [sort_encoding(batch.columns[k]) for k in key_names]
    order = None
    comp = _pack_sort_keys(encs, bucket, num_buckets)
    if comp is not None:
        order = np.argsort(comp, kind="stable")
    if order is None:
        order = np.lexsort(tuple(reversed(encs)) + (bucket,))
    counts = np.bincount(bucket, minlength=num_buckets).astype(np.int64)
    out = batch.take(order)
    _canonicalize_f64(out)
    return out, counts


def _canonicalize_f64(out: ColumnarBatch) -> None:
    """-0.0 → +0.0 on float64 columns, matching the device transport
    encoding (ops.floatbits): every engine writes the same bytes."""
    for name, col in out.columns.items():
        if col.dtype_str == "float64":
            out.columns[name] = Column(
                col.dtype_str, np.where(col.data == 0.0, 0.0, col.data), col.vocab
            )


# Below this many rows the slice/merge machinery costs more than the one
# stable argsort it replaces; the serial twin handles small batches.
HOST_PARALLEL_MIN_ROWS = 1 << 16


def build_partition_host_parallel(
    batch: ColumnarBatch,
    key_names: List[str],
    num_buckets: int,
    workers: int,
) -> Tuple[ColumnarBatch, np.ndarray]:
    """Multi-core twin of build_partition_host with identical output: rows
    split into contiguous slices, each stable-argsorted on its own thread
    (numpy's sort releases the GIL), then merged by the stable
    searchsorted tournament — contiguous slices and left-run-wins ties
    reproduce the serial stable argsort. Shapes the composite cannot pack
    take the serial twin."""
    n = batch.num_rows
    if workers <= 1 or n < HOST_PARALLEL_MIN_ROWS:
        return build_partition_host(batch, key_names, num_buckets)
    from ..index.stream_builder import sort_encoding
    from ..parallel.pool import run_parallel
    from ..telemetry.metrics import metrics
    from .hashing import bucket_ids_host, key_repr

    bucket = bucket_ids_host(
        [key_repr(batch.columns[k]) for k in key_names], num_buckets
    )
    encs = [sort_encoding(batch.columns[k]) for k in key_names]
    comp = _pack_sort_keys(encs, bucket, num_buckets)
    if comp is None:
        return build_partition_host(batch, key_names, num_buckets)
    workers = min(int(workers), max(n // HOST_PARALLEL_MIN_ROWS, 1))
    step = -(-n // workers)
    spans = [(s, min(s + step, n)) for s in range(0, n, step)]

    def slice_sort(span: Tuple[int, int]):
        s, e = span
        order = np.argsort(comp[s:e], kind="stable").astype(np.int64) + s
        return comp[order], order

    sorted_slices = run_parallel(
        [lambda sp=sp: slice_sort(sp) for sp in spans],
        workers,
        name="host-partition",
    )
    order = merge_sorted_orders(sorted_slices)
    counts = np.bincount(bucket, minlength=num_buckets).astype(np.int64)
    out = batch.take(order)
    _canonicalize_f64(out)
    metrics.incr("build.engine.host_parallel")
    return out, counts


# ---------------------------------------------------------------------------
# the sharded build (one controller, D shards, one all_to_all exchange)
# ---------------------------------------------------------------------------
def _exchange_cap(
    host_dest: np.ndarray, shard_rows: int, n: int, n_shards: int, D: int
) -> int:
    """Max rows any one source shard sends to any one destination shard:
    the all_to_all block capacity (the reference's rule, shared with its
    multihost packer)."""
    cap = 1
    for s in range(n_shards):
        seg = host_dest[s * shard_rows : min((s + 1) * shard_rows, n)]
        if seg.size:
            cap = max(cap, int(np.bincount(seg, minlength=D).max()))
    return cap


def scatter_blocks(
    planes: List[torch.Tensor], dest: torch.Tensor, D: int, cap: int
) -> List[torch.Tensor]:
    """Each plane's rows scattered into ``(D, cap)`` send blocks by
    destination shard, in row order within a destination (a stable sort
    of ``dest``), as the reference's ``.at[sorted_dest, pos].set(...,
    mode="drop")``: a row whose destination is ``D`` or beyond, or whose
    slot passes ``cap``, lands in a trash slot past the blocks. The last
    block returned is the validity plane (bool)."""
    dev = dest.device
    m = int(dest.shape[0])
    sorted_dest, perm = torch.sort(dest, stable=True)
    counts = torch.bincount(dest.clamp(0, D), minlength=D + 1)[:D]
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(m, dtype=torch.int64, device=dev) - starts[sorted_dest.clamp(0, D - 1)]
    ok = (sorted_dest < D) & (pos < cap)
    flat = torch.where(ok, sorted_dest * cap + pos, torch.full_like(pos, D * cap))
    out = []
    for x in list(planes) + [torch.ones(m, dtype=torch.bool, device=dev)]:
        buf = torch.zeros(D * cap + 1, dtype=x.dtype, device=dev)
        buf[flat] = x[perm]
        out.append(buf[: D * cap].view(D, cap))
    return out


def _receive_plan(bounds, n_rows: int, num_buckets: int):
    """The receiving sort's radix pack over per-key ``bounds`` (None when
    a key declines packing, or there are no rows)."""
    if bounds is None or not n_rows:
        return None
    return _pack_plan(bounds, max(int(num_buckets), 1).bit_length())


def _scatter_sources(mesh, encoded, names, dtypes, key_names, vh_host, num_buckets: int,
                     D: int, cap: int, shard_rows: int, n: int) -> List[List[torch.Tensor]]:
    """Each of ``mesh``'s shards takes the rows ``[s * shard_rows, (s + 1) *
    shard_rows)`` of the host buffers: upload, bucketize (vocab hashes on
    every device), scatter every plane in transport encoding, then the
    bucket ids, into ``(D, cap)`` send blocks by owner (``scatter_blocks``:
    the validity plane last)."""
    from ..parallel.mesh import owner_of_bucket_device

    vh_on: Dict[torch.device, Dict[str, torch.Tensor]] = {}
    sends: List[List[torch.Tensor]] = []
    for s, dev in enumerate(mesh.devices):
        lo, hi = min(s * shard_rows, n), min((s + 1) * shard_rows, n)
        with mesh.scope(dev):
            arrays = {name: _to_device(encoded[name][lo:hi], dev) for name in names}
            if dev not in vh_on:
                vh_on[dev] = {k: torch.from_numpy(v).to(dev) for k, v in vh_host.items()}
            bucket = device_bucket_ids(arrays, dtypes, list(key_names), vh_on[dev],
                                       num_buckets)
            dest = owner_of_bucket_device(bucket, D)
            planes = [arrays[name] for name in names] + [bucket.to(torch.int32)]
            sends.append(scatter_blocks(planes, dest, D, cap))
        del arrays
    return sends


def _exchange_planes(sends: List[List[torch.Tensor]], exchange) -> List[List[torch.Tensor]]:
    """The exchange, plane by plane (``exchange`` maps one send block a
    source shard to one receive a destination shard); each plane's send
    blocks go once its receive is built."""
    recv: List[List[torch.Tensor]] = [[] for _ in sends]
    for p in range(len(sends[0])):
        got = exchange([sends[s][p] for s in range(len(sends))])
        for s in range(len(sends)):
            sends[s][p] = None
        for d in range(len(got)):
            recv[d].append(got[d])
    return recv


def _sort_received(planes: List[torch.Tensor], names, key_names, num_buckets: int, plan,
                   n_take: int) -> Tuple["DeviceFetch", torch.Tensor]:
    """One receiving shard: sort what it got by (bucket, keys...) with the
    single-device build's sort (its stable tie-break is the receive order:
    source shard, then row order), keep the ``n_take`` valid rows and send
    their planes and bucket ids home. Returns the fetch and the shard's
    per-bucket counts (on its device)."""
    valid = planes[-1]
    r_bucket = planes[-2].to(torch.int64)
    masked = torch.where(valid, r_bucket, torch.full_like(r_bucket, num_buckets))
    keys = {k: planes[names.index(k)] for k in key_names}
    if plan is not None:
        perm = _single_perm_kernel_packed(keys, masked, list(key_names), plan)
    else:
        perm = _single_perm_kernel(keys, masked, list(key_names))
    take = perm[: int(n_take)]
    counts = torch.bincount(masked, minlength=num_buckets + 1)[:num_buckets]
    fetch = DeviceFetch([planes[i][take] for i in range(len(names))] + [planes[-2][take]])
    return fetch, counts


def _fetched_batch(got: List[np.ndarray], names, dtypes, vocabs) -> Tuple[ColumnarBatch, np.ndarray]:
    from ..storage.columnar import decode_device_array

    cols = {
        name: Column(dtypes[name], decode_device_array(dtypes[name], got[i]), vocabs[name])
        for i, name in enumerate(names)
    }
    return ColumnarBatch(cols), got[-1]


def build_partition_sharded(
    batch: ColumnarBatch,
    key_names: List[str],
    num_buckets: int,
    mesh,
) -> Tuple[List[Tuple[ColumnarBatch, np.ndarray]], np.ndarray]:
    """The build over a mesh of D shards. Returns ``(per_shard,
    global_counts)``: ``per_shard[d]`` is the (batch, bucket ids) of the
    rows that landed on shard d, grouped by bucket and key-sorted, and
    ``global_counts[b]`` bucket b's row count. Shard d owns the buckets
    ``b % D == d``.

    Rows split into D contiguous source ranges of ``shard_rows``
    (``next_pow2``-quantized, as the reference's). Each source shard
    bucketizes its rows on its device (``device_bucket_ids``, vocab hashes
    on every device), scatters every plane in transport encoding into
    ``(D, cap)`` blocks by owner (``scatter_blocks``), and one
    ``all_to_all`` per plane moves them; each receiving shard then sorts
    what it got by (bucket, keys...) with the single-device build's sort
    (its stable tie-break: source shard, then row order, which is the
    input order), and its rows come home through pinned, non-blocking
    copies. Every shard is issued before the first wait. Within a bucket
    the rows are the single-device build's, so the index files are too."""
    from ..parallel.mesh import all_reduce, all_to_all, owner_of_bucket_array
    from ..utils.intmath import next_pow2
    from .hashing import bucket_ids_host, key_repr

    D = mesh.size
    n = batch.num_rows
    dtypes = batch.schema()
    names = list(batch.column_names)
    host_bucket = bucket_ids_host(
        [key_repr(batch.columns[k]) for k in key_names], num_buckets
    )
    host_dest = owner_of_bucket_array(host_bucket, D)
    shard_rows = next_pow2(max(-(-n // D), 1))
    cap = next_pow2(_exchange_cap(host_dest, shard_rows, n, D, D))
    recv_rows = np.bincount(host_dest, minlength=D).astype(np.int64)
    encoded = {name: encode_for_device(batch.columns[name]) for name in names}
    # the receiving sort's radix pack: bounds over every key value, and 0,
    # which the blocks' empty slots hold
    bounds = []
    for k in key_names:
        b = _packed_minmax(encoded[k])
        if b is None:
            bounds = None
            break
        bounds.append((min(b[0], 0), max(b[1], 0)))
    plan = _receive_plan(bounds, n, num_buckets)
    vh_host = {
        k: vocab_hashes(batch.columns[k]) for k in key_names if is_string(dtypes[k])
    }
    sends = _scatter_sources(mesh, encoded, names, dtypes, key_names, vh_host, num_buckets,
                             D, cap, shard_rows, n)
    recv = _exchange_planes(sends, lambda blocks: all_to_all(blocks, mesh))
    fetches, local_counts = [], []
    for d, dev in enumerate(mesh.devices):
        with mesh.scope(dev):
            f, c = _sort_received(recv[d], names, key_names, num_buckets, plan, recv_rows[d])
            fetches.append(f)
            local_counts.append(c)
        recv[d] = None
    with mesh.scope(mesh.devices[0]):
        counts_fetch = DeviceFetch([all_reduce(local_counts, "sum", mesh)[0]])
    # one wait per shard
    vocabs = {name: batch.columns[name].vocab for name in names}
    per_shard = [_fetched_batch(f.wait(), names, dtypes, vocabs) for f in fetches]
    global_counts = counts_fetch.wait()[0].astype(np.int64)
    if int(global_counts.sum()) != n:
        raise HyperspaceException(
            f"Shuffle lost rows: {int(global_counts.sum())} != {n}."
        )
    return per_shard, global_counts


# ---------------------------------------------------------------------------
# the multi-controller build (P processes, L shards each, one exchange)
# ---------------------------------------------------------------------------
def _fsync_path(path) -> None:
    import os

    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def unify_vocabs_shared_storage(
    local_batch: ColumnarBatch,
    scratch_dir,
    barrier,
    process_index: int,
    process_count: int,
    timeout_s: float = 30.0,
) -> ColumnarBatch:
    """Cross-process dictionary union over shared storage: every process
    writes its string columns' vocabs, a barrier orders the writes before
    any read, and each process re-encodes onto the union, so codes are
    comparable across processes and string columns cross the exchange as
    any integer column does. (Vocabs are ragged bytes, so they go through
    the index's shared storage rather than a collective.)

    ``barrier`` is a zero-argument callable that returns only once every
    process has entered it. Files are written under a temporary name,
    fsynced, renamed and their directory fsynced before the first barrier,
    so a peer's read after it cannot miss them under NFS-style caching;
    a read that still misses is retried until ``timeout_s``
    (``build.multihost.vocab_stale_retry``). A second barrier keeps every
    file in place until every process has read it, so a later build
    reusing the directory cannot race this one."""
    import pickle
    import time
    from pathlib import Path

    from ..telemetry.metrics import metrics

    names = [n for n, c in local_batch.columns.items() if c.vocab is not None]
    if not names:
        return local_batch
    scratch = Path(scratch_dir)
    scratch.mkdir(parents=True, exist_ok=True)
    payload = {n: local_batch.columns[n].vocab for n in names}
    tmp = scratch / f".vocab-{process_index:05d}.tmp"
    tmp.write_bytes(pickle.dumps(payload))
    _fsync_path(tmp)
    tmp.replace(scratch / f"vocab-{process_index:05d}.pkl")
    _fsync_path(scratch)
    barrier()  # every vocab file durable before anyone reads
    merged: Dict[str, list] = {}
    for p in range(process_count):
        path = scratch / f"vocab-{p:05d}.pkl"
        deadline = time.monotonic() + timeout_s
        while True:
            try:
                # the files are this build's own, written by its processes
                data = pickle.loads(path.read_bytes())
                metrics.incr("build.multihost.vocab_read")
                break
            except FileNotFoundError:
                if time.monotonic() >= deadline:
                    raise
                metrics.incr("build.multihost.vocab_stale_retry")
                time.sleep(0.05)
        for n, v in data.items():
            merged.setdefault(n, []).append(v)
    barrier()  # nobody overwrites these files until every process read them
    out = dict(local_batch.columns)
    for n in names:
        union = np.unique(np.concatenate(merged[n]))
        out[n] = local_batch.columns[n].reencode(union)
    return ColumnarBatch(out)


def build_partition_sharded_multihost(
    local_batch: ColumnarBatch,
    key_names: List[str],
    num_buckets: int,
    mesh,
    scratch_dir=None,
) -> Tuple[List[Tuple[ColumnarBatch, np.ndarray]], np.ndarray]:
    """The multi-controller twin of ``build_partition_sharded``: every
    process of the job calls it at once with its OWN rows (its share of
    the source files), over a ``parallel.mesh.ProcessMesh`` of D = P x L
    shards, and no ingest funnels through one host. Returns
    ``(per_local_shard, global_counts)``: this process's L shards' (batch,
    bucket ids), grouped by bucket and key-sorted (local slot order:
    global shard ``process_index * L + l``), and the global per-bucket
    counts, the same on every process.

    It runs the single-controller program on each local shard, with the
    group's collectives between them; where that program reads the whole
    table, the processes agree instead (``ProcessMesh.consensus``, small
    int64 all_reduces, recomputed per build: the reference's cache of
    jitted reducers has nothing to cache here):

    * ``shard_rows`` and the exchange's ``cap``: their MAX over the group;
    * each destination's received rows: the per-destination send counts
      summed over the group before the exchange;
    * the receiving sort's radix pack: each key's bounds, MIN and MAX over
      the group (a shard sorts rows other processes sent), and no pack
      when any process's keys decline it;
    * the global per-bucket counts, SUM over the group of what each
      receiving shard got valid (the validity plane), with the
      reference's "lost rows" check against the rows sent, and every
      shard's valid rows against its agreed receive count.

    The exchange concatenates what a shard receives in global source-shard
    order (process, then local shard), so the stable tie-break stays
    "source shard, then row order". String columns need ``scratch_dir`` on
    shared storage: the per-process dictionaries union there first
    (``unify_vocabs_shared_storage``)."""
    from ..parallel.mesh import owner_of_bucket_array
    from ..utils.intmath import next_pow2
    from .hashing import bucket_ids_host, key_repr

    L, D, P = mesh.local_size, mesh.size, mesh.process_count
    if any(c.vocab is not None for c in local_batch.columns.values()):
        if scratch_dir is None:
            raise HyperspaceException(
                "The multi-process build of string columns needs scratch_dir on "
                "shared storage for the cross-process vocab union."
            )
        local_batch = unify_vocabs_shared_storage(
            local_batch, scratch_dir, mesh.barrier, mesh.process_index, P)
    dtypes = local_batch.schema()
    names = list(local_batch.column_names)
    n_local = local_batch.num_rows
    shard_rows = next_pow2(mesh.consensus([max(-(-n_local // L), 1)], "max")[0])
    host_dest = owner_of_bucket_array(
        bucket_ids_host([key_repr(local_batch.columns[k]) for k in key_names], num_buckets), D)
    encoded = {name: encode_for_device(local_batch.columns[name]) for name in names}
    # per key: (min, max, declines) of the transport buffer, 0 included
    # (the blocks' empty slots hold it); an empty share brings (0, 0)
    lows, highs, declines = [], [], []
    for k in key_names:
        b = _packed_minmax(encoded[k])
        declines.append(int(b is None and encoded[k].size > 0))
        lo, hi = (0, 0) if b is None else b
        lows.append(min(lo, 0))
        highs.append(max(hi, 0))
    agreed = mesh.consensus(
        [_exchange_cap(host_dest, shard_rows, n_local, L, D)] + highs + declines, "max")
    cap = next_pow2(agreed[0])
    highs, declined = agreed[1:1 + len(key_names)], any(agreed[1 + len(key_names):])
    lows = mesh.consensus(lows, "min")
    sums = mesh.consensus([n_local] + np.bincount(host_dest, minlength=D).tolist(), "sum")
    n_global, recv_rows = sums[0], sums[1:]
    plan = _receive_plan(None if declined else list(zip(lows, highs)), n_global, num_buckets)
    vh_host = {
        k: vocab_hashes(local_batch.columns[k]) for k in key_names if is_string(dtypes[k])
    }
    local = mesh.local
    sends = _scatter_sources(local, encoded, names, dtypes, key_names, vh_host, num_buckets,
                             D, cap, shard_rows, n_local)
    try:
        recv = _exchange_planes(sends, mesh.all_to_all)
    finally:
        mesh.release_staging()
    fetches, count_fetches = [], []
    for l, (g, dev) in enumerate(zip(mesh.local_shards(), local.devices)):
        with local.scope(dev):
            f, c = _sort_received(recv[l], names, key_names, num_buckets, plan, recv_rows[g])
            fetches.append(f)
            count_fetches.append(DeviceFetch([c]))
        recv[l] = None
    vocabs = {name: local_batch.columns[name].vocab for name in names}
    per_local = [_fetched_batch(f.wait(), names, dtypes, vocabs) for f in fetches]
    # the valid rows each local shard received, by bucket (its masked
    # counts): a row the exchange dropped or sent astray shows here, where
    # the rows taken above (recv_rows, agreed before the exchange) cannot
    valid = [f.wait()[0].astype(np.int64) for f in count_fetches]
    astray = sum(int(v.sum()) != int(recv_rows[g]) for v, g in zip(valid, mesh.local_shards()))
    agreed = mesh.consensus(np.sum(valid, axis=0).tolist() + [astray], "sum")
    global_counts = np.asarray(agreed[:num_buckets], dtype=np.int64)
    if int(global_counts.sum()) != n_global or agreed[num_buckets]:
        raise HyperspaceException(
            f"Multihost shuffle lost rows: {int(global_counts.sum())} != {n_global}, "
            f"{agreed[num_buckets]} shards received other than their count."
        )
    return per_local, global_counts
