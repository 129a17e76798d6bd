"""The index-build kernel: hash-bucketize + per-bucket sort on the device.

Counterpart of the single-device build in ``hyperspace_tpu.ops.build``
(``build_partition_single`` with ``_single_perm_kernel_packed`` /
``_single_perm_kernel``). Those are XLA programs, not Pallas kernels, so
torch ops carry them here:

* bucket ids: the murmur3-fmix32 mix of ops.hashing in int64 lanes;
* ordering: a stable sort by (bucket, key...) with the input position as
  the final tie-break — when the keys and the bucket id fit one 63-bit
  composite, ONE stable ``torch.sort`` of the packed composite; otherwise
  successive stable sorts from the last key to the bucket (least to most
  significant), which is the same lexicographic order;
* per-bucket counts: ``torch.bincount``.

Only key columns move to the device and only the int64 permutation and
the counts come back; the host applies one gather to the batch it already
holds. The permutation is exactly the reference's: its ``lax.sort`` keyed
on (bucket, keys..., iota) and a stable sort give the same order, and
float keys compare through the same ordered-int encodings (-0.0 == +0.0).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

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


def build_partition_single(
    batch: ColumnarBatch,
    key_names: List[str],
    num_buckets: int,
    device: DeviceLike = None,
) -> Tuple[ColumnarBatch, np.ndarray]:
    """Returns the batch reordered so rows are grouped by bucket
    (ascending) and sorted by the key columns within each bucket, plus
    per-bucket row counts. Bucketize and sort run on ``device``."""
    from ..telemetry.metrics import metrics

    dev = resolve_device(device)
    dtypes = batch.schema()
    n = batch.num_rows
    host_bufs = {k: encode_for_device(batch.columns[k]) for k in key_names}
    arrays = {
        k: torch.from_numpy(np.require(b, requirements=["C", "W"])).to(dev)
        for k, b in host_bufs.items()
    }
    vh = {
        k: torch.from_numpy(vocab_hashes(batch.columns[k])).to(dev)
        for k in key_names
        if is_string(dtypes[k])
    }
    if n == 0:
        return batch, np.zeros(num_buckets, dtype=np.int64)
    bucket = device_bucket_ids(arrays, dtypes, list(key_names), vh, num_buckets)
    bounds = [_packed_minmax(host_bufs[k]) for k in key_names]
    plan = (
        _pack_plan(bounds, max(int(num_buckets), 1).bit_length())
        if all(b is not None for b in bounds)
        else None
    )
    if plan is not None:
        metrics.incr("build.engine.device_radix")
        perm_dev = _single_perm_kernel_packed(arrays, bucket, list(key_names), plan)
    else:
        metrics.incr("build.engine.device_sortfull")
        perm_dev = _single_perm_kernel(arrays, bucket, list(key_names))
    counts = torch.bincount(bucket, minlength=num_buckets)[:num_buckets]
    perm = perm_dev.cpu().numpy()
    counts = counts.cpu().numpy().astype(np.int64)
    out = batch.take(perm)
    for name, col in out.columns.items():
        if col.dtype_str == "float64":
            # the reference's f64 transport encoding canonicalizes -0.0
            out.columns[name] = Column(
                col.dtype_str,
                np.where(col.data == 0.0, 0.0, col.data),
                col.vocab,
            )
    return out, counts


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
