"""Canonical row hashing for bucket assignment — host/device parity.

A copy of ``hyperspace_tpu.ops.hashing`` whose device twin runs in torch.
The contract: the bucket of a row depends only on the *values* of its
indexed columns, is stable across processes, batches, devices and the two
packages, and is computable identically on the host (numpy) and the
device (torch). Build-time and query-time hashing must agree, or bucketed
joins silently break.

Scheme:
* every indexed column is first reduced to an int64 **key representation**:
  - integers/dates: the value itself;
  - float32: IEEE bit pattern (bitcast) with -0.0 normalized to +0.0;
  - float64: the order-preserving int64 encoding of ops.floatbits,
    -0.0 normalized;
  - bools: 0/1;
  - strings: FNV-1a 64-bit hash of the UTF-8 bytes, computed once per
    dictionary entry and gathered through the codes;
* the int64 reprs are mixed into one uint32 via murmur3 finalizers over
  the two 32-bit halves, folding columns left-to-right;
* bucket = mix mod num_buckets.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from ..exceptions import HyperspaceException
from ..storage.columnar import Column, is_string

FNV_OFFSET = np.uint64(0xCBF29CE484222325)
FNV_PRIME = np.uint64(0x100000001B3)
SEED = np.uint32(0x9E3779B9)


def fnv1a64(data: bytes) -> np.uint64:
    """Stable 64-bit FNV-1a over bytes (vocab entries are short; this runs
    once per dictionary entry, not per row)."""
    h = FNV_OFFSET
    for b in data:
        h = np.uint64((int(h) ^ b) * int(FNV_PRIME) & 0xFFFFFFFFFFFFFFFF)
    return h


def key_repr(col: Column) -> np.ndarray:
    """Reduce a column to its int64 key representation (host side)."""
    if is_string(col.dtype_str):
        vocab_hash = np.array(
            [fnv1a64(v) for v in col.vocab], dtype=np.uint64
        ).astype(np.int64)
        out = np.full(len(col.data), -1, dtype=np.int64)  # NULL repr
        valid = col.data >= 0
        if vocab_hash.size:
            out[valid] = vocab_hash[col.data[valid]]
        return out
    d = col.data
    if d.dtype == np.float64:
        # order-preserving encoding: doubles as device transport format
        from .floatbits import f64_to_ordered_i64

        return f64_to_ordered_i64(d)
    if d.dtype == np.float32:
        d = np.where(d == 0.0, 0.0, d)  # -0.0 -> +0.0
        return d.view(np.int32).astype(np.int64)
    if d.dtype == np.bool_:
        return d.astype(np.int64)
    if d.dtype.kind in ("i", "u"):
        return d.astype(np.int64)
    raise HyperspaceException(f"Cannot hash dtype {d.dtype}.")


# -- murmur3 fmix32, expressed once for numpy and once for torch -------------
def scalar_key_repr(value, dtype_str: str) -> np.int64:
    """Key representation of a single literal, matching key_repr on a
    column holding that value (used to compute the bucket of a lookup key
    without materializing a column)."""
    if dtype_str == "string":
        v = value.encode() if isinstance(value, str) else bytes(value)
        return np.uint64(fnv1a64(v)).astype(np.int64)
    if dtype_str == "float32":
        f = np.float32(0.0 if value == 0.0 else value)
        return np.int64(f.view(np.int32))
    if dtype_str == "float64":
        from .floatbits import f64_scalar_to_ordered

        return f64_scalar_to_ordered(value)
    if dtype_str == "bool":
        return np.int64(bool(value))
    return np.int64(value)


def bucket_of_values(values, dtype_strs, num_buckets: int) -> int:
    """Bucket id of one row of indexed-column literals."""
    reprs = [
        np.array([scalar_key_repr(v, dt)], dtype=np.int64)
        for v, dt in zip(values, dtype_strs)
    ]
    # hslint: disable=HS001 - bucket_ids_host is the host lane by name and contract
    return int(bucket_ids_host(reprs, num_buckets)[0])


def _fmix32_np(h: np.ndarray) -> np.ndarray:
    h = h.astype(np.uint32)
    h ^= h >> np.uint32(16)
    h = (h * np.uint32(0x85EBCA6B)).astype(np.uint32)
    h ^= h >> np.uint32(13)
    h = (h * np.uint32(0xC2B2AE35)).astype(np.uint32)
    h ^= h >> np.uint32(16)
    return h


def hash32_host(key_reprs: Sequence[np.ndarray]) -> np.ndarray:
    """Combine int64 key reprs into one uint32 per row (numpy)."""
    if not key_reprs:
        raise HyperspaceException("hash32 of zero columns.")
    n = len(key_reprs[0])
    h = np.full(n, SEED, dtype=np.uint32)
    with np.errstate(over="ignore"):
        for kr in key_reprs:
            u = kr.view(np.uint64) if kr.dtype == np.int64 else kr.astype(np.uint64)
            lo = (u & np.uint64(0xFFFFFFFF)).astype(np.uint32)
            hi = (u >> np.uint64(32)).astype(np.uint32)
            h = _fmix32_np(h ^ _fmix32_np(lo ^ _fmix32_np(hi)))
    return h


def bucket_ids_host(key_reprs: Sequence[np.ndarray], num_buckets: int) -> np.ndarray:
    return (hash32_host(key_reprs) % np.uint32(num_buckets)).astype(np.int32)


# -- device twins (torch). Torch has no unsigned 32-bit arithmetic on every
# backend (no uint32 ``>>`` or ``%`` on the CPU), so the mixing runs in
# int64 lanes holding values in [0, 2^32): the low 32 bits of an int64
# product equal the uint32 product, so masking with 0xFFFFFFFF after each
# multiply reproduces the uint32 arithmetic bit for bit.
_M32 = 0xFFFFFFFF


def _fmix32_torch(h):
    h = h ^ (h >> 16)
    h = (h * 0x85EBCA6B) & _M32
    h = h ^ (h >> 13)
    h = (h * 0xC2B2AE35) & _M32
    h = h ^ (h >> 16)
    return h


def hash32_device(key_reprs: List):
    """Device twin of hash32_host over int64 torch tensors (the key
    reprs). Returns int64 values in [0, 2^32) equal to the host uint32
    hashes."""
    import torch

    if not key_reprs:
        raise HyperspaceException("hash32 of zero columns.")
    h = torch.full(
        key_reprs[0].shape, int(SEED), dtype=torch.int64, device=key_reprs[0].device
    )
    for kr in key_reprs:
        kr = kr.to(torch.int64)
        # halves by mask, not by >> 32 alone: torch's >> on a negative
        # int64 is an arithmetic shift
        lo = kr & _M32
        hi = (kr >> 32) & _M32
        h = _fmix32_torch(h ^ _fmix32_torch(lo ^ _fmix32_torch(hi)))
    return h
