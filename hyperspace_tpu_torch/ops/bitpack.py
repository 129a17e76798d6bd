"""Bit-packed int32 planes for the compressed and streaming residency tiers.

Counterpart of ``hyperspace_tpu.ops.bitpack`` (its host side, and the
plain-pack device decode as a torch function). A resident predicate plane
costs one int32 lane per row even when its values need far fewer bits: a
1..50 quantity is 6 bits. The plain pack re-bases values to their minimum
(``ref0``, the frame of reference) and packs ``bits`` bits each into int32
words, straddle-free: ``vpw`` values a word, the largest power of two
with ``vpw * bits <= 32``, so every power-of-two grain (a block of 8192
rows, a streamed window) slices on word boundaries and a decode is one
word load, a shift and a mask. Packing is adopted only at ``vpw >= 2``
(``bits <= 16``): a guaranteed 2x or better.

The frame-of-reference delta pack (``for_spec``, ``pack_for``) serves the
resident join regions' globally sorted right codes (``exec/join_residency.py``):
one raw reference per block of 128 values and the in-block offsets packed.

On the card the plain decode runs inside K1p (``csrc/predicate_mask.cu``,
``hs_predicate_block_counts_packed``) and the FoR decode inside K2p
(``csrc/sorted_intersect.cu``, ``hs_sorted_intersect_packed``);
``unpack_plain_torch`` and ``unpack_for_torch`` are their plain versions. Words live as int32; shifts and masks run on the unsigned value,
so a word whose top bit is set never smears ones into its neighbour's
lanes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

# Packing is adopted only at >= 2x savings: above 16 bits a word holds one
# value and the "pack" would be a copy with extra decode work.
MAX_PACK_BITS = 16


def _vpw(bits: int) -> int:
    """Largest power of two with vpw * bits <= 32."""
    v = 1
    while v * 2 * bits <= 32:
        v *= 2
    return v


@dataclass(frozen=True)
class PackSpec:
    """The shape of one packed plane. ``block == 0`` means plain pack
    (one frame ``ref0``); ``block > 0`` means FoR delta with one
    reference per ``block`` values."""

    bits: int
    vpw: int  # values per 32-bit word (straddle-free)
    n: int  # logical values
    ref0: int = 0  # plain pack frame of reference
    block: int = 0  # FoR rows per reference (0 = plain)

    @property
    def n_words(self) -> int:
        return -(-self.n // self.vpw)

    @property
    def packed_nbytes(self) -> int:
        refs = 4 * (-(-self.n // self.block)) if self.block else 0
        return 4 * self.n_words + refs


def pack_spec(lo: int, hi: int, n: int) -> Optional[PackSpec]:
    """The plain-pack spec for ``n`` values spanning [lo, hi], or None
    when packing cannot win (span too wide for <= MAX_PACK_BITS, or
    nothing to pack). The one copy of the bit-budget rule for plain
    planes."""
    if n <= 0:
        return None
    span = hi - lo
    if span < 0:
        return None
    bits = max(int(span).bit_length(), 1)
    if bits > MAX_PACK_BITS:
        return None
    return PackSpec(bits=bits, vpw=_vpw(bits), n=n, ref0=int(lo))


def for_spec(sorted_vals: np.ndarray, block: int = 128) -> Optional[PackSpec]:
    """The FoR-delta spec for a SORTED int stream, sized to the worst
    block's span, or None when in-block spans exceed MAX_PACK_BITS."""
    n = int(len(sorted_vals))
    if n == 0:
        return None
    v = np.asarray(sorted_vals, dtype=np.int64)
    refs = v[::block]
    spans = np.maximum.reduceat(v, np.arange(0, n, block)) - refs
    bits = max(int(spans.max()).bit_length(), 1)
    if bits > MAX_PACK_BITS:
        return None
    return PackSpec(bits=bits, vpw=_vpw(bits), n=n, block=int(block))


def pack_plain(values: np.ndarray, spec: PackSpec) -> np.ndarray:
    """Host-side plain pack: int array -> int32 words under ``spec``.
    Values must lie in [ref0, ref0 + 2^bits)."""
    v = np.asarray(values, dtype=np.int64) - spec.ref0
    return _pack_offsets(v, spec)


def pack_for(sorted_vals: np.ndarray, spec: PackSpec) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side FoR-delta pack of a sorted stream: (words, refs), both
    int32. ``refs[i]`` is the raw first value of block i."""
    v = np.asarray(sorted_vals, dtype=np.int64)
    refs64 = v[:: spec.block]
    offsets = v - np.repeat(refs64, spec.block)[: len(v)]
    return _pack_offsets(offsets, spec), refs64.astype(np.int32)


def _pack_offsets(off: np.ndarray, spec: PackSpec) -> np.ndarray:
    """Non-negative offsets (< 2^bits each) -> int32 words: word w holds
    values [w*vpw, (w+1)*vpw), value j at bit (j % vpw) * bits. Built in
    uint32 so the top value's shift cannot overflow a signed lane."""
    n_pad = spec.n_words * spec.vpw
    padded = np.zeros(n_pad, dtype=np.uint32)
    padded[: len(off)] = off.astype(np.uint32)
    lanes = padded.reshape(spec.n_words, spec.vpw)
    words = np.zeros(spec.n_words, dtype=np.uint32)
    for j in range(spec.vpw):
        words |= lanes[:, j] << np.uint32(j * spec.bits)
    return words.view(np.int32)


def unpack_plain_host(words: np.ndarray, spec: PackSpec) -> np.ndarray:
    """Numpy decode of a plain-packed plane: (n,) int32 values."""
    idx = np.arange(spec.n)
    u = words.reshape(-1)[: spec.n_words].view(np.uint32)[idx // spec.vpw]
    shift = ((idx % spec.vpw) * spec.bits).astype(np.uint32)
    off = (u >> shift) & np.uint32((1 << spec.bits) - 1)
    return off.view(np.int32) + np.int32(spec.ref0)


def unpack_plain_torch(words: torch.Tensor, spec: PackSpec) -> torch.Tensor:
    """Plain version of K1p's decode (the reference's ``unpack_plain_jnp``):
    flat int32 words (at least ``n_words``) -> (n,) int32 values on the
    words' device. The words widen to int64 and drop their sign bits
    first, so the shifts act on the unsigned word."""
    idx = torch.arange(spec.n, device=words.device, dtype=torch.int64)
    u = words.reshape(-1)[: spec.n_words].to(torch.int64) & 0xFFFFFFFF
    w = u[idx // spec.vpw]
    shift = (idx % spec.vpw) * spec.bits
    off = (w >> shift) & ((1 << spec.bits) - 1)
    return (off + spec.ref0).to(torch.int32)


def unpack_for_torch(words: torch.Tensor, refs: torch.Tensor, spec: PackSpec) -> torch.Tensor:
    """Plain version of K2p's decode (the reference's ``unpack_for_jnp``):
    (words, per-block refs) -> (n,) int32 sorted values,
    ``refs[i // block] + ((word[i // vpw] >> (i % vpw) * bits) & mask)``,
    on the words' device. Words and refs may be longer than the spec needs
    (padding)."""
    idx = torch.arange(spec.n, device=words.device, dtype=torch.int64)
    u = words.reshape(-1).to(torch.int64) & 0xFFFFFFFF
    w = u[idx // spec.vpw]
    off = (w >> ((idx % spec.vpw) * spec.bits)) & ((1 << spec.bits) - 1)
    return (refs.reshape(-1).to(torch.int64)[idx // spec.block] + off).to(torch.int32)
