"""The streaming block-window tier: device scans over tables whose (even
packed) predicate planes exceed the residency budget.

Counterpart of the single-device part of ``hyperspace_tpu.residency.
streaming``. The table's planes live in pinned host memory (packed words
where the codec wins, raw int32 planes where it does not), padded to a
whole number of windows. A scan stages them through a pair of device
slabs, preallocated per plane at build: while K1c (or K1p, when a window
holds packed planes) counts window w on the compute stream, window w+1's
bytes ride a copy stream into the other slot. Per window only the count
vector comes home, into pinned memory behind an event (``ops/build.py:
DeviceFetch``).

The ordering, in torch's idiom:

* window w's upload is ``copy_(non_blocking=True)`` of pinned host slices
  on the copy stream, followed by an event;
* the host waits on that event before it queues window w's count launch
  (the wait is timed: under ``_STALL_EPSILON_S`` a prefetch hit, above it
  a stall), so the launch never reads a half-written slot;
* an event recorded after the launch gates the slot's next refill: the
  copy stream waits on it before writing window w+2 there;
* the count vector's copy home is waited on only after the loop.

On the CPU (the caller asked for it) the same windows run in order over
host tensors, through the kernels' plain versions.

Window geometry: ``window_rows`` (conf ``hyperspace.residency.streaming.
windowRows``) padded up to a multiple of 8192, which is the count block
and a multiple of every word width (vpw is a power of two <= 32), so a
window slices on word and block boundaries at once. Pad rows decode to
``ref0`` (packed) or 0 (raw) and can only add counts in tail blocks; the
host leg re-evaluates candidate blocks exactly.

Not ported yet: the batched window loop (``stream_block_counts_batch``,
the serving layer's, with the window generation its batches key on) and
the mesh streaming tables. A device error mid-window raises; the
reference's host recovery is not ported.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..exec.hbm_cache import vocab_heap_bytes
from ..ops.bitpack import PackSpec, pack_plain
from ..telemetry.metrics import metrics

_WINDOW_GRAIN = 8192  # BLOCK_ROWS: the count block and every word width divide it

# an upload whose wait takes less than this landed while the previous
# window's launch ran (a prefetch hit); above it the loop stalled on the link
_STALL_EPSILON_S = 0.002


@dataclass
class StreamPlane:
    """One plane of a streaming column: host words under ``spec``, or a raw
    int32 plane (spec None), padded to the table's window multiple; and
    its two device slots, each one window long."""

    host: torch.Tensor  # int32, pinned on the card's host
    spec: Optional[PackSpec] = None
    slots: Tuple[torch.Tensor, ...] = ()


@dataclass
class StreamColumn:
    """Host-side column state; duck-typed against ResidentColumn for
    ``prepare_resident_predicate`` (enc, dtype_str, vocab)."""

    dtype_str: str
    enc: str  # 'int' | 'float32' | 'string' | 'f64'
    planes: Dict[str, StreamPlane]  # '' single plane; 'hi'/'lo' for f64
    nbytes: int  # host bytes (planes + vocab heap)
    vocab: Optional[np.ndarray] = None


@dataclass
class StreamingResidentTable:
    """A resident table at the streaming tier: the identity, coverage and
    zone surface of ``ResidentTable`` (the registry, lookup and selectivity
    gate serve it unchanged), with host planes and a budget charge of the
    slab pair, not the table."""

    tier = "streaming"

    key: tuple
    files: List[Tuple[str, int, int]]
    n_rows: int
    n_pad: int  # window-multiple padded rows
    window_rows: int
    n_windows: int
    columns: Dict[str, StreamColumn]
    nbytes: int  # budget charge: the slab pair + vocab heaps
    host_bytes: int  # host planes (reported, not charged)
    raw_nbytes: int  # what the planes would cost raw-resident
    device: torch.device
    zones: Dict[str, Tuple[str, np.ndarray, np.ndarray]] = field(default_factory=dict)
    last_used: float = field(default_factory=time.monotonic)
    copy_stream: Optional["torch.cuda.Stream"] = None
    # one window loop at a time: the budget charges one slab pair
    _stream_lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def file_span(self, path: str) -> Optional[Tuple[int, int]]:
        for p, start, n in self.files:
            if p == path:
                return start, start + n
        return None


def window_pad_rows(window_rows: int) -> int:
    return -(-max(int(window_rows), 1) // _WINDOW_GRAIN) * _WINDOW_GRAIN


def _host_tensor(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))
    return t.pin_memory() if dev.type == "cuda" else t


def build_streaming_table(
    key: tuple,
    spans: List[Tuple[str, int, int]],
    n_rows: int,
    host_planes: dict,
    zones: dict,
    specs: Dict[str, PackSpec],
    window_rows: int,
    dev: torch.device,
) -> StreamingResidentTable:
    """The streaming table from the cache build's host planes.

    ``host_planes`` maps column name -> (dtype_str, enc, vocab, [plane
    arrays of n_rows values]) (one plane, or f64's hi and lo); ``specs``
    the tier plan's PackSpec per packed single-plane column. Packing,
    window padding and the slab pair are made here."""
    W = window_pad_rows(window_rows)
    n_pad = -(-n_rows // W) * W
    columns: Dict[str, StreamColumn] = {}
    host_bytes = raw_bytes = window_bytes = 0
    for name, (dtype_str, enc, vocab, arrs) in host_planes.items():
        keys = ("hi", "lo") if len(arrs) == 2 else ("",)
        sp: Dict[str, StreamPlane] = {}
        col_bytes = vocab_heap_bytes(vocab)
        for pkey, flat in zip(keys, arrs):
            raw_bytes += n_pad * 4
            spec = specs.get(name) if pkey == "" else None
            if spec is not None:
                # re-spec over the padded length; pad rows decode to ref0
                spec = dataclasses.replace(spec, n=n_pad)
                padded = np.full(n_pad, spec.ref0, dtype=np.int64)
                padded[:n_rows] = flat[:n_rows]
                host = pack_plain(padded, spec)
                per_window = W // spec.vpw
            else:
                host = np.zeros(n_pad, dtype=np.int32)
                host[:n_rows] = flat[:n_rows]
                per_window = W
            slots = tuple(
                torch.empty(per_window, dtype=torch.int32, device=dev) for _ in range(2)
            )
            sp[pkey] = StreamPlane(_host_tensor(host, dev), spec, slots)
            col_bytes += host.nbytes
            window_bytes += 4 * per_window
        columns[name] = StreamColumn(dtype_str, enc, sp, col_bytes, vocab)
        host_bytes += col_bytes
    return StreamingResidentTable(
        key,
        spans,
        n_rows,
        n_pad,
        W,
        n_pad // W,
        columns,
        2 * window_bytes + sum(vocab_heap_bytes(c.vocab) for c in columns.values()),
        host_bytes,
        raw_bytes,
        dev,
        zones,
        copy_stream=torch.cuda.Stream(dev) if dev.type == "cuda" else None,
    )


def _resolve_plane(table: StreamingResidentTable, name: str) -> StreamPlane:
    if "\x00" in name:
        base, pkey = name.split("\x00", 1)
        return table.columns[base].planes[pkey]
    return table.columns[name].planes[""]


def _window_slice(plane: StreamPlane, w: int, W: int) -> torch.Tensor:
    """Window ``w`` of a plane's host tensor (words for a packed plane)."""
    per = W if plane.spec is None else W // plane.spec.vpw
    return plane.host[w * per : (w + 1) * per]


def _run_window_loop(table: StreamingResidentTable, planes: List[StreamPlane], launch):
    """The double-buffered loop over every window. ``launch(cols)`` queues
    one window's count launch over ``cols`` (one device slot per plane)
    on the current stream and returns its count tensor. Returns the
    per-window count arrays in window order."""
    with table._stream_lock:
        return _windowed_counts_locked(table, planes, launch)


def _windowed_counts_locked(table, planes, launch) -> List[np.ndarray]:
    from ..ops.build import DeviceFetch

    W = table.window_rows
    dev = table.device
    if dev.type == "cpu":  # the caller asked for the CPU: the windows in order
        out = []
        for w in range(table.n_windows):
            cols = [_window_slice(p, w, W) for p in planes]
            metrics.incr("residency.stream.h2d_bytes", sum(4 * c.numel() for c in cols))
            out.append(launch(cols).numpy())
            metrics.incr("residency.stream.windows")
        return out
    compute = torch.cuda.current_stream(dev)
    copy = table.copy_stream
    uploaded: List[Optional[torch.cuda.Event]] = [None, None]
    read: List[Optional[torch.cuda.Event]] = [None, None]

    def upload(w: int) -> None:
        slot = w % 2
        t0 = time.perf_counter()
        with torch.cuda.stream(copy):
            if read[slot] is not None:
                # the slot is refilled only after the launch that read it
                copy.wait_event(read[slot])
            for p in planes:
                p.slots[slot].copy_(_window_slice(p, w, W), non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(copy)
        uploaded[slot] = ev
        metrics.incr("residency.stream.h2d_bytes", sum(4 * p.slots[slot].numel() for p in planes))
        metrics.record_time("residency.stream.h2d", time.perf_counter() - t0)

    # the slots' previous contents may still be read by queued work
    copy.wait_stream(compute)
    fetches = []
    upload(0)
    for w in range(table.n_windows):
        slot = w % 2
        t0 = time.perf_counter()
        uploaded[slot].synchronize()
        stall = time.perf_counter() - t0
        if w > 0:
            if stall < _STALL_EPSILON_S:
                metrics.incr("residency.stream.prefetch_hit")
            else:
                metrics.incr("residency.stream.prefetch_stall")
                metrics.record_time("residency.stream.stall", stall)
        counts = launch([p.slots[slot] for p in planes])
        ev = torch.cuda.Event()
        ev.record(compute)
        read[slot] = ev
        fetches.append(DeviceFetch([counts]))
        if w + 1 < table.n_windows:
            upload(w + 1)
        metrics.incr("residency.stream.windows")
    out = [f.wait()[0] for f in fetches]
    # the next scan's first upload must not overwrite a slot still read
    copy.wait_stream(compute)
    return out


def stream_block_counts(table: StreamingResidentTable, predicate) -> Optional[np.ndarray]:
    """Per-8192-row-block match counts over the whole streamed table: the
    streaming twin of ``HbmIndexCache.block_counts``. Each window launches
    K1p when it holds a packed plane of the predicate, else K1c. None when
    the predicate cannot ride the resident encodings (the caller routes
    host); device errors raise."""
    from ..exec.hbm_cache import BLOCK_ROWS, prepare_resident_predicate
    from ..ops import kernels as K

    prepared = prepare_resident_predicate(table.columns, predicate)
    if prepared is None:
        return None
    narrowed, names = prepared
    planes = [_resolve_plane(table, n) for n in names]
    W = table.window_rows
    specs = [dataclasses.replace(p.spec, n=W) if p.spec is not None else None for p in planes]
    packed = any(s is not None for s in specs)

    def launch(cols):
        if packed:
            return K.predicate_block_counts_packed_tensor(narrowed, names, cols, specs, W)
        return K.predicate_block_counts_tensor(narrowed, names, cols)

    t0 = time.perf_counter()
    parts = _run_window_loop(table, planes, launch)
    metrics.record_time("scan.resident.device", time.perf_counter() - t0)
    counts = np.concatenate(parts)
    metrics.incr("scan.resident.d2h_bytes", int(counts.nbytes))
    return counts[: -(-table.n_rows // BLOCK_ROWS)]
