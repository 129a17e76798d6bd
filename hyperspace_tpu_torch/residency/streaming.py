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

The serving layer's batch (``stream_block_counts_batch``) runs the same
loop once for N predicates: each window uploads the union of their planes
once and launches K1b over them (K1c or K1p for N = 1), and one
``(N, n_blocks)`` matrix comes home. Batches key on the table's
``window_gen``, the generation a device failure mid-window bumps as it
tears the slab pair down (``residency.stream.window_failed``); the caller
then drops the table and answers through the per-file route.

The mesh twin (``MeshStreamingResidentTable``, the streaming rung of
``exec/mesh_cache.py``'s ladder) keeps each shard's planes in pinned host
memory of their own and a slab pair and copy stream on the shard's
device. A window uploads each shard's slice on that device's copy stream
and runs K1c or K1p (K1b for a batch) once a shard; every shard's window
w is queued before any shard's window w + 1, and the budget is charged
the slab pairs of all shards. ``window_gen`` and the device-failure
teardown are the single-device table's.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..exec.bytecache import vocab_heap_bytes
from ..ops.bitpack import PackSpec, pack_plain
from ..telemetry.metrics import metrics
from ..telemetry.trace import add_bytes as _trace_bytes

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
    # '' single plane; 'hi'/'lo' for f64 (a mesh table: a list, one a shard)
    planes: Dict[str, StreamPlane]
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
    # the serve batches' generation key (module note)
    window_gen: int = 0
    # one window loop at a time: the budget charges one slab pair
    _stream_lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def file_span(self, path: str) -> Optional[Tuple[int, int]]:
        for p, start, n in self.files:
            if p == path:
                return start, start + n
        return None


@dataclass
class MeshStreamingResidentTable:
    """A mesh table at the streaming tier: ``exec/mesh_cache.py:
    MeshResidentTable``'s identity, segments and block geometry (the
    registry and ``collect_parts`` serve it unchanged), with each column's
    planes a list of per-shard ``StreamPlane``s (``planes[key][d]``:
    shard d's pinned host words and its slot pair on its device) and a
    budget charge of the slab pairs."""

    tier = "streaming"

    key: tuple
    mesh: object
    n_devices: int
    cap: int  # padded rows a shard: a whole number of windows
    dev_rows: List[int]
    segments: List[list]
    columns: Dict[str, StreamColumn]
    n_rows: int
    window_rows: int
    n_windows: int
    nbytes: int  # budget charge: every shard's slab pair + vocab heaps
    host_bytes: int
    raw_nbytes: int
    copy_streams: List[Optional["torch.cuda.Stream"]]
    last_used: float = field(default_factory=time.monotonic)
    window_gen: int = 0
    _stream_lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    @property
    def n_blocks(self) -> int:
        return self.cap // _WINDOW_GRAIN

    @property
    def device(self):
        """The mesh (the residency snapshot prints it)."""
        return self.mesh


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


def _resolve_plane(table, name: str):
    """The plane of a (possibly plane-suffixed) name: a ``StreamPlane``, or
    a mesh table's list of them, one a shard."""
    if "\x00" in name:
        base, pkey = name.split("\x00", 1)
        return table.columns[base].planes[pkey]
    return table.columns[name].planes[""]


def _window_slice(plane: StreamPlane, w: int, W: int) -> torch.Tensor:
    """Window ``w`` of a plane's host tensor (words for a packed plane)."""
    per = W if plane.spec is None else W // plane.spec.vpw
    return plane.host[w * per : (w + 1) * per]


@dataclass
class _Lane:
    """One device's share of a window loop: the device, its copy stream
    (None on the CPU) and the planes it stages, each with its host words
    and its slot pair on that device."""

    dev: torch.device
    copy: Optional["torch.cuda.Stream"]
    planes: List[StreamPlane]


def _lanes(table, names) -> List[_Lane]:
    """The loop's lanes over ``names``: one for a single-device table,
    one a shard for a mesh table."""
    if isinstance(table, MeshStreamingResidentTable):
        return [_Lane(dev, table.copy_streams[d], [_resolve_plane(table, n)[d] for n in names])
                for d, dev in enumerate(table.mesh.devices)]
    return [_Lane(table.device, table.copy_stream, [_resolve_plane(table, n) for n in names])]


def _device_scope(dev: torch.device):
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def _run_window_loop(table, lanes: List[_Lane], launch) -> List[List[np.ndarray]]:
    """The double-buffered loop over every window, every lane's window w
    queued before any lane's window w + 1. ``launch(cols)`` queues one
    window's count launch over ``cols`` (one device slot per plane) on the
    current device's current stream and returns its count tensor. Returns
    each lane's per-window count arrays, in window order.

    A device error mid-window tears the slab pairs down: the generation
    goes up so no in-flight serve batch spans the discontinuity, and the
    error goes on to the caller, which drops the table and answers
    through the per-file (or per-query mesh) route."""
    with table._stream_lock:
        try:
            return _windowed_counts_locked(table, lanes, launch)
        except RuntimeError:
            table.window_gen += 1
            metrics.incr("residency.stream.window_failed")
            raise


def _upload_window(lane: _Lane, w: int, W: int, read) -> "torch.cuda.Event":
    """Queue window ``w``'s slices into slot ``w % 2`` of each plane's
    slab pair on the lane's copy stream, after ``read`` (the event of the
    launch that last read the slot, or None), and return the event
    recorded after the copies."""
    slot = w % 2
    t0 = time.perf_counter()
    with _device_scope(lane.dev), torch.cuda.stream(lane.copy):
        if read is not None:
            # the slot is refilled only after the launch that read it
            lane.copy.wait_event(read)
        for p in lane.planes:
            p.slots[slot].copy_(_window_slice(p, w, W), non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(lane.copy)
    nbytes = sum(4 * p.slots[slot].numel() for p in lane.planes)
    metrics.incr("residency.stream.h2d_bytes", nbytes)
    _trace_bytes("h2d_bytes", nbytes)  # label at the transfer site
    metrics.record_time("residency.stream.h2d", time.perf_counter() - t0)
    return ev


def _windowed_counts_locked(table, lanes: List[_Lane], launch) -> List[List[np.ndarray]]:
    from ..ops.build import DeviceFetch

    W = table.window_rows
    if lanes[0].dev.type == "cpu":  # the caller asked for the CPU: the windows in order
        out: List[List[np.ndarray]] = [[] for _ in lanes]
        for w in range(table.n_windows):
            for i, lane in enumerate(lanes):
                cols = [_window_slice(p, w, W) for p in lane.planes]
                metrics.incr("residency.stream.h2d_bytes", sum(4 * c.numel() for c in cols))
                out[i].append(launch(cols).numpy())
            metrics.incr("residency.stream.windows")
        return out
    uploaded = [[None, None] for _ in lanes]
    read = [[None, None] for _ in lanes]
    fetches: List[list] = [[] for _ in lanes]

    for i, lane in enumerate(lanes):
        # the slots' previous contents may still be read by queued work
        lane.copy.wait_stream(torch.cuda.current_stream(lane.dev))
        uploaded[i][0] = _upload_window(lane, 0, W, read[i][0])
    for w in range(table.n_windows):
        slot = w % 2
        for i, lane in enumerate(lanes):
            with _device_scope(lane.dev):
                t0 = time.perf_counter()
                uploaded[i][slot].synchronize()
                stall = time.perf_counter() - t0
                if w > 0:
                    if stall < _STALL_EPSILON_S:
                        metrics.incr("residency.stream.prefetch_hit")
                    else:
                        metrics.incr("residency.stream.prefetch_stall")
                        metrics.record_time("residency.stream.stall", stall)
                counts = launch([p.slots[slot] for p in lane.planes])
                ev = torch.cuda.Event()
                ev.record(torch.cuda.current_stream(lane.dev))
                read[i][slot] = ev
                fetches[i].append(DeviceFetch([counts]))
        if w + 1 < table.n_windows:
            nxt = (w + 1) % 2
            for i, lane in enumerate(lanes):
                uploaded[i][nxt] = _upload_window(lane, w + 1, W, read[i][nxt])
        metrics.incr("residency.stream.windows")
    out = [[f.wait()[0] for f in lane_fetches] for lane_fetches in fetches]
    for lane in lanes:
        # the next scan's first upload must not overwrite a slot still read
        lane.copy.wait_stream(torch.cuda.current_stream(lane.dev))
    return out


def _stream_counts(table, prepared) -> np.ndarray:
    """Counts of N prepared predicates over every window: each window
    uploads the union of their planes once a lane and launches
    ``ops/kernels.py:resident_counts_tensor`` (K1c or K1p for N = 1, K1b
    for more). ``(N, n_pad / 8192)`` for a single-device table, ``(D, N,
    cap / 8192)`` for a mesh table."""
    from ..ops import kernels as K

    union = tuple(dict.fromkeys(n for _, names in prepared for n in names))
    lanes = _lanes(table, union)
    W = table.window_rows
    specs = [dataclasses.replace(p.spec, n=W) if p.spec is not None else None
             for p in lanes[0].planes]
    parts = _run_window_loop(
        table, lanes, lambda cols: K.resident_counts_tensor(prepared, union, cols, specs, W))
    per_lane = [np.concatenate(p, axis=1) for p in parts]
    return np.stack(per_lane) if isinstance(table, MeshStreamingResidentTable) else per_lane[0]


def stream_block_counts(table: StreamingResidentTable, predicate) -> Optional[np.ndarray]:
    """Per-8192-row-block match counts over the whole streamed table: the
    streaming twin of ``HbmIndexCache.block_counts``. Each window launches
    K1p when it holds a packed plane of the predicate, else K1c. None when
    the predicate cannot ride the resident encodings (the caller routes
    to the per-file path); device errors raise to the caller."""
    from ..exec.hbm_cache import BLOCK_ROWS, prepare_resident_predicate

    prepared = prepare_resident_predicate(table.columns, predicate)
    if prepared is None:
        return None
    t0 = time.perf_counter()
    counts = _stream_counts(table, [prepared])[0]
    metrics.record_time("scan.resident.device", time.perf_counter() - t0)
    metrics.incr("scan.resident.d2h_bytes", int(counts.nbytes))
    _trace_bytes("d2h_bytes", int(counts.nbytes))
    return counts[: -(-table.n_rows // BLOCK_ROWS)]


def stream_block_counts_batch(table: StreamingResidentTable, predicates, prepared=None,
                              metric_ns: str = "serve.batch") -> Optional[np.ndarray]:
    """``(N, n_blocks)`` counts of N predicates over the streamed table,
    each window uploaded and counted once for the whole batch. None when
    any predicate does not narrow. ``metric_ns`` as ``block_counts_batch``'s."""
    from ..exec.hbm_cache import BLOCK_ROWS, prepare_resident_predicate

    if prepared is None:
        prepared = [prepare_resident_predicate(table.columns, p) for p in predicates]
    if any(p is None for p in prepared):
        return None
    t0 = time.perf_counter()
    counts = _stream_counts(table, prepared)
    metrics.record_time(f"{metric_ns}.device", time.perf_counter() - t0)
    metrics.incr(f"{metric_ns}.dispatches")
    metrics.incr(f"{metric_ns}.queries", len(prepared))
    metrics.incr("scan.resident.d2h_bytes", int(counts.nbytes))
    _trace_bytes("d2h_bytes", int(counts.nbytes))
    return counts[:, : -(-table.n_rows // BLOCK_ROWS)]


def build_mesh_streaming_table(key: tuple, mesh, dev_segs, dev_rows, n_rows: int,
                               host_mats: dict, specs: Dict[str, PackSpec],
                               window_rows: int) -> MeshStreamingResidentTable:
    """The mesh streaming table from the mesh build's host ``(D, cap)``
    matrices: ``host_mats`` maps column name -> (dtype_str, enc, vocab,
    {plane key: (D, cap) int32}); ``specs`` the tier plan's global
    PackSpec per packed column (one frame for every shard). Each shard's
    rows are padded to a whole number of windows (pads decode to ``ref0``
    or 0), packed, pinned, and given a slab pair on its device."""
    D = mesh.size
    cap_in = next(iter(next(iter(host_mats.values()))[3].values())).shape[1]
    W = window_pad_rows(window_rows)
    cap = -(-cap_in // W) * W
    columns: Dict[str, StreamColumn] = {}
    host_bytes = raw_bytes = window_bytes = 0
    for name, (dtype_str, enc, vocab, mats) in host_mats.items():
        sp: Dict[str, list] = {}
        col_bytes = vocab_heap_bytes(vocab)
        for pkey, mat in mats.items():
            raw_bytes += D * cap * 4
            spec = specs.get(name) if pkey == "" else None
            if spec is not None:
                spec = dataclasses.replace(spec, n=cap)
                per_window = W // spec.vpw
            else:
                per_window = W
            shards = []
            for d, dev in enumerate(mesh.devices):
                if spec is not None:
                    padded = np.full(cap, spec.ref0, dtype=np.int64)
                    padded[: dev_rows[d]] = mat[d, : dev_rows[d]]
                    host = pack_plain(padded, spec)
                else:
                    host = np.zeros(cap, dtype=np.int32)
                    host[:cap_in] = mat[d]
                slots = tuple(torch.empty(per_window, dtype=torch.int32, device=dev)
                              for _ in range(2))
                shards.append(StreamPlane(_host_tensor(host, dev), spec, slots))
                col_bytes += host.nbytes
                window_bytes += 4 * per_window
            sp[pkey] = shards
        columns[name] = StreamColumn(dtype_str, enc, sp, col_bytes, vocab)
        host_bytes += col_bytes
    return MeshStreamingResidentTable(
        key, mesh, D, cap, list(dev_rows), dev_segs, columns, n_rows, W, cap // W,
        2 * window_bytes + sum(vocab_heap_bytes(c.vocab) for c in columns.values()),
        host_bytes, raw_bytes,
        [torch.cuda.Stream(dev) if dev.type == "cuda" else None for dev in mesh.devices])


def mesh_stream_block_counts(table: MeshStreamingResidentTable, predicate):
    """``(D, n_blocks)`` counts over the streamed shards: the streaming
    twin of ``MeshHbmCache.block_counts``. None when the predicate cannot
    ride the resident encodings; device errors raise to the caller."""
    from ..exec.hbm_cache import prepare_resident_predicate

    prepared = prepare_resident_predicate(table.columns, predicate)
    if prepared is None:
        return None
    t0 = time.perf_counter()
    counts = _stream_counts(table, [prepared])[:, 0]
    metrics.record_time("scan.resident_mesh.device", time.perf_counter() - t0)
    metrics.incr("scan.resident_mesh.d2h_bytes", int(counts.nbytes))
    _trace_bytes("d2h_bytes", int(counts.nbytes))
    return counts


def mesh_stream_block_counts_batch(table: MeshStreamingResidentTable, predicates,
                                   prepared=None, metric_ns: str = "serve.batch"):
    """``(N, D, n_blocks)`` counts of N predicates, every window uploaded
    and counted once a shard for the whole batch: the mesh streaming leg
    of the micro-batcher and (N = 1) of the compiled mesh scan. None when
    any predicate does not narrow."""
    from ..exec.hbm_cache import prepare_resident_predicate

    if prepared is None:
        prepared = [prepare_resident_predicate(table.columns, p) for p in predicates]
    if any(p is None for p in prepared):
        return None
    t0 = time.perf_counter()
    counts = _stream_counts(table, prepared)
    metrics.record_time(f"{metric_ns}.mesh_device", time.perf_counter() - t0)
    metrics.incr(f"{metric_ns}.dispatches")
    metrics.incr(f"{metric_ns}.queries", len(prepared))
    metrics.incr("scan.resident_mesh.d2h_bytes", int(counts.nbytes))
    _trace_bytes("d2h_bytes", int(counts.nbytes))
    return np.swapaxes(counts, 0, 1)
