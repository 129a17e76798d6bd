"""The native IO runtime: ctypes bindings for ``tcb_io.cc``.

Counterpart of ``hyperspace_tpu.native``, over the port's own copy of its
C++ source (byte for byte). The C++ runs on the host: parallel ``pread``
of many column buffers, the segment-aligned sort-merge join's two-pointer
range walk, the range expansion (into pair arrays, or fused with the
output gather), the single-pass group aggregate over match ranges, and a
durable atomic file write. ctypes drops the GIL around every call, and
each entry spreads its work over as many threads as the hardware runs at
once (``_THREADS``: 0 asks the C++ for ``hardware_concurrency``).

The library is built at first use, as the CUDA kernels are
(``ops/kernels.py``): ``g++ -O3 -shared -fPIC -pthread`` into
``hyperspace_tpu_torch/_build/``, named by a digest of the source
(``libtcb_io-<sha12>.so``), through a pid-named temporary file and
``os.replace`` so that concurrent processes may race on the first build.
A missing or failing ``g++`` raises ``HyperspaceException`` with the
compiler's output; nothing turns the runtime off and nothing falls back.
An entry returns None only where the reference declines by shape
(``smj_join_gather`` over a 1- or 2-byte column). The plain version of
each entry is the port's numpy arm of the same step
(``exec/joins.py:_expand_ranges`` and the host searches,
``exec/aggregate.py``'s generic arm, ``storage/layout.py``'s mmap reads).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..exceptions import HyperspaceException

_SRC = Path(__file__).resolve().parent / "tcb_io.cc"
_BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
_CXX = "g++"
_THREADS = 0  # the C++ entries' thread count: 0, the hardware's concurrency
_LIB: Optional[ctypes.CDLL] = None
_LOCK = threading.Lock()
# calls of each C++ entry, counted where the call is made (as kernel
# launches are, ``ops.count_launch``), so a run can show which entries
# its paths went through
_CALLS: Dict[str, int] = {}
_CALLS_LOCK = threading.Lock()

_i64p = ctypes.POINTER(ctypes.c_int64)
_i32p = ctypes.POINTER(ctypes.c_int32)
_f64p = ctypes.POINTER(ctypes.c_double)
_vpp = ctypes.POINTER(ctypes.c_void_p)
_i32, _i64 = ctypes.c_int32, ctypes.c_int64
_SIGNATURES = {
    "hs_pread_many": (_i32, [ctypes.POINTER(ctypes.c_char_p), _i64p, _i64p, _vpp, _i32, _i32,
                             _i32p]),
    "hs_write_file_atomic": (_i32, [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_void_p, _i64]),
    "hs_smj_ranges": (_i64, [_i64p, _i64p, _i64p, _i64p, _i32, _i64p, _i64p, _i32]),
    "hs_expand_pairs": (None, [_i64p, _i64p, _i64p, _i64, _i64p, _i64p, _i32]),
    "hs_expand_gather": (None, [_i64p, _i64p, _i64p, _i64, _vpp, _i32p, _i32, _vpp, _i32p, _i32,
                                _vpp, _vpp, _i32]),
    "hs_group_agg_ranges_f64": (None, [_i64p, _i64p, _i64p, _i64, _f64p, _f64p, _i64p, _i64p]),
    "hs_group_agg_ranges_i64": (None, [_i64p, _i64p, _i64p, _i64, _i64p, _i64p, _i64p, _i64p]),
}


def _lib_path() -> Path:
    tag = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:12]
    return _BUILD_DIR / f"libtcb_io-{tag}.so"


def _build(so: Path) -> None:
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_CXX, "-O3", "-shared", "-fPIC", "-pthread", str(_SRC), "-o", str(tmp)]
    try:
        p = subprocess.run(cmd, capture_output=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        tmp.unlink(missing_ok=True)
        raise HyperspaceException(
            f"{_CXX} could not run ({e}): the native IO runtime builds from "
            f"hyperspace_tpu_torch/native/tcb_io.cc on first use."
        ) from e
    if p.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise HyperspaceException(
            f"{_CXX} failed to build the native IO runtime:\n"
            + p.stderr.decode(errors="replace")
        )
    os.replace(tmp, so)


def _load() -> ctypes.CDLL:
    """The loaded library, built first where no build of this source
    exists. Raises ``HyperspaceException`` when the build fails."""
    global _LIB
    lib = _LIB
    if lib is not None:
        return lib
    with _LOCK:
        if _LIB is None:
            so = _lib_path()
            if not so.exists():
                _build(so)
            lib = ctypes.CDLL(str(so))
            for name, (res, args) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = res, args
            _LIB = lib
        return _LIB


def _call(name: str, *args):
    """Call the C++ entry ``name`` and count the call."""
    res = getattr(_load(), name)(*args)
    with _CALLS_LOCK:
        _CALLS[name] = _CALLS.get(name, 0) + 1
    return res


def call_counts() -> Dict[str, int]:
    with _CALLS_LOCK:
        return dict(_CALLS)


def reset_call_counts() -> None:
    with _CALLS_LOCK:
        _CALLS.clear()


def _i64ptr(a: np.ndarray):
    return a.ctypes.data_as(_i64p)


def as_int64(a) -> np.ndarray:
    """``a`` as a C-contiguous int64 array: the same object where it is
    one already, so cached ranges are never copied per call."""
    return np.ascontiguousarray(a, dtype=np.int64)


def available() -> bool:
    """True once the library is loaded, building it on first use; raises
    ``HyperspaceException`` where ``g++`` is missing or fails (the port has
    no Python fallback to report instead)."""
    _load()
    return True


def pread_many(tasks: Sequence[Tuple[str, int, int, np.ndarray]]) -> None:
    """Read byte ranges concurrently into caller arrays. Each task is
    ``(path, offset, nbytes, dest)``, ``dest`` a writable C-contiguous
    array of at least ``nbytes``. Raises OSError naming the first failed
    read (a missing file, or a range past the end: "Truncated read")."""
    _load()
    n = len(tasks)
    if n == 0:
        return
    paths = (ctypes.c_char_p * n)(*[os.fsencode(t[0]) for t in tasks])
    offsets = (ctypes.c_int64 * n)(*[int(t[1]) for t in tasks])
    nbytes = (ctypes.c_int64 * n)(*[int(t[2]) for t in tasks])
    dests = (ctypes.c_void_p * n)()
    for i, (_p, _o, nb, a) in enumerate(tasks):
        if not (a.flags["C_CONTIGUOUS"] and a.flags["WRITEABLE"]):
            raise ValueError("pread_many dest must be a writable C buffer.")
        if a.nbytes < int(nb):
            raise ValueError("pread_many dest smaller than requested range.")
        dests[i] = a.ctypes.data_as(ctypes.c_void_p)
    statuses = (ctypes.c_int32 * n)()
    if _call("hs_pread_many", paths, offsets, nbytes, dests, n, _THREADS, statuses):
        for i in range(n):
            rc = statuses[i]
            if rc == -2:
                raise OSError(f"Truncated read from {tasks[i][0]}.")
            if rc:
                raise OSError(rc, os.strerror(rc) if rc > 0 else "IO error", tasks[i][0])


def write_file_atomic(path: str, data) -> None:
    """Durable write of ``data`` (bytes or an array) to ``path``: a
    temporary file beside it, fsync, rename. Raises OSError on failure,
    leaving no temporary file."""
    p = Path(path)
    tmp = p.parent / f".{p.name}.{os.getpid()}.ntmp"
    if isinstance(data, np.ndarray):
        buf = np.ascontiguousarray(data).view(np.uint8)
        ptr, nb = buf.ctypes.data_as(ctypes.c_void_p), buf.nbytes
    else:
        ptr, nb = ctypes.cast(ctypes.c_char_p(data), ctypes.c_void_p), len(data)
    rc = _call("hs_write_file_atomic", os.fsencode(str(tmp)), os.fsencode(str(p)), ptr, nb)
    if rc != 0:
        tmp.unlink(missing_ok=True)
        raise OSError(rc, os.strerror(rc) if rc > 0 else "IO error", str(path))


def group_agg_ranges(keys: np.ndarray, lo: np.ndarray, counts: np.ndarray,
                     r_vals: np.ndarray, span: int):
    """Single-pass dense group aggregate over match ranges: ``(sums, nn,
    rows)`` of length ``span`` — per key slot, the sum and non-NULL count
    of ``r_vals`` over the key's ranges ``[lo, lo + counts)`` and the
    joined row count. ``keys`` must be offset into [0, span) (the C++
    sizes its slots from ``max(keys) + 1``). float64 values skip NaN (SQL
    NULL); int64 values add with int64 wraparound."""
    k, lo_, cnt = as_int64(keys), as_int64(lo), as_int64(counts)
    nn = np.zeros(span, dtype=np.int64)
    rows = np.zeros(span, dtype=np.int64)
    if r_vals.dtype == np.float64:
        v = np.ascontiguousarray(r_vals)
        sums = np.zeros(span, dtype=np.float64)
        _call("hs_group_agg_ranges_f64", _i64ptr(k), _i64ptr(lo_), _i64ptr(cnt), len(k),
              v.ctypes.data_as(_f64p), sums.ctypes.data_as(_f64p),
              _i64ptr(nn), _i64ptr(rows))
        return sums, nn, rows
    v = as_int64(r_vals)
    sums = np.zeros(span, dtype=np.int64)
    _call("hs_group_agg_ranges_i64", _i64ptr(k), _i64ptr(lo_), _i64ptr(cnt), len(k), _i64ptr(v),
          _i64ptr(sums), _i64ptr(nn), _i64ptr(rows))
    return sums, nn, rows


def range_offsets(counts: np.ndarray) -> Tuple[np.ndarray, int]:
    """``(off, total)``: the exclusive prefix of ``counts`` (``off[n]`` is
    the total), as the expansions take it."""
    off = np.empty(len(counts) + 1, dtype=np.int64)
    off[0] = 0
    np.cumsum(counts, out=off[1:])
    return off, int(off[-1])


def smj_ranges_full(l_codes: np.ndarray, r_codes: np.ndarray, l_bounds, r_bounds):
    """``(lo, cnt, off, total)`` of the segment-aligned sort-merge join,
    both sides ascending within each segment: per left row, its first
    matching right position and match count (an O(n+m) two-pointer walk,
    parallel over segments), and ``range_offsets(cnt)``."""
    l, r, lb, rb = as_int64(l_codes), as_int64(r_codes), as_int64(l_bounds), as_int64(r_bounds)
    n_seg = len(lb) - 1
    if n_seg != len(rb) - 1:
        raise ValueError("smj ranges: segment counts differ.")
    lo = np.empty(len(l), dtype=np.int64)
    cnt = np.empty(len(l), dtype=np.int64)
    _call("hs_smj_ranges", _i64ptr(l), _i64ptr(r), _i64ptr(lb), _i64ptr(rb), n_seg, _i64ptr(lo),
          _i64ptr(cnt), _THREADS)
    off, total = range_offsets(cnt)
    return lo, cnt, off, total


def smj_ranges(l_codes, r_codes, l_bounds, r_bounds):
    """``(lo, cnt)`` of ``smj_ranges_full``: the match ranges without any
    pair expansion (what the aggregate over a join consumes)."""
    lo, cnt, _off, _total = smj_ranges_full(l_codes, r_codes, l_bounds, r_bounds)
    return lo, cnt


def expand_pairs(lo: np.ndarray, counts: np.ndarray,
                 ranges=None) -> Tuple[np.ndarray, np.ndarray]:
    """Expand match ranges into ``(l_idx, r_idx)`` pair arrays, right
    positions used as they are (no ``r_order``); ``ranges`` (a
    ``smj_ranges_full`` 4-tuple over the same ranges) skips the prefix.
    The pairs and their order are ``exec/joins.py:_expand_ranges``'s."""
    lo_, cnt = as_int64(lo), as_int64(counts)
    off, total = (ranges[2], ranges[3]) if ranges is not None else range_offsets(cnt)
    l_idx = np.empty(total, dtype=np.int64)
    r_idx = np.empty(total, dtype=np.int64)
    if total:
        _call("hs_expand_pairs", _i64ptr(lo_), _i64ptr(cnt), _i64ptr(off), len(lo_),
              _i64ptr(l_idx), _i64ptr(r_idx), _THREADS)
    return l_idx, r_idx


def smj_gather_supported(l_arrays: Dict[str, np.ndarray], r_arrays: Dict[str, np.ndarray]) -> bool:
    """Whether ``smj_join_gather`` serves these columns: every one 4 or 8
    bytes wide. Checked before any range walk is paid for."""
    return all(a.dtype.itemsize in (4, 8)
               for a in list(l_arrays.values()) + list(r_arrays.values()))


def smj_join_gather(l_codes, r_codes, l_bounds, r_bounds, l_arrays: Dict[str, np.ndarray],
                    r_arrays: Dict[str, np.ndarray], ranges=None):
    """The segment-aligned sort-merge join with the output gather fused
    into the range expansion: ``({left name: joined array}, {right name:
    joined array}, total)``, split across threads by output position; no
    pair arrays and no numpy gather. ``ranges`` (a ``smj_ranges_full``
    4-tuple for the same codes and bounds) skips the range walk. None
    where a column is not 4 or 8 bytes wide."""
    if not smj_gather_supported(l_arrays, r_arrays):
        return None
    if ranges is None:
        ranges = smj_ranges_full(l_codes, r_codes, l_bounds, r_bounds)
    lo, cnt, off, total = ranges

    def pack(arrays: Dict[str, np.ndarray]):
        srcs = [np.ascontiguousarray(a) for a in arrays.values()]
        outs = [np.empty(total, dtype=s.dtype) for s in srcs]
        n = len(srcs)
        widths = (ctypes.c_int32 * n)(*[s.dtype.itemsize for s in srcs])
        src_ps = (ctypes.c_void_p * n)(*[s.ctypes.data for s in srcs])
        dst_ps = (ctypes.c_void_p * n)(*[o.ctypes.data for o in outs])
        return srcs, outs, widths, src_ps, dst_ps

    lsrcs, louts, lw, lsp, ldp = pack(l_arrays)
    rsrcs, routs, rw, rsp, rdp = pack(r_arrays)
    if total:
        lo_, cnt_, off_ = as_int64(lo), as_int64(cnt), as_int64(off)
        _call("hs_expand_gather", _i64ptr(lo_), _i64ptr(cnt_), _i64ptr(off_), len(lo_), lsp, lw,
              len(lsrcs), rsp, rw, len(rsrcs), ldp, rdp, _THREADS)
    return dict(zip(l_arrays, louts)), dict(zip(r_arrays, routs)), int(total)


def load_columns(specs: List[Tuple[str, List[Tuple[int, int]]]]) -> List[List[np.ndarray]]:
    """Load many column buffers in parallel: ``specs`` lists ``(path,
    [(offset, nbytes), ...])`` per file; returns per-file lists of fresh
    uint8 arrays in spec order."""
    tasks: List[Tuple[str, int, int, np.ndarray]] = []
    out: List[List[np.ndarray]] = []
    for path, ranges in specs:
        bufs = []
        for off, nb in ranges:
            dest = np.empty(nb, dtype=np.uint8)
            bufs.append(dest)
            tasks.append((path, off, nb, dest))
        out.append(bufs)
    pread_many(tasks)
    return out
