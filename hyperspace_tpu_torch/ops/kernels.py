"""The query hot path's two hand-written CUDA kernels and their wrappers.

Counterpart of ``hyperspace_tpu.ops.kernels``, whose two Pallas kernels
become CUDA C++ for Hopper (``csrc/``):

1. **Predicate mask** (``predicate_mask`` → ``csrc/predicate_mask.cu``,
   replacing ``_build_mask_call``): a filter predicate over int32-narrowed
   columns, lowered on the host to a postfix program the kernel
   interprets per row, so one build serves every predicate.
2. **Sorted-intersection join counts** (``sorted_intersect_counts`` →
   ``csrc/sorted_intersect.cu``, replacing ``_build_smj_call``): for each
   left key against ascending right keys, (#right < key, #right == key) —
   the match range of the bucketed sort-merge join.

The int32 narrowing (``narrow_expr_to_i32`` / ``narrow_arrays_to_i32``)
and the host span planning (``_plan_sorted_intersect``) are copies of the
reference, so both packages accept and decline exactly the same inputs
(a decline returns None and the caller takes the reference's other arm).

Each tensor-level wrapper decides by the device its tensors lie on: a CPU
tensor goes to the plain torch version beside the kernel
(``predicate_mask_reference``, ``sorted_intersect_counts_reference``); a
CUDA tensor launches the kernel or raises. There is no fallback from a
failed launch. The kernels build with ``nvcc`` for ``sm_90a`` on first use
into ``hyperspace_tpu_torch/_build/`` and load through ``ctypes``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..exceptions import HyperspaceException
from ..plan.expr import And, Cmp, Col, Expr, In, Lit, Not, Or, eval_mask
from ..storage.columnar import Column, ColumnarBatch
from . import DeviceLike, count_launch, resolve_device
from .floatbits import f32_to_ordered_i32 as _f32_ordered_i32

SMJ_TILE = 1024  # left/right tile of the join plan (8 x 128 keys)
_I32_MIN = -(2**31)
_I32_MAX = 2**31 - 1

# A left tile whose key range overlaps more right tiles than this is
# fixed up on the host (the reference's SMJ_MAX_SPAN_TILES).
SMJ_MAX_SPAN_TILES = 64

K1 = "predicate_mask"
K2 = "sorted_intersect"

# ---------------------------------------------------------------------------
# build + load (nvcc -> plain-C shared library -> ctypes)
# ---------------------------------------------------------------------------
_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
_SOURCES = {K1: "predicate_mask.cu", K2: "sorted_intersect.cu"}
_LIBS: Dict[str, ctypes.CDLL] = {}
_LIB_LOCK = threading.Lock()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if not home:
        from torch.utils.cpp_extension import CUDA_HOME

        home = CUDA_HOME
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise HyperspaceException(
            "nvcc not found (set CUDA_HOME): the CUDA kernels build from "
            "hyperspace_tpu_torch/csrc on first use."
        )
    return found


def _lib_path(name: str) -> Tuple[Path, Path]:
    src = _CSRC / _SOURCES[name]
    digest = hashlib.sha1(src.read_bytes()).hexdigest()[:12]
    return src, _BUILD_DIR / f"lib{name}-{digest}.so"


def build_kernels(names=tuple(_SOURCES)) -> Dict[str, ctypes.CDLL]:
    """Compile (one ``nvcc`` per source, all started together) and load
    the named kernels' libraries; already-built ones are reused."""
    with _LIB_LOCK:
        todo = [n for n in names if n not in _LIBS]
        procs = []
        for n in todo:
            src, so = _lib_path(n)
            if so.exists():
                continue
            _BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            cmd = [
                _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                "-o", str(tmp), str(src),
            ]
            procs.append((n, so, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT
            )))
        failed = []
        for n, so, tmp, p in procs:
            out, _ = p.communicate()
            if p.returncode != 0:
                failed.append(f"{n}: {out.decode(errors='replace')}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, so)
        if failed:
            raise HyperspaceException("nvcc failed:\n" + "\n".join(failed))
        for n in todo:
            lib = ctypes.CDLL(str(_lib_path(n)[1]))
            vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
            if n == K1:
                lib.hs_predicate_mask.argtypes = [vp, vp, ci, ll, vp, vp]
                lib.hs_predicate_mask.restype = ci
            else:
                lib.hs_sorted_intersect.argtypes = [vp, vp, vp, vp, vp, ll, vp, vp, vp]
                lib.hs_sorted_intersect.restype = ci
            _LIBS[n] = lib
        return dict(_LIBS)


def _lib(name: str) -> ctypes.CDLL:
    lib = _LIBS.get(name)
    return lib if lib is not None else build_kernels((name,))[name]


def _check_cuda(t: torch.Tensor, dtype: torch.dtype, what: str) -> None:
    if t.device.type != "cuda" or t.dtype != dtype or not t.is_contiguous():
        raise HyperspaceException(
            f"{what}: expected a contiguous {dtype} CUDA tensor, got "
            f"{t.dtype} on {t.device} (contiguous={t.is_contiguous()})."
        )


def _check_launch(rc: int, what: str) -> None:
    if rc != 0:
        raise HyperspaceException(f"{what}: CUDA launch failed with error {rc}.")


# ---------------------------------------------------------------------------
# int32 narrowing (copied from the reference)
# ---------------------------------------------------------------------------
def _fits_i32(v) -> bool:
    return isinstance(v, (int, np.integer)) and not isinstance(v, bool) and (
        _I32_MIN < int(v) < _I32_MAX
    )


def _f32_scalar_ordered(v) -> Optional[int]:
    """Encoded int32 of an exactly-f32-representable numeric literal, else
    None (non-numeric, NaN, inf, huge, or rounding literals all refuse)."""
    if isinstance(v, bool) or not isinstance(
        v, (int, float, np.floating, np.integer)
    ):
        return None
    try:
        f = np.float32(v)
        if np.isnan(f) or np.isinf(f):
            return None
        if float(f) != float(v):
            return None
    except (ValueError, TypeError, OverflowError):
        return None
    return int(_f32_ordered_i32(np.array([f], dtype=np.float32))[0])


def _col_is_f32(name: str, dtypes: Optional[Dict[str, str]]) -> bool:
    return bool(dtypes) and dtypes.get(name) == "float32"


def narrow_expr_to_i32(
    expr: Expr, dtypes: Optional[Dict[str, str]] = None
) -> Optional[Expr]:
    """Rewrite a (string-literal-bound) predicate into an equivalent form
    whose every literal is an int32-safe Python int, or None if the
    expression is not int32-representable. float32 columns compare through
    the order-preserving int32 encoding. IN over ints becomes an OR chain."""
    if isinstance(expr, (And, Or)):
        l = narrow_expr_to_i32(expr.left, dtypes)
        r = narrow_expr_to_i32(expr.right, dtypes)
        if l is None or r is None:
            return None
        return type(expr)(l, r)
    if isinstance(expr, Not):
        c = narrow_expr_to_i32(expr.child, dtypes)
        return None if c is None else Not(c)
    if isinstance(expr, Cmp):
        left, right = expr.left, expr.right
        if isinstance(left, Col) and isinstance(right, Lit):
            if _col_is_f32(left.name, dtypes):
                enc = _f32_scalar_ordered(right.value)
                return None if enc is None else Cmp(expr.op, left, Lit(enc))
            return expr if _fits_i32(right.value) else None
        if isinstance(left, Lit) and isinstance(right, Col):
            if _col_is_f32(right.name, dtypes):
                enc = _f32_scalar_ordered(left.value)
                return None if enc is None else Cmp(expr.op, Lit(enc), right)
            return expr if _fits_i32(left.value) else None
        if isinstance(left, Col) and isinstance(right, Col):
            if _col_is_f32(left.name, dtypes) != _col_is_f32(right.name, dtypes):
                return None
            return expr
        return None
    if isinstance(expr, In):
        if not isinstance(expr.child, Col) or not expr.values:
            return None
        if _col_is_f32(expr.child.name, dtypes):
            encs = [_f32_scalar_ordered(v) for v in expr.values]
            if any(e is None for e in encs):
                return None
            vals = [int(e) for e in encs]
        else:
            if not all(_fits_i32(v) for v in expr.values):
                return None
            vals = [int(v) for v in expr.values]
        out: Expr = Cmp("eq", expr.child, Lit(vals[0]))
        for v in vals[1:]:
            out = Or(out, Cmp("eq", expr.child, Lit(v)))
        return out
    return None


def narrow_arrays_to_i32(
    arrays: Dict[str, np.ndarray]
) -> Optional[Dict[str, np.ndarray]]:
    """Cast integer/bool columns to int32 (range-checking 64-bit data) and
    float32 columns to their order-preserving int32 encoding; None if any
    column cannot narrow losslessly (float32 with NaNs included)."""
    out: Dict[str, np.ndarray] = {}
    for name, a in arrays.items():
        if a.dtype == np.int32:
            out[name] = a
        elif a.dtype == np.bool_:
            out[name] = a.astype(np.int32)
        elif a.dtype.kind in ("i", "u"):
            if a.size and (a.min() < _I32_MIN or a.max() > _I32_MAX - 1):
                return None
            out[name] = a.astype(np.int32)
        elif a.dtype == np.float32:
            if a.size and np.isnan(a).any():
                return None
            out[name] = _f32_ordered_i32(a)
        else:
            return None
    return out


# ---------------------------------------------------------------------------
# Kernel 1: predicate mask
# ---------------------------------------------------------------------------
OP_CMP_LIT, OP_CMP_COL, OP_AND, OP_OR, OP_NOT = range(5)
_CMP_CODE = {"eq": 0, "ne": 1, "lt": 2, "le": 3, "gt": 4, "ge": 5}
_SWAP = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le", "eq": "eq", "ne": "ne"}


def _stack_need(e: Expr) -> int:
    """Stack slots the lowering of ``e`` uses (deeper operand first)."""
    if isinstance(e, (And, Or)):
        a, b = _stack_need(e.left), _stack_need(e.right)
        return max(a, b) if a != b else a + 1
    if isinstance(e, Not):
        return _stack_need(e.child)
    return 1


def lower_predicate(bound: Expr, names: Tuple[str, ...]) -> np.ndarray:
    """Lower a narrowed predicate (``narrow_expr_to_i32`` output: only
    And/Or/Not/Cmp with int32 literals) to the kernel's postfix program,
    int32 ``(n_instr, 4)``. Column operands are indices into ``names``.
    AND/OR emit their deeper operand first (both are commutative), which
    keeps the stack at most log2(leaves) + 1 deep — far inside the
    kernel's 64 slots."""
    slot = {n: i for i, n in enumerate(names)}
    prog: List[Tuple[int, int, int, int]] = []

    def emit(e: Expr) -> None:
        if isinstance(e, (And, Or)):
            first, second = e.left, e.right
            if _stack_need(second) > _stack_need(first):
                first, second = second, first
            emit(first)
            emit(second)
            prog.append((OP_AND if isinstance(e, And) else OP_OR, 0, 0, 0))
            return
        if isinstance(e, Not):
            emit(e.child)
            prog.append((OP_NOT, 0, 0, 0))
            return
        if isinstance(e, Cmp):
            left, right, op = e.left, e.right, e.op
            if isinstance(left, Lit) and isinstance(right, Col):
                left, right, op = right, left, _SWAP[op]
            if isinstance(left, Col) and isinstance(right, Lit):
                prog.append((OP_CMP_LIT, slot[left.name], _CMP_CODE[op], int(right.value)))
                return
            if isinstance(left, Col) and isinstance(right, Col):
                prog.append((OP_CMP_COL, slot[left.name], _CMP_CODE[op], slot[right.name]))
                return
        raise HyperspaceException(f"Cannot lower predicate node {e!r}.")

    if _stack_need(bound) > 64:
        raise HyperspaceException("Predicate too deep for the mask kernel.")
    emit(bound)
    return np.array(prog, dtype=np.int32).reshape(-1, 4)


def run_postfix_reference(prog: np.ndarray, cols: List[torch.Tensor]) -> torch.Tensor:
    """Interpret a lowered program with torch ops (the kernel's semantics,
    for testing the lowering on the CPU)."""
    ops = [
        lambda a, b: a == b, lambda a, b: a != b, lambda a, b: a < b,
        lambda a, b: a <= b, lambda a, b: a > b, lambda a, b: a >= b,
    ]
    stack: List[torch.Tensor] = []
    for opc, a, b, c in prog.tolist():
        if opc == OP_CMP_LIT:
            stack.append(ops[b](cols[a], c))
        elif opc == OP_CMP_COL:
            stack.append(ops[b](cols[a], cols[c]))
        elif opc == OP_NOT:
            stack.append(~stack.pop())
        else:
            top = stack.pop()
            below = stack.pop()
            stack.append(top & below if opc == OP_AND else top | below)
    return stack[-1]


def predicate_mask_reference(
    bound: Expr, names: Tuple[str, ...], cols: List[torch.Tensor]
) -> torch.Tensor:
    """Plain version of K1: ``eval_mask`` in torch over the narrowed int32
    columns (a rows-free int32 schema shim, as the reference's kernel
    body uses)."""
    shim = ColumnarBatch(
        {name: Column("int32", np.empty(0, dtype=np.int32)) for name in names}
    )
    return eval_mask(bound, shim, dict(zip(names, cols)))


def predicate_mask_tensor(
    bound: Expr, names: Tuple[str, ...], cols: List[torch.Tensor]
) -> torch.Tensor:
    """Bool mask of the narrowed predicate ``bound`` over int32 columns
    ``cols`` (ordered as ``names``). CPU tensors take the plain version;
    CUDA tensors launch K1."""
    if cols[0].device.type == "cpu":
        return predicate_mask_reference(bound, names, cols)
    n = int(cols[0].shape[0])
    for t in cols:
        _check_cuda(t, torch.int32, "predicate_mask")
        if int(t.shape[0]) != n:
            raise HyperspaceException("predicate_mask: ragged columns.")
    dev = cols[0].device
    prog = torch.from_numpy(lower_predicate(bound, names)).to(dev)
    ptrs = torch.tensor([t.data_ptr() for t in cols], dtype=torch.int64, device=dev)
    out = torch.empty(n, dtype=torch.uint8, device=dev)
    lib = _lib(K1)
    rc = lib.hs_predicate_mask(
        ptrs.data_ptr(), prog.data_ptr(), int(prog.shape[0]), n, out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _check_launch(rc, "predicate_mask")
    count_launch(K1)
    return out.view(torch.bool)


def prepare_predicate(
    bound: Expr, arrays: Dict[str, np.ndarray]
) -> Optional[Tuple[Expr, Tuple[str, ...], Dict[str, np.ndarray]]]:
    """The reference's eligibility: (narrowed predicate, column names,
    int32 host columns), or None when the predicate or data do not narrow
    to int32."""
    f32_cols = {
        name: "float32" for name, a in arrays.items() if a.dtype == np.float32
    }
    narrowed = narrow_expr_to_i32(bound, f32_cols or None)
    if narrowed is None:
        return None
    names = tuple(sorted(bound.columns()))
    i32 = narrow_arrays_to_i32({n: arrays[n] for n in names})
    if i32 is None:
        return None
    return narrowed, names, i32


def predicate_mask(
    bound: Expr,
    arrays: Dict[str, np.ndarray],
    n_rows: int,
    device: DeviceLike = None,
) -> Optional[np.ndarray]:
    """Evaluate ``bound`` (string literals already bound) over host
    ``arrays`` on ``device``. Returns a bool mask of length ``n_rows``, or
    None when the predicate/data do not narrow to int32 (the caller then
    takes the torch-ops arm, as the reference takes its XLA arm)."""
    prep = prepare_predicate(bound, arrays)
    if prep is None:
        return None
    narrowed, names, i32 = prep
    dev = resolve_device(device)
    # np.require copies only read-only (mmap) views: torch wants writable
    # host memory to wrap
    cols = [
        torch.from_numpy(np.require(i32[n][:n_rows], requirements=["C", "W"])).to(dev)
        for n in names
    ]
    return predicate_mask_tensor(narrowed, names, cols).cpu().numpy()


# ---------------------------------------------------------------------------
# Kernel 2: sorted-intersection join counts
# ---------------------------------------------------------------------------
def _tile_min_max(a32: np.ndarray, tile: int, n_tiles: int):
    """Vectorized per-tile (min, max) over the valid prefix of each tile;
    the ragged tail tile reduces over its valid elements only."""
    lo = np.full(n_tiles, _I32_MAX, dtype=np.int32)
    hi = np.full(n_tiles, _I32_MIN + 1, dtype=np.int32)
    n = len(a32)
    n_full = n // tile
    if n_full:
        body = a32[: n_full * tile].reshape(n_full, tile)
        lo[:n_full] = body.min(axis=1)
        hi[:n_full] = body.max(axis=1)
    if n_full < n_tiles and n > n_full * tile:
        tail = a32[n_full * tile :]
        lo[n_full], hi[n_full] = tail.min(), tail.max()
    return lo, hi


def _plan_sorted_intersect(l_keys: np.ndarray, r_sorted: np.ndarray):
    """Host planning, as the reference's: joint int32 narrowing, tile
    padding, and per-left-tile right span planning. Returns (s_tile, span,
    base, l_p, r_p, l32, r32, wide) or None when the kernel declines."""
    n_l, n_r = len(l_keys), len(r_sorted)
    lo_all = min(int(l_keys.min()), int(r_sorted.min()))
    hi_all = max(int(l_keys.max()), int(r_sorted.max()))
    if hi_all - lo_all >= _I32_MAX - 1:
        return None
    l32 = (l_keys - lo_all).astype(np.int32)
    r32 = (r_sorted - lo_all).astype(np.int32)
    n_l_pad = -(-n_l // SMJ_TILE) * SMJ_TILE
    n_r_pad = -(-n_r // SMJ_TILE) * SMJ_TILE
    n_l_tiles = n_l_pad // SMJ_TILE
    l_lo, l_hi = _tile_min_max(l32, SMJ_TILE, n_l_tiles)
    start_pos = np.searchsorted(r32, l_lo, side="left")
    end_pos = np.searchsorted(r32, l_hi, side="right")
    s_tile = (start_pos // SMJ_TILE).astype(np.int32)
    e_tile_excl = np.maximum(-(-end_pos // SMJ_TILE), s_tile).astype(np.int32)
    span = (e_tile_excl - s_tile).astype(np.int32)
    wide = span > SMJ_MAX_SPAN_TILES
    if wide.mean() > 0.25:
        return None
    if wide.any():
        span = np.where(wide, 0, span).astype(np.int32)
        s_tile = np.where(wide, 0, s_tile).astype(np.int32)
    base = (s_tile.astype(np.int64) * SMJ_TILE).astype(np.int32)
    l_p = np.full(n_l_pad, _I32_MAX, dtype=np.int32)
    l_p[:n_l] = l32
    r_p = np.full(n_r_pad, _I32_MAX, dtype=np.int32)
    r_p[:n_r] = r32
    return s_tile, span, base, l_p, r_p, l32, r32, wide


def sorted_intersect_counts_reference(
    l: torch.Tensor, r: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K2: ``torch.searchsorted`` left and right."""
    lt = torch.searchsorted(r, l, side="left")
    eq = torch.searchsorted(r, l, side="right") - lt
    return lt.to(torch.int32), eq.to(torch.int32)


def sorted_intersect_tensors(
    s_tile: torch.Tensor,
    span: torch.Tensor,
    base: torch.Tensor,
    l: torch.Tensor,
    r: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lt, eq) int32 for the padded, planned operands. CPU tensors take
    the plain version (exact on every tile, wide ones included); CUDA
    tensors launch K2 (wide tiles come back as their base, for the caller
    to fix up, as in the reference)."""
    if l.device.type == "cpu":
        return sorted_intersect_counts_reference(l, r)
    for t, what in ((s_tile, "s_tile"), (span, "span"), (base, "base"), (l, "l"), (r, "r")):
        _check_cuda(t, torch.int32, f"sorted_intersect {what}")
    n_l = int(l.shape[0])
    if n_l % SMJ_TILE or int(span.shape[0]) != n_l // SMJ_TILE:
        raise HyperspaceException("sorted_intersect: left keys not tile-padded.")
    lt = torch.empty(n_l, dtype=torch.int32, device=l.device)
    eq = torch.empty(n_l, dtype=torch.int32, device=l.device)
    lib = _lib(K2)
    rc = lib.hs_sorted_intersect(
        l.data_ptr(), r.data_ptr(), s_tile.data_ptr(), span.data_ptr(),
        base.data_ptr(), n_l, lt.data_ptr(), eq.data_ptr(),
        torch.cuda.current_stream(l.device).cuda_stream,
    )
    _check_launch(rc, "sorted_intersect")
    count_launch(K2)
    return lt, eq


def sorted_intersect_counts(
    l_keys: np.ndarray, r_sorted: np.ndarray, device: DeviceLike = None
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """For each left key (any order), against an ascending-sorted right key
    array: (count of right keys < key, count of right keys == key) as
    int64 — searchsorted-left positions and run lengths, computed on
    ``device``. None when the reference's plan declines (int32 overflow of
    the joint key range, or more than a quarter of the left tiles wide)."""
    n_l, n_r = len(l_keys), len(r_sorted)
    if n_l == 0 or n_r == 0:
        z = np.zeros(n_l, dtype=np.int64)
        return z, z.copy()
    plan = _plan_sorted_intersect(l_keys, r_sorted)
    if plan is None:
        return None
    s_tile, span, base, l_p, r_p, l32, r32, wide = plan
    dev = resolve_device(device)
    args = [torch.from_numpy(a).to(dev) for a in (s_tile, span, base, l_p, r_p)]
    lt_d, eq_d = sorted_intersect_tensors(*args)
    lt = lt_d.cpu().numpy()[:n_l].astype(np.int64)
    eq = eq_d.cpu().numpy()[:n_l].astype(np.int64)
    if wide.any():
        for t in np.flatnonzero(wide):
            s, e = int(t) * SMJ_TILE, min((int(t) + 1) * SMJ_TILE, n_l)
            q = l32[s:e]
            lt[s:e] = np.searchsorted(r32, q, side="left")
            eq[s:e] = np.searchsorted(r32, q, side="right") - lt[s:e]
    return lt, eq
