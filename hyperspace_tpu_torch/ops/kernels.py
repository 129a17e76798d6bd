"""The query hot path's hand-written CUDA kernels and their wrappers.

Counterpart of ``hyperspace_tpu.ops.kernels``, whose two Pallas kernels
become CUDA C++ for Hopper (``csrc/``):

1. **Predicate mask** (``predicate_mask`` → ``csrc/predicate_mask.cu``,
   replacing ``_build_mask_call``): a filter predicate over int32-narrowed
   columns, lowered on the host to a postfix program (cached per
   predicate) that rides in the launch's parameter block and that the
   kernel interprets once per 32 rows, so one build serves every
   predicate. Its second entry, K1c (``predicate_block_counts_tensor``),
   fuses a match count per 8192-row block for the HBM-resident scan
   (``exec/hbm_cache.py``).
2. **Sorted-intersection join counts** (``sorted_intersect_counts`` →
   ``csrc/sorted_intersect.cu``, replacing ``_build_smj_call``): for each
   left key against ascending right keys, (#right < key, #right == key) —
   the match range of the bucketed sort-merge join.

The ``resident_*`` entry points run the same kernels over operands
uploaded once (the reference's microbench primitives and its fused
aggregate-over-join).

The int32 narrowing (``narrow_expr_to_i32`` / ``narrow_arrays_to_i32``)
and the host span planning (``_plan_sorted_intersect``) are copies of the
reference, so both packages accept and decline exactly the same inputs
(a decline returns None and the caller takes the reference's other arm).

Each tensor-level wrapper decides by the device its tensors lie on: a CPU
tensor goes to the plain torch version beside the kernel
(``predicate_mask_reference``, ``predicate_block_counts_reference``,
``sorted_intersect_counts_reference``); a
CUDA tensor launches the kernel or raises. There is no fallback from a
failed launch. The kernels build with ``nvcc`` for ``sm_90a`` on first use
into ``hyperspace_tpu_torch/_build/`` and load through ``ctypes``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import struct
import subprocess
import threading
import time
from collections import OrderedDict
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..exceptions import HyperspaceException
from ..plan.expr import And, Cmp, Col, Expr, In, Lit, Not, Or, eval_mask
from ..storage.columnar import Column, ColumnarBatch
from ..telemetry.metrics import metrics
from . import DeviceLike, count_launch, resolve_device
from .floatbits import f32_to_ordered_i32 as _f32_ordered_i32

SMJ_TILE = 1024  # left/right tile of the join plan (8 x 128 keys)
_I32_MIN = -(2**31)
_I32_MAX = 2**31 - 1

# A left tile whose key range overlaps more right tiles than this is
# fixed up on the host (the reference's SMJ_MAX_SPAN_TILES).
SMJ_MAX_SPAN_TILES = 64

K1 = "predicate_mask"
K1C = "predicate_block_counts"  # K1's block-count entry, same source
K2 = "sorted_intersect"
BLOCK_ROWS = 8192  # K1c's count granularity (the resident scan's block)

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
    the named kernels' libraries; already-built ones are reused. Each
    build keeps ``ptxas -v``'s report (registers, stack frame, spills per
    kernel) beside its library (``build_report``)."""
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
                "-std=c++17", "-O3", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
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
                so.with_suffix(".ptxas.txt").write_bytes(out)
                os.replace(tmp, so)
        if failed:
            raise HyperspaceException("nvcc failed:\n" + "\n".join(failed))
        for n in todo:
            lib = ctypes.CDLL(str(_lib_path(n)[1]))
            vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
            if n == K1:
                lib.hs_predicate_param_bytes.argtypes = []
                lib.hs_predicate_param_bytes.restype = ci
                if lib.hs_predicate_param_bytes() != _PARAM_DTYPE.itemsize:
                    raise HyperspaceException(
                        "predicate_mask.cu's parameter block is "
                        f"{lib.hs_predicate_param_bytes()} bytes; ops/kernels.py "
                        f"packs {_PARAM_DTYPE.itemsize}."
                    )
                for entry in (lib.hs_predicate_mask, lib.hs_predicate_block_counts):
                    entry.argtypes = [ctypes.c_char_p, vp]
                    entry.restype = ci
            else:
                lib.hs_sorted_intersect.argtypes = [vp, vp, vp, vp, vp, ll, vp, vp, vp]
                lib.hs_sorted_intersect.restype = ci
            _LIBS[n] = lib
        return dict(_LIBS)


def build_report(name: str) -> str:
    """``ptxas -v``'s output from building kernel ``name`` (empty when the
    library was built before reports were kept)."""
    log = _lib_path(name)[1].with_suffix(".ptxas.txt")
    return log.read_text(errors="replace") if log.exists() else ""


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


def _upload(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    # np.require copies only read-only (mmap) views: torch wants writable
    # host memory to wrap
    return torch.from_numpy(np.require(a, requirements=["C", "W"])).to(dev)


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


# ---------------------------------------------------------------------------
# K1/K1c launch: a lowered program and the columns' addresses travel in the
# kernel's parameter block (csrc/predicate_mask.cu:Params), so a launch
# copies nothing to the card first
# ---------------------------------------------------------------------------
K1_MAX_COLS = 16  # column addresses the parameter block holds
K1_MAX_PARAM_INSTR = 240  # instructions it holds; longer programs are staged
K1_STACK_SLOTS = 64
K1_MAX_SMEM = 232448 - 1024  # dynamic shared memory a launch may ask for
K1C_THREADS = 256  # K1c's CTA, the widest: shared memory is checked for it
_PARAM_DTYPE = np.dtype({
    "names": ["prog", "cols", "staged", "n_rows", "out", "n_cols", "n_instr", "depth",
              "col_table"],
    "formats": [(np.int32, (K1_MAX_PARAM_INSTR, 4)), (np.int64, (K1_MAX_COLS,)),
                np.int64, np.int64, np.int64, np.int32, np.int32, np.int32, np.int64],
    "offsets": [0, 3840, 3968, 3976, 3984, 3992, 3996, 4000, 4008],
    "itemsize": 4016,
})
_LOWER_CACHE_SIZE = 256  # as the reference's _mask_call_cache


def program_depth(prog: np.ndarray) -> int:
    """Peak stack depth of a postfix program; raises on a program that
    underflows, does not end with one value, or exceeds the kernel's
    stack."""
    depth = peak = 0
    for opc in prog[:, 0].tolist():
        if opc in (OP_CMP_LIT, OP_CMP_COL):
            depth += 1
        elif opc in (OP_AND, OP_OR):
            depth -= 1
        elif opc != OP_NOT:
            raise HyperspaceException(f"Unknown mask-kernel opcode {opc}.")
        if depth < 1:
            raise HyperspaceException("Mask-kernel program underflows its stack.")
        peak = max(peak, depth)
    if depth != 1:
        raise HyperspaceException("Mask-kernel program does not end with one value.")
    if peak > K1_STACK_SLOTS:
        raise HyperspaceException(
            f"Mask-kernel program needs {peak} stack slots (at most {K1_STACK_SLOTS})."
        )
    return peak


def k1_smem_bytes(n_instr: int, depth: int, threads: int) -> int:
    """Shared memory of a K1/K1c CTA: a staged program, then ``depth``
    stack words per thread."""
    staged = n_instr > K1_MAX_PARAM_INSTR
    return (16 * n_instr if staged else 0) + 4 * depth * threads


class K1Program:
    """A postfix program ready to launch: its instructions, stack depth and
    column count, and a parameter block with everything but the launch's
    addresses filled in. A program longer than ``K1_MAX_PARAM_INSTR`` is
    staged: it is copied to each card once (``on_device``) and every CTA
    loads it into shared memory. One that fits neither the parameter block
    nor shared memory raises. A program over more than ``K1_MAX_COLS``
    columns takes its addresses from a device array (``col_table``)."""

    def __init__(self, prog: np.ndarray, n_cols: int):
        prog = np.ascontiguousarray(prog, dtype=np.int32).reshape(-1, 4)
        if n_cols < 1:
            raise HyperspaceException("Mask kernel: a program over no columns.")
        cmp_rows = np.isin(prog[:, 0], (OP_CMP_LIT, OP_CMP_COL))
        used = np.concatenate([prog[cmp_rows, 1], prog[prog[:, 0] == OP_CMP_COL, 3]])
        if used.size and (used.min() < 0 or used.max() >= n_cols):
            raise HyperspaceException("Mask-kernel program names a missing column.")
        self.prog = prog
        self.n_cols = n_cols
        self.depth = program_depth(prog)
        smem = k1_smem_bytes(len(prog), self.depth, K1C_THREADS)
        if smem > K1_MAX_SMEM:
            raise HyperspaceException(
                f"Mask-kernel program of {len(prog)} instructions fits neither the "
                f"parameter block ({K1_MAX_PARAM_INSTR}) nor shared memory "
                f"({smem} > {K1_MAX_SMEM} bytes)."
            )
        self.staged = len(prog) > K1_MAX_PARAM_INSTR
        rec = np.zeros(1, dtype=_PARAM_DTYPE)
        if not self.staged:
            rec["prog"][0, : len(prog)] = prog
        rec["n_cols"], rec["n_instr"], rec["depth"] = n_cols, len(prog), self.depth
        self.template = rec.tobytes()
        self._on_device: Dict[torch.device, torch.Tensor] = {}

    def on_device(self, dev: torch.device) -> torch.Tensor:
        """The staged program on ``dev``, copied there on first use."""
        t = self._on_device.get(dev)
        if t is None:
            t = self._on_device[dev] = torch.from_numpy(self.prog.copy()).to(dev)
        return t

    def params(self, addrs: List[int], n_rows: int, out_addr: int, staged_addr: int = 0,
               table_addr: int = 0) -> bytes:
        """The launch's parameter block, as the kernel reads it. Over
        ``K1_MAX_COLS`` columns, ``table_addr`` is a device array of
        ``addrs`` (``col_table``) and the block holds no address."""
        if len(addrs) != self.n_cols:
            raise HyperspaceException(
                f"Mask kernel: {len(addrs)} columns for a program over {self.n_cols}."
            )
        if self.staged != bool(staged_addr):
            raise HyperspaceException("Mask kernel: staged address does not match the program.")
        if (self.n_cols > K1_MAX_COLS) != bool(table_addr):
            raise HyperspaceException(
                "Mask kernel: an address table goes with, and only with, more than "
                f"{K1_MAX_COLS} columns."
            )
        buf = bytearray(self.template)
        if table_addr:
            struct.pack_into("<q", buf, _PARAM_DTYPE.fields["col_table"][1], table_addr)
        else:
            struct.pack_into(f"<{len(addrs)}q", buf, _PARAM_DTYPE.fields["cols"][1], *addrs)
        # staged, n_rows and out lie back to back
        struct.pack_into("<3q", buf, _PARAM_DTYPE.fields["staged"][1],
                         staged_addr, n_rows, out_addr)
        return bytes(buf)


_LOWERED: "OrderedDict[tuple, K1Program]" = OrderedDict()
_LOWERED_LOCK = threading.Lock()


def lowered_predicate(bound: Expr, names: Tuple[str, ...]) -> K1Program:
    """``lower_predicate`` as a launchable program, cached by
    ``(repr(bound), names)`` (least recently used out beyond
    ``_LOWER_CACHE_SIZE``): the per-file scan's launches of one predicate
    lower it once."""
    key = (repr(bound), tuple(names))
    with _LOWERED_LOCK:
        hit = _LOWERED.get(key)
        if hit is not None:
            _LOWERED.move_to_end(key)
            return hit
    program = K1Program(lower_predicate(bound, names), len(names))
    with _LOWERED_LOCK:
        _LOWERED[key] = program
        while len(_LOWERED) > _LOWER_CACHE_SIZE:
            _LOWERED.popitem(last=False)
    return program


def k1_column_addrs(cols: List[torch.Tensor], what: str) -> List[int]:
    """The columns' addresses, checked: equal lengths, each 16-byte
    aligned (the kernels read 16 bytes at a time)."""
    n = int(cols[0].shape[0])
    addrs = []
    for t in cols:
        if int(t.shape[0]) != n:
            raise HyperspaceException(f"{what}: ragged columns.")
        if t.data_ptr() % 16:
            raise HyperspaceException(
                f"{what}: column at {t.data_ptr():#x} is not 16-byte aligned."
            )
        addrs.append(t.data_ptr())
    return addrs


def _launch_k1(entry: str, what: str, program: K1Program, cols, n: int, out) -> None:
    for t in cols:
        _check_cuda(t, torch.int32, what)
    dev = cols[0].device
    staged = program.on_device(dev).data_ptr() if program.staged else 0
    addrs = k1_column_addrs(cols, what)
    table = None
    if len(addrs) > K1_MAX_COLS:
        # more addresses than the parameters hold: a device array for this
        # launch (freed after it, stream-ordered, by the caching allocator)
        table = torch.tensor(addrs, dtype=torch.int64).to(dev)
    params = program.params(addrs, n, out.data_ptr(), staged,
                            0 if table is None else table.data_ptr())
    if n == 0:  # nothing to launch, and so nothing to count
        return
    rc = getattr(_lib(K1), entry)(params, torch.cuda.current_stream(dev).cuda_stream)
    _check_launch(rc, what)
    count_launch(what)


def program_mask_tensor(program: K1Program, cols: List[torch.Tensor]) -> torch.Tensor:
    """Bool mask of a launchable program over int32 columns. CPU tensors
    take the plain version (``run_postfix_reference``); CUDA tensors
    launch K1."""
    if cols[0].device.type == "cpu":
        return run_postfix_reference(program.prog, cols)
    n = int(cols[0].shape[0])
    out = torch.empty(n, dtype=torch.uint8, device=cols[0].device)
    _launch_k1("hs_predicate_mask", K1, program, cols, n, out)
    return out.view(torch.bool)


def predicate_mask_tensor(
    bound: Expr, names: Tuple[str, ...], cols: List[torch.Tensor]
) -> torch.Tensor:
    """Bool mask of the narrowed predicate ``bound`` over int32 columns
    ``cols`` (ordered as ``names``). CPU tensors take the plain version;
    CUDA tensors launch K1 with the cached lowering."""
    if cols[0].device.type == "cpu":
        return predicate_mask_reference(bound, names, cols)
    return program_mask_tensor(lowered_predicate(bound, names), cols)


def predicate_block_counts_reference(
    bound: Expr, names: Tuple[str, ...], cols: List[torch.Tensor]
) -> torch.Tensor:
    """Plain version of K1c: K1's plain mask summed per ``BLOCK_ROWS``
    rows, int32."""
    mask = predicate_mask_reference(bound, names, cols)
    return mask.view(-1, BLOCK_ROWS).sum(1, dtype=torch.int32)


def _check_blocked(cols: List[torch.Tensor]) -> int:
    n = int(cols[0].shape[0])
    if n % BLOCK_ROWS:
        raise HyperspaceException(
            f"{K1C}: {n} rows is not a multiple of {BLOCK_ROWS}."
        )
    return n


def program_block_counts_tensor(
    program: K1Program, cols: List[torch.Tensor]
) -> torch.Tensor:
    """int32 match count of a launchable program per ``BLOCK_ROWS`` rows.
    CPU tensors take the plain version; CUDA tensors launch K1c."""
    n = _check_blocked(cols)
    if cols[0].device.type == "cpu":
        mask = run_postfix_reference(program.prog, cols)
        return mask.view(-1, BLOCK_ROWS).sum(1, dtype=torch.int32)
    counts = torch.empty(n // BLOCK_ROWS, dtype=torch.int32, device=cols[0].device)
    _launch_k1("hs_predicate_block_counts", K1C, program, cols, n, counts)
    return counts


def predicate_block_counts_tensor(
    bound: Expr, names: Tuple[str, ...], cols: List[torch.Tensor]
) -> torch.Tensor:
    """int32 match count of the narrowed predicate per ``BLOCK_ROWS`` rows
    of the int32 columns ``cols``, whose length must be a multiple of
    ``BLOCK_ROWS`` (resident planes are zero-padded so; pad rows count
    when they satisfy the predicate, as in the reference). CPU tensors
    take the plain version; CUDA tensors launch K1c with the cached
    lowering."""
    _check_blocked(cols)
    if cols[0].device.type == "cpu":
        return predicate_block_counts_reference(bound, names, cols)
    return program_block_counts_tensor(lowered_predicate(bound, names), cols)


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
    cols = [_upload(i32[n][:n_rows], dev) for n in names]
    return predicate_mask_tensor(narrowed, names, cols).cpu().numpy()


def resident_mask_fn(bound: Expr, arrays: Dict[str, np.ndarray], device: DeviceLike = None):
    """Device-resident variant of ``predicate_mask``: narrows and uploads
    ``arrays`` once and lowers the program once. Returns ``(dispatch,
    cols)``: ``dispatch(cols)`` launches K1 (no host→device copy: the
    program rides in the launch's parameters) and returns the device bool
    mask (no readback; the caller fences). ``(None, None)`` when the
    predicate or data do not narrow to int32 (the reference's decline)."""
    prep = prepare_predicate(bound, arrays)
    if prep is None:
        return None, None
    narrowed, names, i32 = prep
    dev = resolve_device(device)
    cols = [_upload(i32[n], dev) for n in names]
    program = lowered_predicate(narrowed, names)
    return (lambda device_cols: program_mask_tensor(program, device_cols)), cols


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


def resident_sorted_intersect(
    l_keys: np.ndarray, r_sorted: np.ndarray, device: DeviceLike = None
):
    """Device-resident variant of ``sorted_intersect_counts``: the host
    planning and the uploads happen once, and the returned zero-argument
    ``run()`` launches K2, returning the device ``(lt, eq)`` int32 tensors
    (tile-padded; no readback). ``run.d_args`` are the resident operands.
    None where the reference declines: an empty side, a declined plan, or
    any wide tile (timing wants the pure-kernel shape)."""
    if len(l_keys) == 0 or len(r_sorted) == 0:
        return None
    plan = _plan_sorted_intersect(l_keys, r_sorted)
    if plan is None or plan[-1].any():
        return None
    dev = resolve_device(device)
    d_args = [torch.from_numpy(a).to(dev) for a in plan[:5]]

    def run():
        return sorted_intersect_tensors(*d_args)

    run.d_args = d_args
    return run


def _loop_seconds(fn, k: int, repeats: int, dev: torch.device) -> float:
    """Median seconds of ``k`` back-to-back calls of ``fn``: CUDA events
    around the launches on the card, the host clock on the CPU."""
    times = []
    for _ in range(repeats):
        if dev.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _i in range(k):
                fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b) / 1e3)
        else:
            t0 = time.perf_counter()
            for _i in range(k):
                fn()
            times.append(time.perf_counter() - t0)
    return float(np.median(times))


def resident_smj_amortized(
    l_keys: np.ndarray,
    r_sorted: np.ndarray,
    iters: int,
    repeats: int = 5,
    prepared=None,
    device: DeviceLike = None,
) -> Optional[float]:
    """Per-launch seconds of K2 over resident operands: the time of an
    ``iters``-launch loop minus a 1-launch loop, over ``iters - 1`` (the
    reference differences a ``fori_loop`` the same way), so the fixed
    per-measurement cost cancels. ``prepared`` (a
    ``resident_sorted_intersect`` runner) reuses its operands. None where
    ``resident_sorted_intersect`` declines."""
    if iters < 2:
        raise ValueError(
            "resident_smj_amortized needs iters >= 2 (it differences a "
            f"{iters}-iteration loop against a 1-iteration one)"
        )
    run = prepared or resident_sorted_intersect(l_keys, r_sorted, device)
    if run is None:
        return None
    dev = run.d_args[0].device
    run()  # warm: the first launch loads the kernel's library
    w1 = _loop_seconds(run, 1, repeats, dev)
    wk = _loop_seconds(run, iters, repeats, dev)
    return max(wk - w1, 1e-9) / (iters - 1)


def _int64_safe(a: np.ndarray) -> bool:
    # signed ints embed exactly; unsigned only up to 32 bits (uint64 >=
    # 2**63 would wrap negative in the int64 cast and de-sort the operands)
    return a.dtype.kind == "i" or (a.dtype.kind == "u" and a.dtype.itemsize <= 4)


def resident_fused_agg_over_join(
    l_keys: np.ndarray,
    r_sorted: np.ndarray,
    r_vals_sorted: np.ndarray,
    l_groups: np.ndarray,
    n_groups: int,
    device: DeviceLike = None,
):
    """Q17-shaped aggregate over a join, on resident operands: for each
    left row its match range in the ascending right keys, the sum of the
    right values over that range (prefix-sum differences, exact int64,
    wraparound cancels), and both accumulated per left group. Returns a
    zero-argument ``run()`` giving device int64 ``(group_pair_counts,
    group_value_sums)`` of length ``n_groups``, or None where the
    reference refuses (an empty side, non-integer or unsafe dtypes, a
    right key equal to int64 max, group codes out of range).

    When K2's plan accepts the operands with no wide tile, the match
    ranges come from K2 and the epilogue (range sums, the group
    permutation, int64 cumsum and boundary differences — a jnp program in
    the reference) runs in torch ops; otherwise ``torch.searchsorted`` and
    ``index_add_`` compute the same on the device, the reference's other
    arm. Counted as ``fused_agg.path.kernel`` / ``fused_agg.path.torch``."""
    n_l, n_r = len(l_keys), len(r_sorted)
    if n_l == 0 or n_r == 0 or n_groups <= 0:
        return None
    if not (_int64_safe(l_keys) and _int64_safe(r_sorted)):
        return None
    if not _int64_safe(r_vals_sorted) or len(r_vals_sorted) != n_r:
        return None
    if int(r_sorted[-1]) == np.iinfo(np.int64).max:
        return None
    if len(l_groups) != n_l:
        return None
    # range-check BEFORE the int32 cast: a 2^32-offset code would wrap
    # into range and silently corrupt the aggregation
    if int(np.min(l_groups)) < 0 or int(np.max(l_groups)) >= n_groups:
        return None
    g = np.ascontiguousarray(l_groups, dtype=np.int32)
    dev = resolve_device(device)
    rvc = np.zeros(n_r + 1, dtype=np.int64)
    np.cumsum(r_vals_sorted.astype(np.int64), out=rvc[1:])
    rvc_d = torch.from_numpy(rvc).to(dev)

    plan = _plan_sorted_intersect(l_keys, r_sorted)
    if plan is not None and not plan[-1].any():
        metrics.incr("fused_agg.path.kernel")
        d_smj = [torch.from_numpy(a).to(dev) for a in plan[:5]]
        # the group layout is static across dispatches: a stable
        # group-sort permutation turns the per-group sums into cumsum +
        # boundary differences
        perm = np.argsort(g, kind="stable")
        g_sorted = g[perm]
        grid = np.arange(n_groups, dtype=g_sorted.dtype)
        perm_d = torch.from_numpy(perm).to(dev)
        st_d = torch.from_numpy(np.searchsorted(g_sorted, grid, side="left")).to(dev)
        en_d = torch.from_numpy(np.searchsorted(g_sorted, grid, side="right")).to(dev)
        zero = torch.zeros(1, dtype=torch.int64, device=dev)

        def run_kernel():
            lt2, eq2 = sorted_intersect_tensors(*d_smj)
            lt = lt2[:n_l].to(torch.int64)
            eq = eq2[:n_l].to(torch.int64)
            rsum = rvc_d[lt + eq] - rvc_d[lt]
            cc = torch.cat([zero, torch.cumsum(eq[perm_d], 0)])
            rc = torch.cat([zero, torch.cumsum(rsum[perm_d], 0)])
            return cc[en_d] - cc[st_d], rc[en_d] - rc[st_d]

        return run_kernel

    metrics.incr("fused_agg.path.torch")
    l_d = torch.from_numpy(np.asarray(l_keys, dtype=np.int64)).to(dev)
    r_d = torch.from_numpy(np.ascontiguousarray(r_sorted, dtype=np.int64)).to(dev)
    g_d = torch.from_numpy(g.astype(np.int64)).to(dev)

    def run_torch():
        lt = torch.searchsorted(r_d, l_d, side="left")
        le = torch.searchsorted(r_d, l_d, side="right")
        gc = torch.zeros(n_groups, dtype=torch.int64, device=dev)
        gs = torch.zeros(n_groups, dtype=torch.int64, device=dev)
        gc.index_add_(0, g_d, le - lt)
        gs.index_add_(0, g_d, rvc_d[le] - rvc_d[lt])
        return gc, gs

    return run_torch
