"""HS007 — device dispatch timed without a fence.

A CUDA launch returns to the host as soon as the work is queued: a
``time.perf_counter()`` span around a torch op or a hand-kernel launch
that never waits for the card times the enqueue and reports microseconds
for real device work. Every device timing in this package must wait for
its result inside the span — ``ops.fence``, ``torch.cuda.synchronize``,
an event's or stream's ``synchronize()``, a ``DeviceFetch``'s ``wait()``
or a readback (``.item()``, ``.cpu()``, ``.tolist()``, ``np.asarray``)
— before the closing ``perf_counter()`` lands. This rule
machine-enforces that.

The torch/CUDA device model (counterpart of the reference rule, whose
dispatches are ``jax.*`` calls):
  * a TIMING SPAN is ``t0 = time.perf_counter()`` followed, in the same
    function (or at module top level), by an expression computing
    ``time.perf_counter() - t0`` — the span is the line range between
    the two;
  * a DEVICE DISPATCH inside the span is a call whose resolved dotted
    name starts with ``torch.`` and is not one of the host-only calls
    below (device and stream handles, capability queries, ``from_numpy``
    and the like), or a call to one of ``ops/kernels.py``'s launching
    wrappers (``KERNEL_WRAPPERS``). The port reaches the wrappers through
    relative imports (``from ..ops import kernels``), which
    ``build_aliases`` leaves unmapped, so they are matched by name
    suffix, like the fences;
  * a FENCE inside the span is ``torch.cuda.synchronize``, any
    ``.synchronize()``, ``.item()``, ``.cpu()``, ``.tolist()``,
    ``numpy.asarray``, ``fence`` (``ops.fence``, any import spelling) or
    ``.wait()`` on a ``DeviceFetch`` (a receiver built by
    ``DeviceFetch(...)`` or named like a fetch). On CUDA these are true
    waits. An event that is recorded (``ev.record()``) and never
    synchronized is NOT a fence: recording only queues a marker;
  * spans containing a dispatch but no fence are flagged at the dispatch.

Blind spots: a tensor METHOD (``t.to(dev)``, ``t.sum()``) is rooted in a
variable and not resolvable, and a dispatch through a helper of another
module is not followed (intra-procedural) — such dispatches are caught
only when the span's fence is missing for another reason too.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, Iterator, List, Optional, Tuple

from ..core import ModuleContext, Rule, dotted_name, terminal_name

SCOPE = (
    "hyperspace_tpu_torch/exec/",
    "hyperspace_tpu_torch/ops/",
    "hyperspace_tpu_torch/serve/",
    "hyperspace_tpu_torch/index/",
    "hyperspace_tpu_torch/parallel/",
)

# torch calls that run on the host only: handles, queries and guards that
# queue no work on the card
HOST_ONLY = frozenset(
    {
        "torch.device",
        "torch.dtype",
        "torch.finfo",
        "torch.iinfo",
        "torch.is_tensor",
        "torch.from_numpy",
        "torch.no_grad",
        "torch.inference_mode",
        "torch.manual_seed",
        "torch.get_num_threads",
        "torch.set_num_threads",
        "torch.cuda.is_available",
        "torch.cuda.device_count",
        "torch.cuda.current_device",
        "torch.cuda.set_device",
        "torch.cuda.device",
        "torch.cuda.get_device_name",
        "torch.cuda.get_device_properties",
        "torch.cuda.get_device_capability",
        "torch.cuda.Event",
        "torch.cuda.Stream",
        "torch.cuda.stream",
        "torch.cuda.current_stream",
        "torch.cuda.default_stream",
    }
)

# the public functions of ops/kernels.py that launch a hand-written kernel
# on a CUDA tensor, or reach one that does (``resident_mask_fn`` and
# ``resident_fused_agg_over_join`` upload their operands and hand back the
# launching closure)
KERNEL_WRAPPERS = frozenset(
    {
        "predicate_mask",
        "resident_mask_fn",
        "predicate_mask_tensor",
        "program_mask_tensor",
        "predicate_block_counts_tensor",
        "program_block_counts_tensor",
        "predicate_block_counts_packed_tensor",
        "program_block_counts_packed_tensor",
        "hybrid_block_counts_tensor",
        "resident_counts_tensor",
        "hybrid_counts_tensor",
        "predicate_block_counts_batch_tensor",
        "program_block_counts_batch_tensor",
        "hybrid_block_counts_batch_tensor",
        "program_hybrid_counts_batch_tensor",
        "sorted_intersect_fences",
        "sorted_intersect_tensors",
        "sorted_intersect_packed_tensors",
        "sorted_intersect_counts",
        "sorted_intersect_counts_deferred",
        "resident_sorted_intersect",
        "resident_fused_agg_over_join",
    }
)

_FENCE_ATTRS = frozenset({"synchronize", "item", "cpu", "tolist"})
_FETCHISH_RE = re.compile(r"fetch", re.I)


def _is_perf_counter(node: ast.AST, aliases: Dict[str, str]) -> bool:
    return (
        isinstance(node, ast.Call)
        and dotted_name(node.func, aliases) == "time.perf_counter"
    )


def _suffix_in(resolved: str, names) -> bool:
    return resolved.rsplit(".", 1)[-1] in names


def _is_fence(call: ast.Call, resolved: str) -> bool:
    if resolved in ("numpy.asarray", "torch.cuda.synchronize"):
        return True
    if resolved == "fence" or resolved.endswith(".fence"):
        return True
    func = call.func
    if not isinstance(func, ast.Attribute):
        return False
    if func.attr in _FENCE_ATTRS:
        return True
    if func.attr == "wait":
        recv = func.value
        if isinstance(recv, ast.Call):
            return (terminal_name(recv.func) or "") == "DeviceFetch"
        return bool(_FETCHISH_RE.search(terminal_name(recv) or ""))
    return False


class UnfencedDeviceTimingRule(Rule):
    code = "HS007"
    name = "unfenced-device-timing"
    description = (
        "a time.perf_counter() span encloses a torch or hand-kernel dispatch "
        "with no fence (ops.fence/torch.cuda.synchronize/synchronize()/"
        "DeviceFetch.wait or a readback) before the closing perf_counter()"
    )

    def applies_to(self, posix_path: str) -> bool:
        return any(s in posix_path for s in SCOPE)

    def check(self, ctx: ModuleContext) -> Iterator[Tuple[int, int, str]]:
        scopes: List[ast.AST] = [ctx.tree]
        for node in ast.walk(ctx.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                scopes.append(node)
        for scope in scopes:
            yield from self._check_scope(scope, ctx)

    def _own_walk(self, scope: ast.AST):
        """Walk a scope's body WITHOUT descending into nested function
        definitions (each nested def is its own scope — its spans and
        dispatches must not leak into the enclosing one)."""
        stack = list(
            getattr(scope, "body", [])
            + getattr(scope, "orelse", [])
            + getattr(scope, "finalbody", [])
        )
        while stack:
            node = stack.pop()
            yield node
            if isinstance(
                node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
            ):
                continue  # nested scope: analyzed on its own
            stack.extend(ast.iter_child_nodes(node))

    def _check_scope(
        self, scope: ast.AST, ctx: ModuleContext
    ) -> Iterator[Tuple[int, int, str]]:
        # two passes (the walk order is not source order): first bind every
        # ``t = perf_counter()``, then match every ``perf_counter() - t``
        starts: Dict[str, int] = {}  # var -> lineno of t = perf_counter()
        nodes = list(self._own_walk(scope))
        for node in nodes:
            if isinstance(node, ast.Assign) and _is_perf_counter(
                node.value, ctx.aliases
            ):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        starts[t.id] = node.lineno
        spans: List[Tuple[int, int]] = []
        for node in nodes:
            if (
                isinstance(node, ast.BinOp)
                and isinstance(node.op, ast.Sub)
                and isinstance(node.right, ast.Name)
                and node.right.id in starts
                and _is_perf_counter(node.left, ctx.aliases)
            ):
                spans.append((starts[node.right.id], node.lineno))
        if not spans:
            return
        dispatches: List[Tuple[int, int, str]] = []
        fences: List[int] = []
        for node in nodes:
            if not isinstance(node, ast.Call):
                continue
            resolved = dotted_name(node.func, ctx.aliases) or ""
            if _is_fence(node, resolved):
                fences.append(node.lineno)
            elif (
                resolved.startswith("torch.") and resolved not in HOST_ONLY
            ) or (resolved and _suffix_in(resolved, KERNEL_WRAPPERS)):
                dispatches.append((node.lineno, node.col_offset, resolved))
        for lo, hi in spans:
            if any(lo < f <= hi for f in fences):
                continue
            flagged: Optional[Tuple[int, int, str]] = None
            for line, col, name in dispatches:
                if lo < line <= hi and (
                    flagged is None or line < flagged[0]
                ):
                    flagged = (line, col, name)
            if flagged is not None:
                line, col, name = flagged
                yield (
                    line,
                    col,
                    f"'{name}' dispatch inside a perf_counter span with no "
                    "fence; a CUDA launch returns once queued, so this times "
                    "the enqueue, not the work — wait with ops.fence / "
                    "torch.cuda.synchronize (or read the result back) before "
                    "closing the timer",
                )
