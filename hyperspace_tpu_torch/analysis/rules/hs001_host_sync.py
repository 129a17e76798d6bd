"""HS001 — host-device synchronization in hot paths.

"Query Processing on Tensor Computation Runtimes" and "Theseus" both name
host-device data movement as the dominant perf hazard of tensor-runtime
query engines; a stray ``.item()`` or ``.cpu()`` on a CUDA tensor inside
the execution or planning layers drains the card's stream and stalls the
host on it. This rule bans the readback idioms inside ``exec/``, ``ops/``
and ``plan/``, except in the allow-listed *boundary modules* whose whole
job is device↔host marshalling. A site outside those modules that is a
genuine boundary carries an inline suppression with its justification.

The torch/CUDA device model (counterpart of the reference rule, whose
idioms are JAX's):
  * ``<expr>.item()``, ``<expr>.tolist()``, ``<expr>.cpu()`` and
    ``<expr>.numpy()`` with no arguments — each copies a tensor to the
    host, and on a CUDA tensor waits for the stream first;
  * ``torch.cuda.synchronize(...)`` and any ``<expr>.synchronize()``
    (an ``Event``'s or a ``Stream``'s) — an explicit wait on the card;
  * any call resolving to ``numpy.asarray`` (import aliases followed);
  * ``int(x)``/``float(x)``/``bool(x)`` where ``x`` is a subscript — the
    classic device-scalar readback ``int(t[0])``. Plain names and call
    results are NOT flagged (too noisy: ``int(np.searchsorted(...))`` is
    host math).

Static analysis cannot type a receiver: a ``.tolist()`` on a numpy
array is flagged like one on a tensor, and a site that is host-only
carries a suppression saying so.
"""

from __future__ import annotations

import ast
from typing import Iterator, Tuple

from ..core import ModuleContext, Rule, dotted_name

SCOPE = (
    "hyperspace_tpu_torch/exec/",
    "hyperspace_tpu_torch/ops/",
    "hyperspace_tpu_torch/plan/",
)

# Modules whose purpose IS the device<->host boundary: kernels marshal
# arguments and read results back, the scan/distributed layers rematerialize
# masks and partials on host, the HBM/mesh caches fence residency, the
# scan gate measures the link itself, and floatbits/bitpack ARE the
# transport formats (host-side encode of the f64 ordered planes and of
# the bit-packed residency words) — the reference's list, mapped onto the
# port (it has no ``ops/device_bench.py``). The port's own additions:
# ``ops/k2_cases.py`` and ``ops/k1b_cases.py`` generate kernel edge cases
# on the host from numpy, for the kernel phase and the tests only, and
# hold no device value at all.
BOUNDARY_MODULES = (
    "hyperspace_tpu_torch/ops/__init__.py",
    "hyperspace_tpu_torch/ops/build.py",
    "hyperspace_tpu_torch/ops/kernels.py",
    "hyperspace_tpu_torch/ops/floatbits.py",
    "hyperspace_tpu_torch/ops/bitpack.py",
    "hyperspace_tpu_torch/ops/k2_cases.py",
    "hyperspace_tpu_torch/ops/k1b_cases.py",
    "hyperspace_tpu_torch/exec/scan.py",
    "hyperspace_tpu_torch/exec/scan_gate.py",
    "hyperspace_tpu_torch/exec/distributed.py",
    "hyperspace_tpu_torch/exec/hbm_cache.py",
    "hyperspace_tpu_torch/exec/mesh_cache.py",
)

_CAST_NAMES = {"int", "float", "bool"}
_READBACK_ATTRS = ("item", "tolist", "cpu", "numpy")


class HostSyncRule(Rule):
    code = "HS001"
    name = "host-sync-in-hot-path"
    description = (
        "host-device synchronization (.item()/.tolist()/.cpu()/.numpy()/"
        "synchronize/np.asarray/scalar cast of a subscript) inside exec/, "
        "ops/ or plan/ outside the allow-listed boundary modules"
    )

    def applies_to(self, posix_path: str) -> bool:
        if not any(s in posix_path for s in SCOPE):
            return False
        return not any(posix_path.endswith(m) for m in BOUNDARY_MODULES)

    def check(self, ctx: ModuleContext) -> Iterator[Tuple[int, int, str]]:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            if isinstance(func, ast.Attribute):
                if (
                    func.attr in _READBACK_ATTRS
                    and not node.args
                    and not node.keywords
                ):
                    yield (
                        node.lineno,
                        node.col_offset,
                        f".{func.attr}() copies a tensor to the host (on "
                        "CUDA after draining its stream) in a hot path; keep "
                        "results on device or move this to a boundary module",
                    )
                    continue
                if func.attr == "synchronize":
                    yield (
                        node.lineno,
                        node.col_offset,
                        "synchronize() stalls the host on the card in a hot "
                        "path; fence at the boundary module instead",
                    )
                    continue
            resolved = dotted_name(func, ctx.aliases)
            if resolved == "torch.cuda.synchronize":
                yield (
                    node.lineno,
                    node.col_offset,
                    "synchronize() stalls the host on the card in a hot "
                    "path; fence at the boundary module instead",
                )
                continue
            if resolved == "numpy.asarray":
                yield (
                    node.lineno,
                    node.col_offset,
                    "np.asarray here may copy a CUDA tensor back to host in "
                    "a hot path; materialize at a boundary module (suppress "
                    "with justification if the operand is host-resident)",
                )
                continue
            if (
                isinstance(func, ast.Name)
                and func.id in _CAST_NAMES
                and len(node.args) == 1
                and not node.keywords
                and isinstance(node.args[0], ast.Subscript)
            ):
                yield (
                    node.lineno,
                    node.col_offset,
                    f"{func.id}(<subscript>) reads one element back to host "
                    "(device-scalar readback idiom); batch the readback at a "
                    "boundary module",
                )
