"""HS019 — untraced device transfer in the exec/residency seam.

The observability contract: every H2D upload and D2H fetch in the
execution and residency layers labels its bytes through
``trace.add_bytes``, so a trace of a slow query SHOWS the transfer that
made it slow. This rule enforces the contract where it is declared —
modules under ``exec/`` and ``residency/`` — by flagging functions that
perform a transfer (an upload: ``.cuda()``, ``.to(<device>)`` of a value
not judged device, a ``torch.tensor``/``as_tensor``/``asarray`` with
``device=`` over host data, ``<device value>.copy_(<host value>)``; a
fetch: ``.cpu()``, ``.to("cpu")`` of a device value) or a bulk D2H fetch
(``np.asarray``/``.tolist()`` of a device value) without
``trace.add_bytes`` in reach (lexically or through a callee). The device
model is ``analysis/dataflow.py``'s.

Scalar casts and ``.item()`` are excluded: a sub-hundred-byte sync is a
latency question (HS001/HS015's beat), not a bandwidth-accounting one.
Findings are deduplicated to the first site per (function, direction) —
fixing a function means adding one trace call, not ten suppressions.
Probe functions that measure the link itself carry inline suppressions
with that justification."""

from __future__ import annotations

from typing import Iterator, Tuple

from ..core import ProjectRule

_BULK_D2H_KINDS = {"asarray", "tolist"}


def _in_scope(module: str) -> bool:
    segs = module.split(".")
    return "exec" in segs or "residency" in segs


class UntracedTransferRule(ProjectRule):
    code = "HS019"
    name = "untraced-transfer"
    description = (
        "an upload (.cuda()/.to(device)/a constructor with device=) or a "
        "fetch (.cpu()/.to('cpu')/bulk D2H) in exec/ or residency/ has no "
        "trace.add_bytes in the enclosing function — the transfer is "
        "invisible to query traces"
    )

    def check_project(self, project) -> Iterator[Tuple[str, int, int, str]]:
        flow = project.device_flow()
        traced = flow.traced_reach()
        for qual, fl in sorted(flow.flows.items()):
            f = project.functions[qual]
            if not _in_scope(f.module) or qual in traced:
                continue
            events = [
                (t.direction, t.line, t.col, t.api) for t in fl.transfers
            ] + [
                ("d2h", e.line, e.col, f"{e.kind}({e.detail})")
                for e in fl.d2h
                if e.kind in _BULK_D2H_KINDS
            ]
            seen = set()
            for direction, line, col, what in sorted(
                events, key=lambda e: (e[1], e[2])
            ):
                if direction in seen:
                    continue
                seen.add(direction)
                leg = (
                    "uploads to device"
                    if direction == "h2d"
                    else "fetches from device"
                )
                yield (
                    f.path,
                    line,
                    col,
                    f"{f.name}() {leg} ({what}) but never reaches "
                    "trace.add_bytes — label the bytes "
                    "(h2d_bytes/d2h_bytes) so query traces see the "
                    "transfer",
                )
