"""HS015 — implicit device->host readback in a hot path (value-flow).

HS001 bans the readback IDIOMS lexically inside ``exec/``/``ops/``/
``plan/``; this rule closes the other half of the seam: a
``float()``/``int()``/``bool()`` cast, ``np.asarray``, ``.item()``/
``.tolist()``/``.cpu()``/``.numpy()`` or iteration applied to an
expression the phase-3 value flow PROVES device-valued, in any module
that is NOT a declared device<->host boundary. The boundary set is the
``exec.*``/``residency.*`` packages plus the ops marshalling backends
(the reference's list mapped onto the port, which has no
``ops.device_bench``; ``ops.k2_cases`` and ``ops.k1b_cases`` generate
kernel edge cases on the host, as HS001 holds them) — everywhere else a
device value must stay on device until a boundary module materializes
it (and traces the bytes).

A function that reaches ``trace.add_bytes`` (lexically or through its
callees) is excused: its D2H is declared and accounted, which is the
whole discipline. Everything here is anchored on a POSITIVE device
classification — host values, unknown values and unresolved calls never
fire (may miss, must not invent). ``chip_smoke`` and the port's
``tools`` package are skipped like the reference's ``bench`` and
``scripts``: their readbacks are program output or probes."""

from __future__ import annotations

from typing import Iterator, Tuple

from ..core import ProjectRule

# module-name segments that ARE the device boundary (plus the ops
# backends below); everything else is "hot path" for this rule
_BOUNDARY_SEGMENTS = {"exec", "residency"}
_BOUNDARY_SUFFIXES = (
    ".ops",
    ".ops.build",
    ".ops.kernels",
    ".ops.floatbits",
    ".ops.bitpack",
    ".ops.k2_cases",
    ".ops.k1b_cases",
)
# non-library top-level trees: CLI scripts, benches and the card's smoke
# script print results to a human — their trailing readback is the
# program's output
_SKIP_TOP_SEGMENTS = {"scripts", "tests", "bench", "chip_smoke"}
# the port's command-line probes and tools, wherever the package sits
_SKIP_SEGMENTS = {"tools"}

_KIND_VERB = {
    "float": "float() casts",
    "int": "int() casts",
    "bool": "bool() casts",
    "asarray": "np.asarray materializes",
    "item": ".item() reads",
    "tolist": ".tolist() reads",
    "cpu": ".cpu() copies",
    "numpy": ".numpy() reads",
    "iter": "iterating fetches",
}


def _is_boundary(module: str) -> bool:
    segs = module.split(".")
    if segs[0] in _SKIP_TOP_SEGMENTS or _SKIP_SEGMENTS.intersection(segs):
        return True
    if _BOUNDARY_SEGMENTS.intersection(segs):
        return True
    return module.endswith(_BOUNDARY_SUFFIXES) or module == "ops"


class ImplicitD2HRule(ProjectRule):
    code = "HS015"
    name = "implicit-d2h-hot-path"
    description = (
        "a device-valued expression is read back to host (scalar cast/"
        "np.asarray/.item()/.cpu()/iteration) outside the declared "
        "boundary modules and without trace.add_bytes accounting"
    )

    def check_project(self, project) -> Iterator[Tuple[str, int, int, str]]:
        flow = project.device_flow()
        traced = flow.traced_reach()
        for qual, fl in sorted(flow.flows.items()):
            if not fl.d2h:
                continue
            f = project.functions[qual]
            if _is_boundary(f.module):
                continue
            if qual in traced:
                continue
            for ev in fl.d2h:
                verb = _KIND_VERB.get(ev.kind, f"{ev.kind} reads")
                yield (
                    f.path,
                    ev.line,
                    ev.col,
                    f"{verb} the device value '{ev.detail}' back to "
                    f"host in {f.name}(), outside the declared boundary "
                    "modules and with no trace.add_bytes in reach — "
                    "keep it on device, or materialize at a boundary "
                    "module and trace the bytes",
                )
