"""HS016 — per-call-site literal folded into a compiled closure and cache key.

A compile FACTORY (a function that builds ``torch.compile(body)`` —
or ``torch.jit.script``/``trace``, ``torch.cuda.make_graphed_callables``
— and memoizes it under a key tuple) whose body CLOSES OVER a factory
parameter that is ALSO part of the memo key compiles one fresh program
per distinct value of that parameter. For structural parameters (shapes,
modes, arities — the things a compiler genuinely specializes on) that is
the design; for VALUE-like parameters it is the bakes-literals bug:
every distinct literal at a call site becomes a new trace + compile,
and a literal-burst workload turns the program cache into a compile
treadmill. The structure-keyed discipline instead masks the literal out
of the key and ships the value as an operand of the compiled program.

The finding anchors at the CALL SITE that binds a numeric literal to a
hazard parameter — that site is the witness that per-call-site literals
actually reach the closure. A factory whose hazard parameters only ever
receive runtime values (row counts, device counts) never fires.
Parameters with structural NAMES (n_*, num_*, cap, bits, mode, shape…)
are exempt by convention; a value-like parameter hiding behind a
structural name is a documented blind spot.

Counterpart of the reference rule, whose factories are ``jax.jit``
sites; the factory, memo-key and structural-name logic is the same
(``analysis/dataflow.py``). A cache keyed by a predicate's ``repr`` that
builds a host program and compiles nothing (K1's lowering cache) is no
factory: no literal burst can start a compile treadmill there."""

from __future__ import annotations

from typing import Iterator, Tuple

from ..core import ProjectRule
from ..dataflow import _STRUCTURAL_PARAM_RE, param_names


class RecompileHazardRule(ProjectRule):
    code = "HS016"
    name = "jit-recompile-hazard"
    description = (
        "a call site binds a numeric literal to a compile-factory "
        "parameter that is closed over by the compiled body AND folded "
        "into its memo key — each distinct value compiles a fresh "
        "program; pass it as an operand instead"
    )

    def check_project(self, project) -> Iterator[Tuple[str, int, int, str]]:
        flow = project.device_flow()
        callers = project.callers_of()
        for qual, fl in sorted(flow.flows.items()):
            hazard = set()
            for jf in fl.jit_factories:
                if not jf.cached:
                    continue
                hazard.update(
                    p
                    for p in jf.closure_params
                    if p in jf.key_params
                    and not _STRUCTURAL_PARAM_RE.match(p)
                )
            if not hazard:
                continue
            f = project.functions[qual]
            node = getattr(f, "_node", None)
            if node is None:
                continue
            pnames = param_names(node, f.cls is not None)
            seen = set()
            for caller, site in callers.get(qual, []):
                for key, val in site.const_args:
                    pname = (
                        pnames[key]
                        if isinstance(key, int) and key < len(pnames)
                        else key
                    )
                    if pname not in hazard:
                        continue
                    at = (caller.path, site.line, site.col, pname)
                    if at in seen:
                        continue
                    seen.add(at)
                    yield (
                        caller.path,
                        site.line,
                        site.col,
                        f"literal {val!r} is bound to parameter "
                        f"'{pname}' of compile factory {f.name}(); the "
                        "compiled body closes over it and the memo key "
                        "includes it, so each distinct value traces and "
                        "compiles a fresh program — mask it from the key "
                        "structure and pass it as an operand of the "
                        "compiled program",
                    )
