"""HS017 — a Python float made float32 by torch's default dtype.

The reference rule guards JAX's silent narrowing of ``jnp.int64``/
``float64`` outside an ``enable_x64`` scope. Torch never narrows an
explicit ``torch.int64``/``torch.float64``; the one silent narrowing it
does is the DEFAULT dtype: a Python float given to ``torch.tensor``/
``as_tensor``/``asarray``/``full``/``arange``/``linspace`` with no
``dtype=`` becomes float32 (a 24-bit mantissa). Such a site is only safe
when one of two scopes provably covers it:

  * MODULE — the module (or an ancestor package ``__init__``) calls
    ``torch.set_default_dtype(torch.float64)`` at import, making every
    later float 64-bit (the counterpart of ``ensure_x64()``);
  * CALLERS — every resolved call site reaching the function sits in a
    covered module or caller (greatest fixpoint over the call graph; a
    function nobody resolves to must establish its own scope — an entry
    point cannot inherit one).

There is no LEXICAL scope: torch has no scoped switch, and
``set_default_dtype(torch.float32)`` covers nothing, as the reference's
``enable_x64(False)`` covers nothing. Float literals inside NESTED defs
are attributed to the enclosing function, whose cover decides. A float
that is not a literal (a variable, ``float("nan")``) is a documented
blind spot; the fix is ``dtype=torch.float64`` at the site."""

from __future__ import annotations

from typing import Iterator, Tuple

from ..core import ProjectRule


class X64ScopeRule(ProjectRule):
    code = "HS017"
    name = "float-narrowed-by-default-dtype"
    description = (
        "a Python float literal reaches a torch constructor with no dtype= "
        "and no float64 default established at module import or by every "
        "resolved caller — torch makes it float32 silently"
    )

    def check_project(self, project) -> Iterator[Tuple[str, int, int, str]]:
        flow = project.device_flow()
        covered = flow.x64_covered()
        for qual, fl in sorted(flow.flows.items()):
            if not fl.dtype64:
                continue
            f = project.functions[qual]
            if flow.module_x64(f.module) or covered.get(qual):
                continue
            for line, col, spelling in fl.dtype64:
                yield (
                    f.path,
                    line,
                    col,
                    f"a Python float given to {spelling}() in {f.name}() "
                    "with no dtype= becomes float32 under torch's default "
                    "dtype — pass dtype=torch.float64, or call "
                    "torch.set_default_dtype(torch.float64) at module "
                    "import",
                )
