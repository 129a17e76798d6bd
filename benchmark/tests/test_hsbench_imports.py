"""Nothing the benchmark runs loads JAX or the JAX package, and the plain
reference takes nothing of the program. Modules are compared by their
whole top-level name: the port's name begins with the JAX package's."""

from __future__ import annotations

import ast
import subprocess
import sys

from _util import BENCH_DIR, REPO

FORBIDDEN = {"jax", "jaxlib", "flax", "hyperspace_tpu"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_source_imports_jax():
    for path in BENCH_DIR.rglob("*.py"):
        assert not set(_imports(path)) & FORBIDDEN, path


def test_reference_takes_nothing_of_the_program():
    for path in (BENCH_DIR / "reference").rglob("*.py"):
        assert not set(_imports(path)) & (FORBIDDEN | {"hyperspace_tpu_torch", "hsbench"}), path


def test_loaded_modules_after_the_harness_imports():
    code = (
        "import sys; sys.path[:0] = [{b!r}, {r!r}]\n"
        "import run, hsbench.devtrace, hsbench.system, hsbench.loop, reference.groupby\n"
        "import hyperspace_tpu_torch.exec.hbm_cache, hyperspace_tpu_torch.serve\n"
        "print(sorted({{m.split('.')[0] for m in sys.modules}} & {f!r}))\n"
    ).format(b=str(BENCH_DIR), r=str(REPO), f=FORBIDDEN)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=REPO)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "[]"
