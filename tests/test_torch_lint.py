"""The port's tree stays hslint-clean, and the port's lint and metrics
command lines keep the reference's contract (``tests/test_lint.py``),
the whole-program phase's flags included.

``hyperspace_tpu_torch`` and ``chip_smoke.py`` are held at zero
unsuppressed findings; every intentional boundary carries a
``# hslint: disable=HSxxx - <reason>`` marker, and the markers are
pinned by count. The command lines run in this process (``main(argv)``)
except one run of each through ``python -m``. The metrics command line's
demo registry renders the same Prometheus and JSON-lines text as the
reference's ``scripts/metrics.py``.
"""

import ast
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import pytest

from hyperspace_tpu_torch.analysis import iter_python_files, iter_suppression_markers
from hyperspace_tpu_torch.analysis.rules import REGISTRY
from hyperspace_tpu_torch.tools import lint, metrics as metrics_cli

REPO = Path(__file__).resolve().parent.parent
LINT_TARGETS = ["hyperspace_tpu_torch", "chip_smoke.py"]
# the audited markers of the port's tree (22 suppressed findings ride on
# them): HS001 at host-numpy sites of exec/ and a region's upload, HS002
# at the kernels' nvcc build, HS004 at the device probe's verdict, HS007
# at a pinned host allocation, HS008 at the latestStable rewrite, HS011
# at the native runtime's once-per-process g++ build, HS015 at the device
# probe's round trip. A new marker retires an old one or raises this pin
# in the same diff.
SUPPRESSION_BUDGET = 17
BAD = "CACHE = {}\ndef put(k, v):\n    CACHE[k] = v\n"


def cli(capsys, *argv):
    """``python -m hyperspace_tpu_torch.tools.lint *argv`` in this process:
    (exit code, stdout, stderr)."""
    rc = lint.main(list(argv))
    out = capsys.readouterr()
    return rc, out.out, out.err


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """One CLI run over the default targets (a cache miss that fills the
    module's cache directory, which later default runs replay), with the
    wall seconds it took."""
    cache_dir = tmp_path_factory.mktemp("hslint_cache")
    argv = ["--format", "json", "--cache-dir", str(cache_dir)]
    t0 = time.perf_counter()
    rc = lint.main(argv)
    wall = time.perf_counter() - t0
    return {"rc": rc, "cache_dir": cache_dir, "wall": wall}


def test_tree_has_zero_unsuppressed_findings(tree, capsys):
    rc, out, _ = cli(capsys, "--format", "json", "--cache-dir", str(tree["cache_dir"]))
    payload = json.loads(out)
    unsuppressed = [f for f in payload["findings"] if not f["suppressed"]]
    assert tree["rc"] == rc == 0, unsuppressed
    assert payload["summary"]["unsuppressed"] == 0
    assert payload["summary"]["suppressed"] == 22


def test_cli_module_entry_exits_zero_on_clean_tree(tree):
    proc = subprocess.run(
        [sys.executable, "-m", "hyperspace_tpu_torch.tools.lint",
         "--cache-dir", str(tree["cache_dir"])],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "0 finding(s)" in proc.stdout


def test_cli_json_format_and_failure_exit(tmp_path, capsys):
    bad = tmp_path / "bad.py"
    bad.write_text(BAD, encoding="utf-8")
    rc, out, _ = cli(capsys, "--format", "json", "--no-cache", str(bad))
    assert rc == 1
    payload = json.loads(out)
    assert payload["summary"]["unsuppressed"] == 1
    assert payload["findings"][0]["code"] == "HS006"


def test_cli_list_rules_names_exactly_the_nine(capsys):
    rc, out, _ = cli(capsys, "--list-rules")
    assert rc == 0
    assert [line.split()[0] for line in out.splitlines()] == [
        f"HS{n:03d}" for n in range(1, 21)]


def test_cli_missing_path_is_usage_error(capsys):
    rc, _, err = cli(capsys, "no/such/dir")
    assert rc == 2 and "no such path" in err


def test_cli_check_suppressions_clean_tree_and_stale_detection(tree, tmp_path, capsys):
    rc, out, _ = cli(capsys, "--check-suppressions", "--cache-dir", str(tree["cache_dir"]))
    assert rc == 0, out
    assert ", 0 stale" in out
    stale = tmp_path / "stale.py"
    stale.write_text("def f(x):\n    return x  # hslint: disable=HS001\n", encoding="utf-8")
    rc, out, _ = cli(capsys, "--check-suppressions", "--no-cache", str(stale))
    assert rc == 1
    assert "HS001 no longer fires" in out


def test_suppression_budget_is_pinned(tree, capsys):
    rc, out, _ = cli(capsys, "--check-suppressions", "--budget", str(SUPPRESSION_BUDGET),
                     "--cache-dir", str(tree["cache_dir"]))
    assert rc == 0, out
    assert f"{SUPPRESSION_BUDGET} suppression(s) audited, 0 stale" in out


def test_every_marker_names_its_rules_and_gives_a_reason():
    """A bare ``disable`` would silence every rule on its line: each
    marker of the tree names its codes and says why after them."""
    for path in iter_python_files([REPO / t for t in LINT_TARGETS]):
        lines = path.read_text(encoding="utf-8").splitlines()
        for marker_line, _bound, codes in iter_suppression_markers("\n".join(lines)):
            text = lines[marker_line - 1]
            assert codes, f"{path}:{marker_line}"
            reason = text.split("hslint: disable=", 1)[1].split(None, 1)
            assert len(reason) == 2 and reason[1].startswith("- ") and len(reason[1]) > 10, (
                f"{path}:{marker_line}: {text}")


def test_suppression_budget_exceeded_fails(tmp_path, capsys):
    over = tmp_path / "over.py"
    over.write_text("def f(dev):\n    return dev.item()  # hslint: disable=HS001 - fixture\n",
                    encoding="utf-8")
    rc, out, _ = cli(capsys, "--check-suppressions", "--budget", "0", "--no-cache", str(over))
    assert rc == 1
    assert "budget exceeded" in out


def test_budget_without_audit_is_usage_error(capsys):
    with pytest.raises(SystemExit) as e:
        lint.main(["--budget", "5"])
    assert e.value.code == 2


def test_cli_changed_mode_filters_to_changed_files(tree, tmp_path, capsys):
    # HEAD as the ref: findings outside the changed files are dropped (a
    # clean tree reports nothing either way)
    rc, out, _ = cli(capsys, "--changed", "HEAD", "--cache-dir", str(tree["cache_dir"]))
    assert rc == 0, out
    # a finding in a file git does not list as changed is filtered out
    bad = tmp_path / "bad.py"
    bad.write_text(BAD, encoding="utf-8")
    rc, out, _ = cli(capsys, "--changed", "HEAD", "--no-cache", "--format", "json", str(bad))
    assert rc == 0 and json.loads(out)["summary"]["total"] == 0
    rc, _, err = cli(capsys, "--changed", "no-such-ref-anywhere")
    assert rc == 2 and "cannot resolve" in err


def test_cli_timings_name_every_rule(capsys):
    # joins.py lies in HS001's and HS007's scope
    rc, out, err = cli(capsys, "--timings", str(REPO / "hyperspace_tpu_torch" / "analysis"),
                       str(REPO / "hyperspace_tpu_torch" / "exec" / "joins.py"))
    assert rc == 0, out + err
    assert "0 finding(s)" in out
    for rule in REGISTRY:
        assert f"  {rule.code}: " in err
    assert "  total: " in err


CYCLE = {
    "a.py": "import threading\nfrom . import b\n_A_LOCK = threading.Lock()\n"
            "def locked_a():\n    with _A_LOCK:\n        pass\n"
            "def do_a():\n    with _A_LOCK:\n        b.locked_b()\n",
    "b.py": "import threading\nfrom . import a\n_B_LOCK = threading.Lock()\n"
            "def locked_b():\n    with _B_LOCK:\n        pass\n"
            "def do_b():\n    with _B_LOCK:\n        a.locked_a()\n",
}


def _package(tmp_path, files):
    pkg = tmp_path / "pkg"
    pkg.mkdir()
    for name, src in files.items():
        (pkg / name).write_text(src, encoding="utf-8")
    return pkg


def test_project_phase_finds_cross_module_cycle(tmp_path, capsys):
    """A two-module A->B / B->A lock cycle fires HS009 with --project (the
    default) and is invisible with --no-project."""
    pkg = _package(tmp_path, CYCLE)
    for flags in ([], ["--project"]):
        rc, out, _ = cli(capsys, "--format", "json", "--no-cache", *flags, str(pkg))
        assert rc == 1
        assert json.loads(out)["summary"]["by_code"] == {"HS009": 2}
    rc, out, _ = cli(capsys, "--format", "json", "--no-project", str(pkg))
    assert rc == 0 and json.loads(out)["summary"]["total"] == 0


def test_cli_default_paths_and_timings(tmp_path, capsys):
    """A timed run of the default targets: every rule, the project
    model's build and the value flow's fixpoint under their own keys, and
    the model's dump holds every module of the port and, for the
    functions with device-value facts, a ``valueflow`` entry."""
    dump = tmp_path / "cg.json"
    rc, out, err = cli(capsys, "--timings", "--call-graph-dump", str(dump))
    assert rc == 0, out + err
    assert "0 finding(s)" in out
    for code in [r.code for r in REGISTRY] + ["project-model", "device-flow"]:
        assert f"  {code}: " in err
    payload = json.loads(dump.read_text(encoding="utf-8"))
    want = {".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
            for p in iter_python_files([REPO / t for t in LINT_TARGETS])}
    assert set(payload["modules"]) == want
    flows = {q: f["valueflow"] for q, f in payload["functions"].items() if "valueflow" in f}
    assert flows["hyperspace_tpu_torch.exec.hbm_cache:HbmIndexCache._build"]["traces_bytes"]
    assert any("transfers" in f for f in flows.values())


def test_cli_call_graph_dump(tmp_path, capsys):
    out_path = tmp_path / "cg.json"
    rc, out, err = cli(capsys, "--call-graph-dump", str(out_path),
                       str(REPO / "hyperspace_tpu_torch" / "serve"))
    assert rc == 0, out + err
    assert "call graph written" in err and "0 finding(s)" in out
    payload = json.loads(out_path.read_text(encoding="utf-8"))
    assert set(payload) == {"functions", "locks", "modules"}
    assert "serve.server" in payload["modules"]
    assert "serve.server:QueryServer._cond" in payload["locks"]
    fns = payload["functions"]
    assert any(q.startswith("serve.server:QueryServer.") for q in fns)
    for info in fns.values():
        assert set(info) - {"valueflow"} == {"path", "line", "calls", "unresolved", "acquires",
                                             "blocking"}
    # resolved edges, within a class and across modules of the package,
    # and the lock events
    assert "serve.server:QueryServer._submit_traced" in fns["serve.server:QueryServer.submit"]["calls"]
    assert "serve.batcher:execute_batch" in fns["serve.server:QueryServer._execute_batch"]["calls"]
    assert any(a["lock"] == "serve.server:QueryServer._cond"
               for f in fns.values() for a in f["acquires"])


def test_cli_check_suppressions_under_the_project_phase(tmp_path, capsys):
    """The audit runs the project rules: a live HS011 marker holds, a
    stale one is reported at its line."""
    pkg = _package(tmp_path, {
        "work.py": "import threading\nfrom . import helper\n_LOCK = threading.Lock()\n"
                   "def tick():\n    with _LOCK:\n"
                   "        helper.flush()  # hslint: disable=HS011 - fixture\n"
                   "def tock():\n    with _LOCK:\n"
                   "        helper.noop()  # hslint: disable=HS011 - fixture\n",
        "helper.py": "import time\ndef flush():\n    time.sleep(1)\n"
                     "def noop():\n    return 1\n",
    })
    rc, out, _ = cli(capsys, "--check-suppressions", "--no-cache", str(pkg))
    assert rc == 1
    assert f"{pkg / 'work.py'}:9: stale suppression — HS011 no longer fires" in out
    assert ":6:" not in out
    assert "2 suppression(s) audited, 1 stale" in out


def test_cli_changed_mode_builds_the_full_model(tmp_path, capsys, monkeypatch):
    """--changed reports only the changed files, but the model spans every
    path: a.py's half of the cycle needs b.py to be seen at all."""
    pkg = _package(tmp_path, CYCLE)
    monkeypatch.setattr(lint, "_changed_files", lambda ref: {(pkg / "a.py").resolve()})
    rc, out, _ = cli(capsys, "--changed", "HEAD", "--no-cache", "--format", "json", str(pkg))
    payload = json.loads(out)
    assert rc == 1 and payload["summary"]["by_code"] == {"HS009": 1}
    assert payload["findings"][0]["path"] == str(pkg / "a.py")


@pytest.mark.parametrize("flag", ["--check-suppressions", "--call-graph-dump"])
def test_cli_audit_and_dump_reject_no_project(flag, tmp_path, capsys):
    argv = ["--no-project", flag] + ([str(tmp_path / "cg.json")] if flag == "--call-graph-dump"
                                     else [])
    with pytest.raises(SystemExit) as e:
        lint.main(argv)
    assert e.value.code == 2
    assert "(drop --no-project)" in capsys.readouterr().err
    assert not (tmp_path / "cg.json").exists()


def test_full_tree_wall_time_budget(tree):
    """The whole analysis of the default targets, both phases, stays under a
    budget calibrated on this machine as the reference calibrates it: at
    least 10 s, or 30 times an ``ast.parse`` of the same sources (the
    analysis takes a fixed multiple of the parse's CPU work, so the
    budget follows the machine's speed and load). Best of two."""
    sources = [p.read_text(encoding="utf-8")
               for p in iter_python_files([REPO / t for t in LINT_TARGETS])]
    t0 = time.perf_counter()
    for s in sources:
        ast.parse(s)
    parse_s = time.perf_counter() - t0
    budget = max(10.0, 30.0 * parse_s)
    best = tree["wall"]
    if best >= budget:
        t0 = time.perf_counter()
        lint.main(["--no-cache", "--format", "json"])
        best = min(best, time.perf_counter() - t0)
    assert best < budget, (f"full-tree analysis took {best:.1f}s (calibrated budget "
                           f"{budget:.1f}s from parse baseline {parse_s:.2f}s)")


def test_cli_sarif_format_is_parseable(tmp_path, capsys):
    bad = tmp_path / "bad.py"
    bad.write_text(BAD, encoding="utf-8")
    rc, out, _ = cli(capsys, "--format", "sarif", "--no-cache", str(bad))
    assert rc == 1  # exit contract unchanged by format
    doc = json.loads(out)
    assert doc["version"] == "2.1.0"
    assert doc["runs"][0]["tool"]["driver"]["name"] == "hslint"
    assert [r["ruleId"] for r in doc["runs"][0]["results"]] == ["HS006"]


def test_cache_replays_hits_and_invalidates_on_edit(tmp_path, capsys):
    """A byte-identical rerun REPLAYS the stored findings (a doctored
    entry's verdict comes back), and a source edit changes the key so the
    real analysis runs again."""
    target = tmp_path / "mod.py"
    target.write_text(BAD, encoding="utf-8")
    cache_dir = tmp_path / "cache"
    argv = ("--format", "json", "--cache-dir", str(cache_dir), str(target))
    rc, out, _ = cli(capsys, *argv)
    assert rc == 1 and json.loads(out)["summary"]["by_code"] == {"HS006": 1}
    (entry,) = cache_dir.glob("*.json")
    entry.write_text(json.dumps({"findings": []}), encoding="utf-8")
    rc, out, _ = cli(capsys, *argv)
    assert rc == 0 and json.loads(out)["summary"]["unsuppressed"] == 0
    target.write_text(BAD + "\n# touched\n", encoding="utf-8")
    rc, out, _ = cli(capsys, *argv)
    assert rc == 1 and json.loads(out)["summary"]["by_code"] == {"HS006": 1}


def test_cli_no_cache_skips_read_and_write(tmp_path, capsys):
    target = tmp_path / "mod.py"
    target.write_text("x = 1\n", encoding="utf-8")
    cache_dir = tmp_path / "cache"
    rc, _, _ = cli(capsys, "--no-cache", "--cache-dir", str(cache_dir), str(target))
    assert rc == 0
    assert not cache_dir.exists()


def test_default_cache_dir_is_the_ports_own_and_ignored():
    assert lint.DEFAULT_CACHE_DIR == REPO / ".hslint_torch_cache"
    assert ".hslint_torch_cache/" in (REPO / ".gitignore").read_text().splitlines()


# ---------------------------------------------------------------------------
# the metrics command line
# ---------------------------------------------------------------------------
def _reference_metrics_cli():
    spec = importlib.util.spec_from_file_location("_ref_metrics_cli", REPO / "scripts" / "metrics.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_metrics_cli_check_validates_prometheus_rendering(capsys):
    assert metrics_cli.main(["--check"]) == 0
    assert "metrics check: OK" in capsys.readouterr().out
    proc = subprocess.run(
        [sys.executable, "-m", "hyperspace_tpu_torch.tools.metrics", "--check"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "metrics check: OK" in proc.stdout


@pytest.mark.parametrize("fmt", ["prom", "jsonl"])
def test_metrics_cli_demo_renders_as_the_reference(fmt, capsys):
    ref = _reference_metrics_cli()
    assert ref.main(["--format", fmt, "--demo"]) == 0
    want = capsys.readouterr().out
    assert metrics_cli.main(["--format", fmt, "--demo"]) == 0
    got = capsys.readouterr().out
    assert got == want
    assert ("# TYPE " if fmt == "prom" else '"type"') in got


def test_metrics_cli_check_fails_on_a_malformed_rendering(monkeypatch, capsys):
    broken = "# TYPE hyperspace_x counter\n# TYPE hyperspace_x counter\nhyperspace_x 1\n"
    monkeypatch.setattr(metrics_cli.texport, "render_prometheus", lambda reg=None: broken)
    assert metrics_cli.check_registry(metrics_cli.Metrics(), "demo")
    assert metrics_cli.main(["--check"]) == 1
    assert "problem(s)" in capsys.readouterr().out


def test_metrics_cli_write_appends_a_snapshot(tmp_path, capsys):
    assert metrics_cli.main(["--demo", "--write", str(tmp_path)]) == 0
    assert "metrics: wrote" in capsys.readouterr().out
    (snap,) = [p for p in tmp_path.rglob("*") if p.is_file()]
    lines = snap.read_text().splitlines()
    assert lines and all(json.loads(line) for line in lines)


# ---------------------------------------------------------------------------
# the value-flow phase through the command line
# ---------------------------------------------------------------------------
_FLOW_PKG = {
    "exec/__init__.py": "",
    "exec/leg.py": "import numpy as np\nimport torch\n\n"
                   "def upload(arr, dev):\n    return torch.from_numpy(arr).to(dev)\n\n"
                   "def fetch(n, dev):\n    return np.asarray(torch.zeros(n, device=dev).cpu())\n",
}


def test_cli_list_rules_names_twenty_with_the_flow_rules(capsys):
    rc, out, _ = cli(capsys, "--list-rules")
    assert rc == 0
    lines = out.splitlines()
    assert len(lines) == 20
    by_code = {r.code: r for r in REGISTRY}
    for line in lines[14:]:
        code, rest = line.split(" ", 1)
        assert code in {"HS015", "HS016", "HS017", "HS018", "HS019", "HS020"}
        assert rest == f"{by_code[code].name}: {by_code[code].description}"


def test_cli_timings_report_device_flow_and_dump_carries_valueflow(tmp_path, capsys):
    """``--timings`` notes the value flow's fixpoint as ``device-flow``,
    and the call-graph dump holds each function's value-flow facts: the
    upload and the fetch HS019 reports."""
    pkg = tmp_path / "pkg"
    for rel, src in _FLOW_PKG.items():
        (pkg / rel).parent.mkdir(parents=True, exist_ok=True)
        (pkg / rel).write_text(src, encoding="utf-8")
    dump = tmp_path / "cg.json"
    rc, out, err = cli(capsys, "--format", "json", "--no-cache", "--timings",
                       "--call-graph-dump", str(dump), str(pkg))
    assert rc == 1
    assert json.loads(out)["summary"]["by_code"] == {"HS019": 2}
    assert "  device-flow: " in err and "  project-model: " in err
    fns = json.loads(dump.read_text(encoding="utf-8"))["functions"]
    assert fns["pkg.exec.leg:upload"]["valueflow"] == {
        "device_return": True, "transfers": ["h2d:to@5"]}
    assert fns["pkg.exec.leg:fetch"]["valueflow"] == {
        "d2h": ["cpu(torch.zeros(n, device=dev))@8"], "transfers": ["d2h:cpu@8"]}


_HS016_BAKED = {
    "fac.py": (
        "import threading\n"
        "\n"
        "import torch\n"
        "\n"
        "_CACHE = {}\n"
        "_LOCK = threading.Lock()\n"
        "\n"
        "def counts_fn(lo, n_rows):\n"
        "    key = (lo, n_rows)\n"
        "    with _LOCK:\n"
        "        if len(_CACHE) > 64:\n"
        "            _CACHE.clear()\n"
        "        if key not in _CACHE:\n"
        "            def body(x):\n"
        "                return x + lo\n"
        "            _CACHE[key] = torch.compile(body)\n"
        "        return _CACHE[key]\n"
    ),
    "use.py": (
        "from .fac import counts_fn\n"
        "\n"
        "def run(x):\n"
        "    fn = counts_fn(3, 128)\n"
        "    return fn(x)\n"
    ),
}
_HS016_OPERAND = {
    "fac.py": _HS016_BAKED["fac.py"].replace("(lo, n_rows):", "(n_rows):").replace(
        "key = (lo, n_rows)", "key = (n_rows,)").replace("def body(x):", "def body(x, lo):"),
    "use.py": _HS016_BAKED["use.py"].replace("counts_fn(3, 128)", "counts_fn(128)").replace(
        "fn(x)", "fn(x, 3)"),
}


def test_hs016_acceptance_flip_through_cli(tmp_path, capsys):
    """A literal-baked ``torch.compile`` factory fires HS016 at the binding
    call site; masking the literal out of the key and passing it as an
    operand flips the same tree to clean."""
    pkg = _package(tmp_path, _HS016_BAKED)
    rc, out, _ = cli(capsys, "--format", "json", "--no-cache", str(pkg))
    assert rc == 1
    payload = json.loads(out)
    assert payload["summary"]["by_code"] == {"HS016": 1}
    (finding,) = payload["findings"]
    assert finding["path"].endswith("use.py") and "'lo'" in finding["message"]
    for name, src in _HS016_OPERAND.items():
        (pkg / name).write_text(src, encoding="utf-8")
    rc, out, err = cli(capsys, "--format", "json", "--no-cache", str(pkg))
    assert rc == 0, out + err
    assert json.loads(out)["summary"]["unsuppressed"] == 0
