"""The port's tree stays hslint-clean, and the port's lint and metrics
command lines keep the reference's contract (``tests/test_lint.py``'s
tests that need no whole-program phase).

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
# the audited markers of the port's tree (20 suppressed findings ride on
# them): HS001 at host-numpy sites of exec/ and a region's upload, HS002
# at the kernels' nvcc build, HS004 at the device probe's verdict, HS007
# at a pinned host allocation, HS008 at the latestStable rewrite. A new
# marker retires an old one or raises this pin in the same diff.
SUPPRESSION_BUDGET = 15
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
    assert payload["summary"]["suppressed"] == 20


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
        "HS001", "HS002", "HS003", "HS004", "HS005", "HS006", "HS007", "HS008", "HS014"]


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


def test_full_tree_wall_time_budget(tree):
    """The whole per-file analysis of the default targets stays under a
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
