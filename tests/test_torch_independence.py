"""The port stands alone: importing it pulls in neither JAX nor the JAX
package, its sources import neither, and its device entry points refuse
to run on a CUDA device that is absent instead of quietly using the CPU.
"""

import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import hyperspace_tpu_torch
from hyperspace_tpu_torch.exceptions import HyperspaceException
from hyperspace_tpu_torch.ops import resolve_device

PKG = Path(hyperspace_tpu_torch.__file__).resolve().parent


def test_import_leaves_jax_and_reference_out():
    code = (
        "import sys\n"
        "import hyperspace_tpu_torch\n"
        "from hyperspace_tpu_torch import session, dataframe, hyperspace\n"
        "from hyperspace_tpu_torch.ops import kernels, build, hashing\n"
        "from hyperspace_tpu_torch.exec import executor\n"
        "from hyperspace_tpu_torch.index import interop, sketches\n"
        "from hyperspace_tpu_torch.plananalysis import plan_analyzer\n"
        "from hyperspace_tpu_torch.actions import create_skipping\n"
        "from hyperspace_tpu_torch.plan.rules import column_pruning, data_skipping_rule\n"
        "from hyperspace_tpu_torch.storage import partitions\n"
        "from hyperspace_tpu_torch import native\n"
        "from hyperspace_tpu_torch import compile, serve\n"
        "from hyperspace_tpu_torch.telemetry import trace, recorder, export\n"
        "from hyperspace_tpu_torch.exec import scan_agg\n"
        "from hyperspace_tpu_torch.reliability import retry\n"
        "from hyperspace_tpu_torch import analysis\n"
        "from hyperspace_tpu_torch.analysis import cache, core, dataflow, project, reporter, rules\n"
        "from hyperspace_tpu_torch.analysis.rules import hs001_host_sync, hs007_unfenced_device_timing\n"
        "from hyperspace_tpu_torch.analysis.rules import hs009_lock_order, hs010_guarded_fields\n"
        "from hyperspace_tpu_torch.analysis.rules import hs011_interproc_blocking\n"
        "from hyperspace_tpu_torch.analysis.rules import hs012_residency_fence, hs013_config_keys\n"
        "from hyperspace_tpu_torch.analysis.rules import hs015_implicit_d2h, hs016_recompile_hazard\n"
        "from hyperspace_tpu_torch.analysis.rules import hs017_x64_scope, hs018_uncounted_decline\n"
        "from hyperspace_tpu_torch.analysis.rules import hs019_untraced_transfer\n"
        "from hyperspace_tpu_torch.analysis.rules import hs020_uncounted_failover\n"
        "from hyperspace_tpu_torch.tools import lint, metrics\n"
        "native.available()\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'hyperspace_tpu' or m.startswith('hyperspace_tpu.'))\n"
        "print(bad)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, check=True,
        cwd=str(PKG.parent),
    )
    assert out.stdout.strip() == "[]", out.stdout


@pytest.mark.parametrize(
    "path",
    sorted(PKG.rglob("*.py")) + [PKG.parent / "chip_smoke.py"],
    ids=lambda p: p.name,
)
def test_sources_import_no_jax_and_no_reference(path):
    src = path.read_text()
    assert not re.search(r"^\s*(import|from)\s+jax\b", src, re.M), path
    assert not re.search(r"^\s*(import|from)\s+hyperspace_tpu(\.|\s|$)", src, re.M), path


def test_native_runtime_stands_alone_with_no_off_switch():
    """The native runtime's directory holds its bindings and its own copy
    of the C++ source; neither names the reference's directory or
    package, and no source of the port reads a switch that turns the
    runtime off (the reference's ``HYPERSPACE_TPU_NATIVE``)."""
    ndir = PKG / "native"
    assert sorted(p.name for p in ndir.iterdir() if p.name != "__pycache__") == [
        "__init__.py", "tcb_io.cc"]
    init = (ndir / "__init__.py").read_text()
    assert "hyperspace_tpu/" not in init and "parent.parent.parent" not in init
    for path in sorted(PKG.rglob("*.py")) + [PKG.parent / "chip_smoke.py"]:
        assert "HYPERSPACE_TPU_NATIVE" not in path.read_text(), path


def test_resolve_device_defaults_to_cuda_and_raises_without_it(monkeypatch):
    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(HyperspaceException, match="cuda"):
        resolve_device()
    with pytest.raises(HyperspaceException):
        resolve_device("cuda:0")


def test_session_defaults_to_cuda(monkeypatch, tmp_path):
    from hyperspace_tpu_torch import HyperspaceConf
    from hyperspace_tpu_torch.session import HyperspaceSession

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    conf = HyperspaceConf({"hyperspace.system.path": str(tmp_path)})
    with pytest.raises(HyperspaceException):
        HyperspaceSession(conf)
    conf.set("hyperspace.torch.device", "cpu")
    assert HyperspaceSession(conf).device == torch.device("cpu")
