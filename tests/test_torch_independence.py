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
