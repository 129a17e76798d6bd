"""Whether the per-query profiler's trace keeps a launch's device record.

    python3 -m hyperspace_tpu_torch.tools.profile_probe [--idle 15] [--repeats 3]
        [--wait 5] [--out hyperspace_tpu_torch/_build/profile_probe.json]

Runs one K1 launch (``predicate_mask_tensor`` over 2^20 rows, read back)
under ``dataframe._query_profile``, the arm ``hyperspace.tpu.profile.dir``
turns on, at once, then after ``--idle`` seconds of an idle card
``--repeats`` times, then once with the launch ``--wait`` seconds into the
profiler's window. For each it prints whether the Chrome trace holds K1's
device function beside its ``hs_predicate_mask`` range and its
``cudaLaunchKernel``, whether the profiler said it dropped kernel records
(``trace.profile.device_records_missing``), and, where the record was
kept, the card's timestamp minus the launch's in ms. torch's profiler
drops a device record whose timestamp falls outside its window, so a
skew between the card's clock and the host's larger than the window's
margin loses the record. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
import warnings
from pathlib import Path

import torch

from ..dataframe import _query_profile
from ..ops import kernels as K
from ..plan.expr import col
from ..telemetry.metrics import metrics

_OUT = Path(__file__).resolve().parent.parent / "_build" / "profile_probe.json"


def _trial(label: str, cols, wait_s: float) -> dict:
    missing0 = metrics.get("trace.profile.device_records_missing")
    with tempfile.TemporaryDirectory() as d:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            with _query_profile(d, cols[0].device):
                if wait_s:
                    time.sleep(wait_s)
                K.predicate_mask_tensor(col("a") < 1000, ("a",), cols).cpu()
        (trace,) = Path(d).glob("query-*.pt.trace.json")
        events = json.loads(trace.read_text())["traceEvents"]
    kernel = [e for e in events if e.get("cat") == "kernel"
              and "predicate_mask_kernel" in e.get("name", "")]
    launch = [e for e in events if e.get("name") == "cudaLaunchKernel"]
    rec = {
        "trial": label,
        "device_record": bool(kernel),
        "range": any(e.get("name") == "hs_predicate_mask" for e in events),
        "launch": bool(launch),
        "missing_counted": metrics.get("trace.profile.device_records_missing") - missing0,
        "skew_ms": (kernel[0]["ts"] - launch[-1]["ts"]) / 1e3 if kernel and launch else None,
    }
    print(json.dumps(rec), flush=True)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--idle", type=float, default=15.0)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--wait", type=float, default=5.0)
    ap.add_argument("--out", default=str(_OUT))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_probe: needs a CUDA card", file=sys.stderr)
        return 2
    K.build_kernels([K.K1])
    cols = [torch.arange(1 << 20, dtype=torch.int32, device="cuda")]
    out = [_trial("at once", cols, 0.0)]
    for i in range(args.repeats):
        time.sleep(args.idle)
        out.append(_trial(f"after {args.idle * (i + 1):g} s idle", cols, 0.0))
    time.sleep(args.idle)
    out.append(_trial(f"after idle, launched {args.wait:g} s into the window", cols, args.wait))
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps({"device": torch.cuda.get_device_name(0),
                                          "trials": out}, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
