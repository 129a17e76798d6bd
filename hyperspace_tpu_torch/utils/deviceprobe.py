"""Card reachability probe.

Counterpart of ``hyperspace_tpu.utils.deviceprobe``. A wedged driver or a
lost card can hang a process's first CUDA call with the GIL released, so
the first in-process touch runs on a daemon thread under a watchdog and
its verdict is latched for the process. Where the reference routes its
host engine on a False verdict, the callers here raise
``DeviceUnavailableError``: every engine path of this package runs on the
card.

* ``device_reachable`` — a fresh process asks ``torch.cuda.is_available()``
  under a hard timeout (an in-process hang would take the caller with it);
* ``first_device_touch_ok`` — a 16-element round trip to the card, then
  ``torch.cuda.synchronize``, under the watchdog; the verdict latches
  (first writer wins) and a leaked thread of a superseded election never
  writes into a later one (its election token);
* ``latched_verdict`` / ``first_touch_error`` — the latch, read without
  starting a touch or waiting on one.
"""

from __future__ import annotations

import os
import subprocess
import sys
import threading

TIMEOUT_ENV = "HYPERSPACE_TPU_TORCH_FIRST_TOUCH_TIMEOUT_S"
_TIMEOUT_DEFAULT_S = 120.0


def device_reachable(timeout_s: int = 150) -> bool:
    """True when a fresh process finds a CUDA device within ``timeout_s``."""
    try:
        p = subprocess.run(
            [sys.executable, "-c",
             "import torch; assert torch.cuda.is_available(); print('ok')"],
            capture_output=True,
            text=True,
            timeout=timeout_s,
        )
        return p.returncode == 0 and "ok" in p.stdout
    # hslint: disable=HS004 - the False return IS the probe verdict;
    # callers branch on it and degrade to host paths (nothing is silent)
    except Exception:  # noqa: BLE001 - a timeout or spawn failure is the verdict
        return False


# The process-wide verdict. The lock guards only the starter election and
# the latch; callers wait on the event with their own timeout.
_FIRST_TOUCH_LOCK = threading.Lock()
_FIRST_TOUCH: dict = {}
_FIRST_TOUCH_DONE = threading.Event()


def _latch_first_touch(ok: bool, error: "str | None", token: "object | None" = None) -> None:
    """Record the verdict once (first writer wins) and wake every waiter.
    ``token`` is the touch thread's election token: a thread of a
    superseded election (the latch was reset) does not write. Callers
    latch with ``token=None``."""
    with _FIRST_TOUCH_LOCK:
        if token is not None and _FIRST_TOUCH.get("token") is not token:
            return
        if "ok" not in _FIRST_TOUCH:
            _FIRST_TOUCH["ok"] = ok
            _FIRST_TOUCH["error"] = error
        _FIRST_TOUCH_DONE.set()


def _timeout_from_env() -> float:
    try:
        return float(os.environ.get(TIMEOUT_ENV, str(_TIMEOUT_DEFAULT_S)))
    except ValueError:
        return _TIMEOUT_DEFAULT_S


def _touch(device: str) -> None:
    """The first touch: 16 int32 to the card and back, then a fence."""
    import torch

    dev = torch.device(device)
    t = torch.arange(16, dtype=torch.int32).to(dev)
    back = t.cpu()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    if int(back.sum()) != 120:
        raise RuntimeError(f"first touch of {dev} read back {back.tolist()}")


def first_device_touch_ok(timeout_s: "float | None" = None, device: str = "cuda") -> bool:
    """This process's first touch of ``device`` under a watchdog. False on
    a timeout (the blocked daemon thread is left behind: it cannot be
    cancelled and does not block exit) or an error. Concurrent callers
    each wait their own ``timeout_s``; the default is 120 s, or
    ``HYPERSPACE_TPU_TORCH_FIRST_TOUCH_TIMEOUT_S``."""
    if timeout_s is None:
        timeout_s = _timeout_from_env()
    if "ok" in _FIRST_TOUCH:
        return _FIRST_TOUCH["ok"]
    with _FIRST_TOUCH_LOCK:
        if "ok" in _FIRST_TOUCH:
            return _FIRST_TOUCH["ok"]
        if not _FIRST_TOUCH.get("started"):
            _FIRST_TOUCH["started"] = True
            token = _FIRST_TOUCH["token"] = object()

            def touch() -> None:
                try:
                    _touch(device)
                    _latch_first_touch(True, None, token)
                except Exception as e:  # noqa: BLE001 - a raise is a verdict, not a hang
                    _latch_first_touch(False, repr(e), token)

            threading.Thread(
                target=touch, daemon=True, name="hyperspace-device-first-touch"
            ).start()
    _FIRST_TOUCH_DONE.wait(timeout_s)
    # no verdict in time: latch the hang ("error" stays None, so a hang
    # and a raise stay apart)
    _latch_first_touch(False, None)
    return _FIRST_TOUCH["ok"]


def latched_verdict() -> "bool | None":
    """The latched verdict, or None while there is none."""
    return _FIRST_TOUCH.get("ok")


def first_touch_error() -> "str | None":
    """The repr of a failed (not timed-out) first touch, or None."""
    return _FIRST_TOUCH.get("error")


def unavailable_reason() -> str:
    """The probe's reason for a False verdict, for DeviceUnavailableError."""
    err = first_touch_error()
    if err is not None:
        return f"the first device touch failed: {err}"
    return "the first device touch hung past its watchdog"


def require_device(device) -> None:
    """Raise DeviceUnavailableError when ``device`` is a CUDA device and
    the probe finds it unreachable; the CPU, asked for, needs no probe."""
    import torch

    from ..exceptions import DeviceUnavailableError
    from ..telemetry.metrics import metrics

    dev = torch.device(device)
    if dev.type != "cuda":
        return
    if not first_device_touch_ok(device=str(dev)):
        metrics.incr("device.unreachable")
        raise DeviceUnavailableError(unavailable_reason())

