"""Parity of the port's device probe (``hyperspace_tpu_torch/utils/
deviceprobe.py``) with the JAX package's, on the CPU: the first touch runs
on a daemon thread under a watchdog and latches a per-process verdict.

Each scenario runs in both packages with the touch made to hang or to
raise (the reference's ``jax.device_put``, the port's ``_touch``); the
verdicts, the latched state and whether the caller came back within its
own timeout must be equal. Mirrors ``tests/test_deviceprobe.py``.
"""

import threading
import time

import pytest

from hyperspace_tpu.utils import deviceprobe as jprobe

from hyperspace_tpu_torch.utils import deviceprobe as tprobe

PROBES = {"jax": jprobe, "torch": tprobe}


@pytest.fixture(autouse=True)
def fresh_latch():
    saved = {k: (dict(p._FIRST_TOUCH), p._FIRST_TOUCH_DONE.is_set()) for k, p in PROBES.items()}
    for p in PROBES.values():
        p._FIRST_TOUCH.clear()
        p._FIRST_TOUCH_DONE.clear()
    yield
    for k, p in PROBES.items():
        p._FIRST_TOUCH.clear()
        p._FIRST_TOUCH.update(saved[k][0])
        (p._FIRST_TOUCH_DONE.set if saved[k][1] else p._FIRST_TOUCH_DONE.clear)()


def _patch_touch(monkeypatch, pkg, fn):
    if pkg == "jax":
        import jax

        monkeypatch.setattr(jax, "device_put", fn)
    else:
        monkeypatch.setattr(tprobe, "_touch", fn)


def _touch_ok(pkg, timeout_s):
    if pkg == "jax":
        return jprobe.first_device_touch_ok(timeout_s=timeout_s)
    return tprobe.first_device_touch_ok(timeout_s=timeout_s, device="cpu")


def test_first_touch_ok_on_the_cpu():
    for pkg in PROBES:
        assert _touch_ok(pkg, 30.0) is True
        assert PROBES[pkg].latched_verdict() is True
        assert PROBES[pkg].first_touch_error() is None


def test_hang_times_out_and_latches(monkeypatch):
    out = {}
    for pkg, probe in PROBES.items():
        gate = threading.Event()
        _patch_touch(monkeypatch, pkg, lambda *a, _g=gate, **k: _g.wait(10))
        t0 = time.perf_counter()
        first = _touch_ok(pkg, 0.2)
        fast = time.perf_counter() - t0 < 5
        monkeypatch.undo()
        # latched: a later caller does not re-pay the timeout, even with
        # the touch restored
        out[pkg] = (first, fast, _touch_ok(pkg, 30.0), probe.latched_verdict(),
                    probe.first_touch_error())
        gate.set()
    assert out["torch"] == out["jax"] == (False, True, False, False, None)


def test_raise_is_a_verdict_with_its_error(monkeypatch):
    out = {}
    for pkg, probe in PROBES.items():
        def boom(*a, **k):
            raise RuntimeError("no CUDA-capable device is detected")

        _patch_touch(monkeypatch, pkg, boom)
        out[pkg] = (_touch_ok(pkg, 5.0), "no CUDA-capable device" in probe.first_touch_error())
        monkeypatch.undo()
    assert out["torch"] == out["jax"] == (False, True)
    assert "failed" in tprobe.unavailable_reason()


def test_concurrent_caller_honors_its_own_timeout(monkeypatch):
    """A second caller waits its own timeout, not the first's, latches the
    hang and wakes the first caller too."""
    out = {}
    for pkg, probe in PROBES.items():
        gate = threading.Event()
        _patch_touch(monkeypatch, pkg, lambda *a, _g=gate, **k: _g.wait(30))
        first = {}
        t = threading.Thread(target=lambda: first.update(ok=_touch_ok(pkg, 25.0)), daemon=True)
        t.start()
        deadline = time.perf_counter() + 5.0
        while not probe._FIRST_TOUCH.get("started"):
            assert time.perf_counter() < deadline
            time.sleep(0.01)
        t0 = time.perf_counter()
        second = _touch_ok(pkg, 0.3)
        elapsed = time.perf_counter() - t0
        t.join(10)
        out[pkg] = (second, elapsed < 5, t.is_alive(), first.get("ok"))
        gate.set()
        monkeypatch.undo()
    assert out["torch"] == out["jax"] == (False, True, False, False)


def test_stale_touch_thread_cannot_write_a_new_latch(monkeypatch):
    """A watchdog thread left behind by a timed-out election completes
    after the latch was reset: its verdict is dropped (election token)."""
    out = {}
    for pkg, probe in PROBES.items():
        gate = threading.Event()

        def late(*a, _g=gate, **k):
            _g.wait(20)
            raise RuntimeError("stale touch completing late")

        _patch_touch(monkeypatch, pkg, late)
        before = set(threading.enumerate())
        first = _touch_ok(pkg, 0.2)
        leaked = [t for t in set(threading.enumerate()) - before
                  if t.name == "hyperspace-device-first-touch"]
        probe._FIRST_TOUCH.clear()
        probe._FIRST_TOUCH_DONE.clear()
        gate.set()
        for t in leaked:
            t.join(10)
        stale = ("ok" in probe._FIRST_TOUCH, probe._FIRST_TOUCH_DONE.is_set())
        monkeypatch.undo()
        out[pkg] = (first, bool(leaked), stale, _touch_ok(pkg, 30.0))
    assert out["torch"] == out["jax"] == (False, True, (False, False), True)


@pytest.mark.parametrize("value", ["not-a-number", "", "45"])
def test_timeout_environment_variable_parse(monkeypatch, value):
    """A malformed timeout falls back to the default (120 s) instead of
    raising; a number is taken. The port reads its own variable."""
    monkeypatch.setenv("HYPERSPACE_TPU_FIRST_TOUCH_TIMEOUT_S", value)
    monkeypatch.setenv(tprobe.TIMEOUT_ENV, value)
    assert tprobe.TIMEOUT_ENV == "HYPERSPACE_TPU_TORCH_FIRST_TOUCH_TIMEOUT_S"
    want = 45.0 if value == "45" else 120.0
    assert tprobe._timeout_from_env() == want
    for pkg in PROBES:
        assert _touch_ok(pkg, None) is True


def test_subprocess_reachability_and_its_timeout(monkeypatch):
    """``device_reachable`` asks a fresh process; a hang past the timeout
    or a failed spawn is False, as in the reference."""
    import subprocess

    def hang(*a, **k):
        raise subprocess.TimeoutExpired(a[0], k.get("timeout"))

    for probe in PROBES.values():
        monkeypatch.setattr(probe.subprocess, "run", hang)
        assert probe.device_reachable(timeout_s=1) is False
        monkeypatch.undo()

    class Done:
        returncode, stdout = 0, "ok\n"

    seen = {}

    def fake_run(cmd, **k):
        seen["cmd"] = cmd
        return Done()

    monkeypatch.setattr(tprobe.subprocess, "run", fake_run)
    assert tprobe.device_reachable(timeout_s=1) is True
    assert "torch.cuda.is_available()" in seen["cmd"][-1] and "jax" not in seen["cmd"][-1]
