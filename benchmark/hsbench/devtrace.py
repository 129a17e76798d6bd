"""The device trace of a window: ``torch.profiler`` with CPU and CUDA
activity around the whole window, reduced to the device's busy time (the
union of kernel, copy and set intervals inside the window), the time by
device operation, and the longest idle gaps.

The card's machine has been seen to drop device records after the card
idled 15 s or more; a trace whose kernels number fewer than the launches
the host made says so (``records_missing``), and the idle share is then
not reported. Host operations of the server's worker threads are not
recorded (the profiler records those of the thread that starts it), so a
gap is named by a runtime call that spans it, else by the device
operation that ends it.
"""

from __future__ import annotations

import re
import time
from collections import defaultdict

import numpy as np

WINDOW = "hsbench.window"
_LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernelEx")
_GAPS_NAMED = 200  # the longest gaps that get a name
# words of a demangled kernel name that say nothing of what it computes
_NOISE = {"void", "at", "native", "anonymous", "namespace", "lambda", "operator", "const", "int",
          "long", "unsigned", "char", "std", "array", "ul", "bool", "double", "float", "c10",
          "Scalar", "Tensor", "TensorIterator", "TensorIteratorBase", "detail", "cuda",
          "TensorInfo", "vectorized_elementwise_kernel", "unrolled_elementwise_kernel",
          "elementwise_kernel", "elementwise_kernel_with_index", "function_traits",
          "result_type", "TrivialOffsetCalculator", "memory", "LoadWithCast", "StoreWithCast",
          "signed", "short", "true", "false", "OffsetCalculator"}


def short_name(name: str) -> str:
    """A device operation's name without its template noise: the first two
    telling words of a demangled kernel, a copy's or a set's name whole."""
    if name.startswith(("Memcpy", "Memset")):
        return name
    words = [w for w in re.findall(r"[A-Za-z_][A-Za-z0-9_]*", name) if w not in _NOISE]
    return " ".join(dict.fromkeys(words[:2])) or name[:60]


def warm() -> None:
    """Start and stop the profiler once on the card, so that its own
    start-up belongs to set-up and not to the window."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.ones(1024, device="cuda").sum().item()


class Trace:
    def __init__(self):
        from torch.profiler import ProfilerActivity, profile, record_function

        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._rf = record_function(WINDOW)

    def start(self) -> None:
        self._prof.__enter__()
        self._rf.__enter__()

    def stop(self) -> None:
        import torch

        torch.cuda.synchronize()
        self._rf.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)

    def reduce(self) -> dict:
        t0 = time.perf_counter()
        events = self._prof.profiler.kineto_results.events()
        win = next(e for e in events if e.name() == WINDOW and str(e.device_type()).endswith("CPU"))
        w0, w1 = win.start_ns(), win.start_ns() + win.duration_ns()
        dev_s, dev_e, dev_n = [], [], []
        host_s, host_e, host_n = [], [], []
        launches = kernels = 0
        for e in events:
            name = e.name()
            s, d = e.start_ns(), e.duration_ns()
            if not str(e.device_type()).endswith("CPU"):
                if e.is_user_annotation():
                    continue
                dev_s.append(s)
                dev_e.append(s + d)
                dev_n.append(name)
                kernels += not name.startswith(("Memcpy", "Memset"))
            elif name in _LAUNCHES:
                launches += 1
            elif name.startswith("cuda"):  # the runtime calls of every thread
                host_s.append(s)
                host_e.append(s + d)
                host_n.append(name)
        ds = np.clip(np.array(dev_s, dtype=np.int64), w0, w1)
        de = np.clip(np.array(dev_e, dtype=np.int64), w0, w1)
        by_op = defaultdict(int)
        for n, d in zip(dev_n, (de - ds).tolist()):
            by_op[n] += d
        # the union of device intervals, and the gaps between them
        order = np.argsort(ds, kind="stable")
        busy, gaps, cur_s, cur_e = 0, [], None, w0
        for s, e in zip(ds[order].tolist(), de[order].tolist()):
            if e <= s:
                continue
            if cur_s is None or s > cur_e:
                if cur_s is not None:
                    busy += cur_e - cur_s
                if s > cur_e:
                    gaps.append((s - cur_e, cur_e, s))
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_s is not None:
            busy += cur_e - cur_s
        if w1 > cur_e:
            gaps.append((w1 - cur_e, cur_e, w1))
        gaps.sort(reverse=True)
        hs, he = np.array(host_s, dtype=np.int64), np.array(host_e, dtype=np.int64)
        starts = ds[order]
        named = defaultdict(int)
        for g, a, b in gaps[:_GAPS_NAMED]:
            mid = (a + b) // 2
            cover = np.flatnonzero((hs <= mid) & (he >= mid))
            if len(cover):
                label = "host in " + host_n[cover[np.argmax((he - hs)[cover])]]
            else:
                nxt = np.searchsorted(starts, b)
                label = ("host before " + short_name(dev_n[order[nxt]])
                         if nxt < len(starts) else "host at the close")
            named[label] += g
        top = lambda d: [[n, v / 1e9] for n, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
        return {
            "window_s": (w1 - w0) / 1e9,
            "busy_s": busy / 1e9,
            "device_ops": top(by_op),
            "idle_gaps": top(named),
            "kernels": kernels,
            "launches": launches,
            # a launch in the last instant before the profiler stops may lose
            # its kernel; the machine's loss after an idle card loses many
            "records_missing": kernels < 0.99 * launches,
            "reduce_s": time.perf_counter() - t0,
        }
