"""What the host does during a run: CPU seconds by thread, grouped by what
the thread is, the process's peak resident memory (read from
``/proc/self/task`` on Linux; elsewhere the readings are empty), and where
the server's threads stand, sampled from the interpreter's frames."""

from __future__ import annotations

import os
import re
import resource
import sys
import threading
from collections import Counter
from pathlib import Path

_TASKS = Path("/proc/self/task")


def thread_cpu() -> dict:
    """{thread id: (name, user + system CPU seconds)} of this process. A
    Python thread is named by its ``threading`` name, any other (the
    runtime's and the libraries' threads) by its kernel name in brackets."""
    if not _TASKS.is_dir():
        return {}
    names = {t.native_id: t.name for t in threading.enumerate()}
    tick = os.sysconf("SC_CLK_TCK")
    out = {}
    for d in _TASKS.iterdir():
        try:
            stat = (d / "stat").read_text()
            comm = (d / "comm").read_text().strip()
        except OSError:  # the thread ended
            continue
        fields = stat[stat.rindex(")") + 2:].split()
        tid = int(d.name)
        out[tid] = (names.get(tid, f"[{comm}]"), (int(fields[11]) + int(fields[12])) / tick)
    return out


def cpu_by_group(before: dict, after: dict) -> dict:
    """CPU seconds spent between two ``thread_cpu()`` readings, by group:
    a name with its numbering taken off (``hsbench-client-3`` and
    ``hsbench-client-12`` are ``hsbench-client``), with the threads counted."""
    groups = {}
    for tid, (name, s) in after.items():
        spent = s - before.get(tid, (name, 0.0))[1]
        key = re.sub(r"[-_]?\d+$", "", name) or name
        n, total = groups.get(key, (0, 0.0))
        groups[key] = (n + 1, total + spent)
    return {k: [n, round(v, 3)] for k, (n, v) in
            sorted(groups.items(), key=lambda kv: -kv[1][1]) if v > 0}


def peak_rss_bytes() -> int:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


class StackSampler:
    """Every ``period`` seconds, where each thread whose name starts with
    ``prefix`` stands: the innermost frame of its stack inside ``package``
    (the program's line it runs or waits in), and its innermost frame
    whatever the file. A thread inside a C call that let the interpreter
    go, such as a copy home that waits for the card, shows the Python line
    that made the call."""

    def __init__(self, prefix: str, package: str, period: float = 0.01):
        self.prefix, self.package, self.period = prefix, package, period
        self.program = Counter()
        self.innermost = Counter()
        self.samples = 0
        self._stop = threading.Event()
        self._thread = None

    def _where(self, frame) -> str:
        while frame is not None:
            path = frame.f_code.co_filename
            i = path.rfind(self.package)
            if i >= 0:
                return f"{path[i:]}:{frame.f_lineno} {frame.f_code.co_name}"
            frame = frame.f_back
        return "outside the program"

    def _run(self) -> None:
        while not self._stop.wait(self.period):
            names = {t.ident: t.name for t in threading.enumerate()}
            for ident, frame in sys._current_frames().items():
                if not names.get(ident, "").startswith(self.prefix):
                    continue
                self.samples += 1
                self.program[self._where(frame)] += 1
                code = frame.f_code
                self.innermost[f"{Path(code.co_filename).name}:{frame.f_lineno} "
                               f"{code.co_name}"] += 1

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, name="hsbench-sampler", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join()

    def top(self, n: int = 12) -> dict:
        """The ``n`` commonest places of each kind, as shares of the
        samples."""
        share = lambda c: [[k, round(v / max(1, self.samples), 4)] for k, v in c.most_common(n)]
        return {"samples": self.samples, "program": share(self.program),
                "innermost": share(self.innermost)}
