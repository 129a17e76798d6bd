"""The closed loop: each client submits its next query when its ticket
returns, with no think time, for the window's seconds. A client's queries
come from the mix's stream for it, so the same seed sends the same
sequence; how far each client gets depends on the system.

Every query is timed on the client, from ``submit`` to ``result()``. At
the close clients send nothing more and wait for the ticket in flight, a
minute past the close at most; such an answer is compared but does not
count among the window's completed queries.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

from .check import as_columns, summary

WAIT_PAST_CLOSE_S = 60.0


@dataclass
class Window:
    seconds: float
    start: float = 0.0
    # (query id, columns kept whole or None, summary, submitted, answered)
    records: list = field(default_factory=list)
    # (query id, submitted, error)
    failures: list = field(default_factory=list)

    @property
    def attempted(self) -> int:
        return len(self.records) + len(self.failures)

    def completed_in_window(self) -> list:
        end = self.start + self.seconds
        return [r for r in self.records if r[4] <= end]


def _clients(mix, body) -> None:
    threads = [threading.Thread(target=body, args=(c,), name=f"hsbench-client-{c}")
               for c in range(mix.clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()


def warm(server, mix, frames) -> int:
    """Set-up's load: every client sends ``mix.warm_queries`` queries of a
    stream of its own (not the window's), all at once, so that the server's
    workers, the plan cache and the card's allocator meet the window's
    concurrency before it opens. Returns the queries answered."""
    errors = []

    def client(c: int):
        stream = mix.stream(mix.clients + c)
        for _ in range(mix.warm_queries):
            s, p, _u = next(stream)
            try:
                server.submit(frames[s][p]).result(timeout=600)
            except Exception as e:  # noqa: BLE001 - re-raised below
                errors.append(e)

    _clients(mix, client)
    if errors:
        raise errors[0]
    return mix.clients * mix.warm_queries


def run(server, mix, frames, seconds: float, whole_rows: int, keep_share: float,
        at_open=None, at_close=None) -> Window:
    """``frames[s][p]``: the DataFrame of shape ``s``'s parameter set
    ``p``. ``at_open`` runs just before the clients start and ``at_close``
    when the window closes, before the last tickets return."""
    win = Window(seconds)
    lock = threading.Lock()
    gate = threading.Barrier(mix.clients + 1)

    def client(c: int):
        stream = mix.stream(c)
        gate.wait()
        end = win.start + seconds
        while time.perf_counter() < end:
            s, p, u = next(stream)
            t0 = time.perf_counter()
            try:
                ticket = server.submit(frames[s][p])
                res = ticket.result(timeout=max(1.0, end + WAIT_PAST_CLOSE_S - t0))
                t1 = time.perf_counter()
            except Exception as e:  # noqa: BLE001 - a failed query is a result
                with lock:
                    win.failures.append(((s, p), t0, repr(e)))
                continue
            cols = as_columns(res)
            summ = summary(cols)
            keep = cols if summ[0] <= whole_rows or u < keep_share else None
            with lock:
                win.records.append(((s, p), keep, summ, t0, t1))

    def main():
        if at_open is not None:
            at_open()
        win.start = time.perf_counter()
        gate.wait()
        time.sleep(max(0.0, win.start + seconds - time.perf_counter()))
        if at_close is not None:
            at_close()

    opener = threading.Thread(target=main, name="hsbench-window")
    opener.start()
    _clients(mix, client)
    opener.join()
    return win
