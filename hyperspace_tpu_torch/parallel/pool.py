"""Host worker-pool primitives of the pipelined index build.

A copy of ``hyperspace_tpu.parallel.pool``. The streaming build
(index/stream_builder.py) is a staged pipeline — ingest decode →
device/host partition+sort → spill compute (D2H wait + gather) → spill
write → per-bucket merge — and every stage runs on these:

* :class:`FirstError` — a cross-stage failure latch: the FIRST exception
  anywhere in the pipeline wins, every stage observes it and drains, and
  the main thread re-raises exactly that exception;
* :class:`BoundedSlots` — a failure-aware in-flight slot counter (the
  device engine's bound on chunks dispatched but not yet fetched);
* :class:`WorkerPool` — N daemon workers behind a BOUNDED queue
  (backpressure is the memory bound);
* :func:`ordered_map` — a parallel map over an iterator that yields
  results in INPUT order with a bounded in-flight window, so chunk order
  (hence stable-sort tie order, hence the index bytes) is a serial
  build's;
* :func:`run_parallel` — bounded fan-out over a closed task list (the
  per-bucket merges of finalize, optimize and compaction).

No blocking call runs under a lock: waits go through ``Condition.wait`` /
``Queue`` timeouts so a failed pipeline can always tear down.

Every task runs in a copy of its submitter's ``contextvars`` context, so a
query's scoped metrics and its active trace span follow it into the
workers (``telemetry/metrics.py:scoped``, ``telemetry/trace.py``): a
batch's counters are not split across threads.
"""

from __future__ import annotations

import contextvars
import queue
import threading
from typing import Callable, Iterable, Iterator, List, Optional, TypeVar

T = TypeVar("T")
R = TypeVar("R")


class FirstError:
    """First-failure latch shared by every stage of one pipeline.

    ``fail()`` records the first exception only (later ones lose — they
    are almost always teardown echoes of the first); ``failed`` is an
    Event so stages can poll without a lock; ``check()`` re-raises the
    recorded exception on the calling thread — the "first error
    re-raised on the main thread" contract of the build's abort story.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._exc: Optional[BaseException] = None
        self.failed = threading.Event()

    def fail(self, exc: BaseException) -> None:
        with self._lock:
            if self._exc is None:
                self._exc = exc
        self.failed.set()

    @property
    def error(self) -> Optional[BaseException]:
        with self._lock:
            return self._exc

    def check(self) -> None:
        if self.failed.is_set():
            exc = self.error
            if exc is not None:
                raise exc


class BoundedSlots:
    """A bounded in-flight slot counter whose acquire is FAILURE-AWARE:
    the wait polls the shared :class:`FirstError` latch, so after a
    pipeline failure (draining pools never release their slots) a
    producer blocked on a slot re-raises the first error instead of
    parking forever. The device build engine bounds its HBM high-water
    with one of these: dispatched-but-unfetched chunks AND in-flight
    staged-run merges each pin device buffers until their fetch."""

    def __init__(self, n: int, failure: FirstError) -> None:
        self._sem = threading.BoundedSemaphore(max(1, int(n)))
        self.failure = failure

    def acquire(self) -> None:
        while not self._sem.acquire(timeout=0.05):
            self.failure.check()

    def release(self) -> None:
        self._sem.release()


class WorkerPool:
    """N daemon threads draining a bounded task queue.

    Tasks are zero-arg callables. A task that raises latches the shared
    :class:`FirstError`; after a failure (or :meth:`abort`) workers keep
    draining the queue WITHOUT running tasks, so producers blocked on the
    bounded ``submit`` always unblock and ``close`` always joins — no
    parked threads, whatever order the pipeline died in.
    """

    def __init__(
        self,
        workers: int,
        name: str,
        queue_depth: int = 2,
        failure: Optional[FirstError] = None,
    ) -> None:
        self.workers = max(1, int(workers))
        self.failure = failure if failure is not None else FirstError()
        self._discard = threading.Event()
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, int(queue_depth)))
        self._threads = [
            threading.Thread(target=self._run, daemon=True, name=f"{name}-{i}")
            for i in range(self.workers)
        ]
        self._closed = False
        for t in self._threads:
            t.start()

    def _run(self) -> None:
        while True:
            task = self._q.get()
            if task is None:
                return
            if self._discard.is_set() or self.failure.failed.is_set():
                continue  # drain so producers/close never block forever
            try:
                task()
            except BaseException as e:  # noqa: BLE001 - latched, re-raised on main
                self.failure.fail(e)

    def submit(self, task: Callable[[], None]) -> bool:
        """Bounded enqueue. Returns False (task NOT queued) once the
        pipeline has failed or the pool is draining — the caller should
        then ``failure.check()`` to surface the original error."""
        ctx = contextvars.copy_context()
        run = lambda: ctx.run(task)  # noqa: E731 - the submitter's context
        while not self._discard.is_set() and not self.failure.failed.is_set():
            try:
                self._q.put(run, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def close(self) -> None:
        """Finish queued work (unless failed/aborted — then drain) and
        join every worker. Idempotent."""
        if self._closed:
            return
        self._closed = True
        for _ in self._threads:
            self._q.put(None)  # workers always drain, so this unblocks
        for t in self._threads:
            t.join()

    def abort(self) -> None:
        """Discard queued work and join. Running tasks finish (file
        writes stay atomic); queued ones are dropped."""
        self._discard.set()
        self.close()


def ordered_map(
    fn: Callable[[T], R],
    items: Iterable[T],
    workers: int,
    window: int,
    name: str = "ordered-map",
    failure: Optional[FirstError] = None,
) -> Iterator[R]:
    """Apply ``fn`` to ``items`` on ``workers`` threads, yielding results
    in INPUT order with at most ``window`` items past the consumer.

    The input iterator is advanced under the coordination lock — it must
    be cheap (yield descriptions of work, e.g. zero-arg decode tasks);
    the expensive part belongs in ``fn``. Any failure — in the iterator,
    in ``fn``, or injected through a shared ``failure`` latch — stops
    all workers and re-raises at the consumer. Closing the generator
    mid-stream (consumer abandons) tears the workers down without
    running the remaining items.
    """
    fail = failure if failure is not None else FirstError()
    stop = threading.Event()
    cond = threading.Condition()
    results: dict = {}
    state = {"submitted": 0, "yielded": 0, "exhausted": False}
    it = iter(items)
    workers = max(1, int(workers))
    window = max(workers, int(window))

    def work() -> None:
        while True:
            if stop.is_set() or fail.failed.is_set():
                return
            with cond:
                if state["exhausted"]:
                    return
                if state["submitted"] - state["yielded"] >= window:
                    cond.wait(0.05)
                    continue
                try:
                    item = next(it)
                except StopIteration:
                    state["exhausted"] = True
                    cond.notify_all()
                    return
                except BaseException as e:  # noqa: BLE001 - latched for consumer
                    fail.fail(e)
                    state["exhausted"] = True
                    cond.notify_all()
                    return
                seq = state["submitted"]
                state["submitted"] += 1
            try:
                res = fn(item)
            except BaseException as e:  # noqa: BLE001 - latched for consumer
                fail.fail(e)
                with cond:
                    cond.notify_all()
                return
            with cond:
                results[seq] = res
                cond.notify_all()

    # each worker runs in its own copy of the consumer's context
    threads = [
        threading.Thread(target=contextvars.copy_context().run, args=(work,), daemon=True,
                         name=f"{name}-{i}")
        for i in range(workers)
    ]
    for t in threads:
        t.start()
    try:
        seq = 0
        while True:
            with cond:
                while seq not in results:
                    fail.check()
                    if state["exhausted"] and state["submitted"] == seq:
                        return
                    cond.wait(0.05)
                res = results.pop(seq)
                state["yielded"] += 1
                cond.notify_all()
            yield res
            seq += 1
    finally:
        stop.set()
        with cond:
            cond.notify_all()
        for t in threads:
            t.join()


def run_parallel(
    tasks: List[Callable[[], R]],
    workers: int,
    name: str = "fanout",
) -> List[R]:
    """Run a closed list of tasks across ``workers`` threads; results in
    task order; the first failure cancels the rest and re-raises here."""
    if not tasks:
        return []
    if workers <= 1 or len(tasks) == 1:
        return [t() for t in tasks]
    return list(
        ordered_map(lambda t: t(), tasks, workers, window=len(tasks), name=name)
    )
