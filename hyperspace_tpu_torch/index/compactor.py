"""Compaction of runs-layout indexes: the shared per-bucket merge that
optimize writes through, and the background compactor's committed steps.

Parity: ``hyperspace_tpu.index.compactor``. The runs layout (build
``finalizeMode=runs``) writes every row once at build time and defers the
per-bucket layout; this module closes the gap:

* **the shared runs→compact write path** — ``compact_bucket_group`` is the
  one copy of "merge a bucket's parts (its small per-bucket files, then its
  run segments in run order) into one freshly written bucket file":
  ``OptimizeAction`` runs every bucket through it in one commit, the
  compactor a slice per step. Run segments are read through the coalesced
  planner (``storage.layout.plan_segment_reads``: one ordered sweep per
  run), and both callers record the same ``compaction.*`` metrics;

* **CompactionStep** — one committed increment: compact ``bucketsPerStep``
  run-held (or multi-small-file) buckets into per-bucket files and rewrite
  the remaining runs minus those buckets (files are immutable: a rewrite is
  the only way rows leave a run), through the operation log's begin → op →
  end with OCC on the log. Readers of the previous version keep its files
  until vacuum;

* **IndexCompactor** — ``step``, ``compact_index`` and ``sweep`` over a
  session's indexes; ``Hyperspace.compact_index`` is the explicit verb.

Convergence (no run files and no multi-small-file bucket left) gives
exactly ``optimize(quick)``'s file layout.

Not ported yet, each waiting for its item of ROADMAP.md's queue A: the
reference fences each step with a writer lease and recovers a dead one
(reliability); it orders buckets by the heat queries note on them
(``exec/scan_gate``, the scan gate), where this package takes them in
bucket-id order, the reference's order when no heat is recorded; and a
hosting server sweeps on a timer (serving).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..exceptions import (
    ConcurrentModificationException,
    HyperspaceException,
    NoChangesException,
)
from ..storage import layout
from ..storage.columnar import ColumnarBatch
from ..telemetry.metrics import metrics


# --- the shared per-bucket merge procedure -----------------------------------
def merge_bucket_parts(
    parts: List[ColumnarBatch], parts_sorted: bool, indexed: List[str]
) -> ColumnarBatch:
    """Merge one bucket's parts into its key order. Parts that all carry
    the right footer sort claim k-way-merge via the stable searchsorted
    tournament (stream_builder.merge_sorted_runs — the build-finalize
    asymptotics applied to compaction); anything else re-sorts through
    the shared order-preserving encodings."""
    from .stream_builder import merge_sorted_runs, sort_encoding

    if parts_sorted:
        return merge_sorted_runs(parts, list(indexed))
    merged = parts[0] if len(parts) == 1 else ColumnarBatch.concat(parts)
    reprs = [sort_encoding(merged.columns[c]) for c in indexed]
    order = np.lexsort(list(reversed(reprs)))
    return merged.take(order)


def partition_compactable(
    file_infos, threshold: int, quick: bool
) -> Tuple[Dict[int, list], list, set, list]:
    """OptimizeAction.scala:115-133's partition rule, shared by optimize
    and the background compactor: (small files by bucket, run files, the
    buckets holding rows in any run, untouched files). Multi-bucket RUN
    files are always compactable regardless of size or mode; a bucket
    with one small file and no run rows is already compact."""
    by_bucket: Dict[int, list] = {}
    run_files: list = []
    for fi in file_infos:
        if layout.is_run_file(fi.name):
            run_files.append(fi)
        else:
            by_bucket.setdefault(layout.bucket_of_file(fi.name), []).append(fi)
    run_buckets: set = set()
    for fi in run_files:
        offs = layout.run_offsets_checked(fi.name)
        run_buckets.update(
            b for b in range(len(offs) - 1) if offs[b + 1] > offs[b]
        )
    to_optimize: Dict[int, list] = {}
    untouched: list = []
    for b, files in by_bucket.items():
        if quick:
            small = [f for f in files if f.size < threshold]
            big = [f for f in files if f.size >= threshold]
        else:
            small, big = list(files), []
        if len(small) < 2 and b not in run_buckets:
            untouched.extend(files)
            continue
        to_optimize[b] = small
        untouched.extend(big)
    return to_optimize, run_files, run_buckets, untouched


def compact_bucket_group(
    buckets: List[int],
    small_by_bucket: Dict[int, List[str]],
    run_paths: List[str],
    version_dir: Path,
    indexed: List[str],
    workers: int,
) -> Dict[int, Optional[str]]:
    """THE runs→compact write path (one copy, two callers): merge each
    bucket's parts — its small per-bucket files first, then its run
    segments in run order, matching the single-commit optimize — into one
    freshly-written ``b``-file under ``version_dir``. Run segments for
    the whole group are read through the coalesced segment planner (one
    ordered sweep per run file); per-bucket merges fan across the build
    pipeline's merge pool. Returns {bucket: new path or None (bucket
    emptied, e.g. lineage delete)}."""
    plan = layout.plan_segment_reads(run_paths, buckets=set(buckets))
    with metrics.timer("compaction.segment_read"):
        seg_map = layout.execute_segment_reads(plan)
    run_sorted = {
        str(p): layout.cached_reader(p).footer.get("sortedBy") == list(indexed)
        for p in run_paths
    }

    def one(b: int) -> Optional[str]:
        with metrics.timer("compaction.bucket_read"):
            parts: List[ColumnarBatch] = []
            parts_sorted = True
            for f in small_by_bucket.get(b, []):
                parts.append(layout.read_batch(f))
                parts_sorted = parts_sorted and (
                    layout.cached_reader(f).footer.get("sortedBy")
                    == list(indexed)
                )
            for p in run_paths:
                seg = seg_map.get((str(p), b))
                if seg is not None:
                    parts.append(seg)
                    parts_sorted = parts_sorted and run_sorted[str(p)]
        if not parts:  # bucket emptied (e.g. lineage delete)
            return None
        with metrics.timer("compaction.bucket_sort"):
            merged = merge_bucket_parts(parts, parts_sorted, list(indexed))
        with metrics.timer("compaction.bucket_write"):
            out = version_dir / layout.bucket_file_name(b)
            layout.write_batch(out, merged, sorted_by=list(indexed), bucket=b)
        metrics.incr("compaction.buckets")
        return str(out)

    from ..parallel.pool import run_parallel

    ordered = sorted(buckets)
    results = run_parallel(
        [lambda b=b: one(b) for b in ordered],
        max(1, int(workers)),
        name="compact-bucket",
    )
    return dict(zip(ordered, results))


# --- one committed compaction increment -------------------------------------
from ..actions import states  # noqa: E402 (import ordering: after helpers)
from ..actions.base import Action, MaintenanceActionBase  # noqa: E402
from ..actions.create import CreateActionBase, _content_from_file_infos  # noqa: E402
from ..index.log_entry import Content, FileIdTracker, IndexLogEntry, LogEntry  # noqa: E402
from ..telemetry import OptimizeActionEvent  # noqa: E402


class CompactionStep(Action, CreateActionBase, MaintenanceActionBase):
    """One committed increment of runs→per-bucket compaction: compact
    the first ``bucketsPerStep`` compactable buckets (run-held plus
    multi-small-file buckets — optimize(quick)'s rule; by bucket id) into
    per-bucket files and rewrite every
    remaining run minus those buckets — a run whose every bucket is
    consumed disappears. Runs the Action protocol: begin/end with OCC on
    the log, NoChanges when nothing is compactable (converged)."""

    transient_state = states.OPTIMIZING
    final_state = states.ACTIVE

    def __init__(
        self,
        session,
        log_manager,
        data_manager,
        buckets: Optional[List[int]] = None,
    ):
        Action.__init__(self, log_manager)
        CreateActionBase.__init__(self, session)
        self.data_manager = data_manager
        self._previous = None
        self._entry: Optional[IndexLogEntry] = None
        self._buckets = buckets  # explicit override (tests/benches)
        self._parts = None

    def _partition(self):
        if self._parts is None:
            self._parts = partition_compactable(
                self.previous_entry.content.file_infos(),
                self.conf.optimize_file_size_threshold(),
                quick=True,
            )
        return self._parts

    def validate(self) -> None:
        state = self.previous_entry.state
        if state != states.ACTIVE:
            if state not in states.STABLE_STATES:
                # a transient head IS a concurrent writer (live, aborted,
                # or soon-to-be-recovered): surface it as the conflict
                # the step/sweep callers count and retry, not a hard error
                raise ConcurrentModificationException(
                    f"Another writer holds the index (transient head {state})."
                )
            raise HyperspaceException(
                "Compaction is only supported in ACTIVE state; current is "
                f"{state}."
            )
        to_optimize, run_files, _run_buckets, _ = self._partition()
        if not run_files and not to_optimize:
            raise NoChangesException(
                "Nothing to compact; the layout is converged."
            )

    def _chosen_buckets(self, eligible: set) -> List[int]:
        if self._buckets is not None:
            return sorted(set(self._buckets) & eligible)
        # no bucket heat is recorded in this package (the scan gate is not
        # ported): the reference's tie order, by bucket id
        k = self.conf.compaction_buckets_per_step()
        return sorted(eligible)[:k]

    def op(self) -> None:
        prev = self.previous_entry
        to_optimize, run_files, run_buckets, untouched = self._partition()
        indexed = list(prev.indexed_columns)
        # eligible = run-held buckets PLUS multi-small-file buckets with
        # no run rows — optimize(quick) merges both, so convergence must
        # cover both for the converged-layout == optimize(quick) claim
        chosen = self._chosen_buckets(run_buckets | set(to_optimize))
        chosen_set = set(chosen)
        version_dir = self.next_version_dir()
        run_paths = [fi.name for fi in run_files]
        pipe = self.conf.build_pipeline()
        workers = pipe.merge_workers if pipe.enabled else 1
        new_paths: List[str] = []
        with metrics.timer("compaction.step_wall"):
            merged = compact_bucket_group(
                chosen,
                {b: [f.name for f in to_optimize.get(b, [])] for b in chosen},
                run_paths,
                version_dir,
                indexed,
                workers,
            )
            new_paths.extend(p for p in merged.values() if p is not None)
            # remainder rewrite: the compacted buckets' rows leave every
            # run (immutable files — a rewrite is the only subtraction);
            # a fully-consumed run is simply not carried forward. Old
            # version files stay on disk for pinned readers until vacuum.
            # Runs rewrite in parallel across the pool, one run resident
            # per worker at a time — planning ALL runs' remainders into
            # one map would hold nearly the whole index's rows at once.
            def rewrite_remainder(i: int, rf: str) -> Optional[str]:
                offs = layout.run_offsets_checked(rf)
                keep = [
                    b
                    for b in range(len(offs) - 1)
                    if offs[b + 1] > offs[b] and b not in chosen_set
                ]
                if not keep:
                    metrics.incr("compaction.runs_consumed")
                    return None
                plan = layout.plan_segment_reads([rf], set(keep))
                segs = layout.execute_segment_reads(plan, workers=1)
                parts = [
                    segs[(plan[0].path, b)]
                    for b, _lo, _hi in plan[0].segments
                ]
                batch = (
                    parts[0]
                    if len(parts) == 1
                    else ColumnarBatch.concat(parts)
                )
                counts = [0] * (len(offs) - 1)
                for b in keep:
                    counts[b] = int(offs[b + 1] - offs[b])
                extra = {
                    k: v
                    for k, v in layout.cached_reader(rf)
                    .footer.get("extra", {})
                    .items()
                    if k != "bucketCounts"
                }
                out = version_dir / layout.run_file_name(i)
                layout.write_batch(
                    out,
                    batch,
                    sorted_by=indexed,
                    extra={**extra, "bucketCounts": counts},
                )
                metrics.incr("compaction.runs_rewritten")
                return str(out)

            from ..parallel.pool import run_parallel

            with metrics.timer("compaction.remainder_write"):
                rewritten = run_parallel(
                    [
                        lambda i=i, rf=rf: rewrite_remainder(i, rf)
                        for i, rf in enumerate(run_paths)
                    ],
                    max(1, int(workers)),
                    name="compact-remainder",
                )
            new_paths.extend(p for p in rewritten if p is not None)
        metrics.incr("compaction.steps")
        carry = list(untouched) + [
            fi
            for b, fis in to_optimize.items()
            if b not in chosen_set
            for fi in fis
        ]
        tracker = FileIdTracker()
        entry = IndexLogEntry(
            prev.name,
            prev.derived_dataset,
            Content.from_leaf_files(new_paths, tracker),
            prev.source,
            dict(prev.properties),
        )
        if carry:
            entry.content = entry.content.merge(_content_from_file_infos(carry))
        self._entry = entry

    def log_entry(self) -> LogEntry:
        return self._entry if self._entry is not None else self.previous_entry

    def event(self, message: str):
        return OptimizeActionEvent(
            index=self.previous_entry.name,
            state=self.final_state,
            message=f"[compaction] {message}",
        )


# --- the background worker ---------------------------------------------------
class IndexCompactor:
    """Drives CompactionSteps across a session's indexes. Stateless
    between calls — every decision re-reads the log, so any number of
    hosts may run compactors against the same store and the log's OCC
    protocol arbitrates (losers count ``compaction.step_conflict`` and
    retry on their next sweep)."""

    def __init__(self, session):
        self.session = session

    def _manager(self):
        return self.session.collection_manager

    def _eligible(self, entry) -> bool:
        """Metadata-only mirror of what a CompactionStep would find work
        in: any run file, or any bucket holding >= 2 quick-compactable
        small files (partition_compactable's rule — optimize(quick)
        merges those too, and convergence claims its layout). No IO:
        names and logged sizes only."""
        threshold = self.session.conf.optimize_file_size_threshold()
        small_count: Dict[str, int] = {}
        for fi in entry.content.file_infos():
            if layout.is_run_file(fi.name):
                return True
            if fi.size < threshold:
                b = layout.bucket_of_file(fi.name)
                small_count[b] = small_count.get(b, 0) + 1
                if small_count[b] >= 2:
                    return True
        return False

    def step(self, name: str, buckets: Optional[List[int]] = None) -> str:
        """Commit at most one CompactionStep for ``name``. Returns
        "committed", "converged" (nothing left to compact), "conflict"
        (another writer holds the index), or "ineligible"."""
        mgr = self._manager()
        log_mgr = mgr._existing_log_manager(name)
        entry = log_mgr.get_latest_stable_log()
        if entry is None or entry.state != states.ACTIVE:
            return "ineligible"
        if entry.derived_dataset.kind != "CoveringIndex":
            # sketch indexes have no bucket layout to compact (the same
            # guard optimize() applies before its action)
            return "ineligible"
        if not self._eligible(entry):
            return "converged"
        action = CompactionStep(
            self.session, log_mgr, mgr._data_manager(name), buckets=buckets
        )
        try:
            action.run()
        except ConcurrentModificationException:
            metrics.incr("compaction.step_conflict")
            return "conflict"
        if action._entry is None:
            # validate() raised NoChanges inside run() (a concurrent
            # convergence won the race): nothing committed, say so —
            # "committed" here would loop compact_index forever
            return "converged"
        # the commit changed what this index serves: drop the TTL catalog
        # view, as the optimize verb does (resident tables are keyed by file
        # identity, so none serves the new version's files)
        clear = getattr(mgr, "clear_cache", None)
        if clear is not None:
            clear()
        return "committed"

    def compact_index(self, name: str, max_steps: Optional[int] = None) -> dict:
        """Step ``name`` toward convergence (bounded by ``max_steps``).
        Returns {"steps": committed count, "converged": bool}."""
        steps = 0
        outcome = "converged"
        while max_steps is None or steps < max_steps:
            outcome = self.step(name)
            if outcome != "committed":
                break
            steps += 1
        if outcome == "committed":
            # step budget exhausted mid-convergence: report truthfully
            outcome = (
                "converged"
                if not self._eligible(
                    self._manager()
                    ._existing_log_manager(name)
                    .get_latest_stable_log()
                )
                else "stepping"
            )
        return {"steps": steps, "converged": outcome == "converged"}

    def sweep(self, max_steps_per_index: Optional[int] = None) -> dict:
        """One background pass: every ACTIVE covering index with
        compactable work left advances by at most ``maxStepsPerSweep``
        steps. Returns {index: compact_index result}."""
        if max_steps_per_index is None:
            max_steps_per_index = (
                self.session.conf.compaction_max_steps_per_sweep()
            )
        out: dict = {}
        for entry in self._manager().get_indexes(
            [states.ACTIVE], prefer_stable=True
        ):
            if entry.derived_dataset.kind != "CoveringIndex":
                continue
            if not self._eligible(entry):
                continue
            out[entry.name] = self.compact_index(
                entry.name, max_steps=max_steps_per_index
            )
        metrics.incr("compaction.sweeps")
        return out
