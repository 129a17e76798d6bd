"""doctor(): fsck for index directories — verify the operation log and
its physical artifacts agree, report what does not, optionally repair.

Checks, per index directory:

* **log chain** — entry ids dense ``0..latest`` (the OCC protocol never
  skips an id), every entry parseable, states legal;
* **latestStable** — parseable, a genuinely stable state, id within the
  chain, byte-agreeing with the chain entry it claims to copy; a bad or
  missing copy is repairable (rebuild from the backward scan);
* **head state** — a transient head with an abandoned lease is a dead
  writer (repairable: auto-rollback via recovery); with a live lease
  it is an in-flight writer (informational, not an inconsistency);
  with an aborted lease or none it is manual-cancel territory
  (reported, repaired only under ``repair`` — doctor IS the operator);
* **data presence** — every file the latest stable entry references must
  exist with the logged size;
* **orphans** — artifacts no log entry references: whole version dirs
  and data files from builds whose entry was never written (torn build),
  ``.spill`` scratch trees in versions the stable entry does not own,
  ``.*.tmp.*`` leftovers from crashed ``atomic_create`` calls, and
  superseded lease-epoch tombstones. All repairable (vacuumed).

``repair=True`` fixes everything repairable and marks each issue with
what happened; a follow-up scan of a repaired tree reports zero issues —
the invariant the crash sweep pins.

Command line (exit 0 when no unrepaired inconsistency remains, 1
otherwise, 2 on a usage error)::

    python -m hyperspace_tpu_torch.reliability.doctor PATH [--json] [--repair]
"""

from __future__ import annotations

import shutil
from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional

from .. import constants as C
from ..exceptions import HyperspaceException
from ..telemetry.metrics import metrics
from .lease import EPOCH_PREFIX, LEASE_DIR, LeaseManager
from .recovery import maybe_auto_recover

# issue kinds
LOG_GAP = "log-gap"
LOG_CORRUPT = "log-corrupt"
LATEST_STABLE_BAD = "latest-stable-bad"
ABANDONED_WRITER = "abandoned-writer"
STUCK_TRANSIENT = "stuck-transient"
WRITER_IN_FLIGHT = "writer-in-flight"  # informational
# the background compactor's increments surface under their own kinds so
# an operator can tell "a compaction step is running / died" from "a
# human's optimize/refresh is running / died" — the repair mechanics are
# identical (auto-rollback via recovery; the torn version dir's litter
# vacuums through the orphan scan below)
COMPACTION_IN_FLIGHT = "compaction-in-flight"  # informational
COMPACTION_ABANDONED = "compaction-abandoned"
MISSING_DATA_FILE = "missing-data-file"
ORPHAN_VERSION_DIR = "orphan-version-dir"
ORPHAN_DATA_FILE = "orphan-data-file"
ORPHAN_SPILL = "orphan-spill"
ORPHAN_TEMP = "orphan-temp"
STALE_LEASE = "stale-lease"

# informational: expected litter of a healthy lifecycle, not damage —
# a live writer mid-action, and superseded lease-epoch tombstones (kept
# for epoch monotonicity; repair garbage-collects them, a scan must not
# fail a healthy tree over them)
_INFORMATIONAL = frozenset({WRITER_IN_FLIGHT, COMPACTION_IN_FLIGHT, STALE_LEASE})


@dataclass
class Issue:
    index: str
    kind: str
    path: str
    detail: str
    repairable: bool
    repaired: bool = False

    @property
    def informational(self) -> bool:
        return self.kind in _INFORMATIONAL

    def to_json_dict(self) -> dict:
        return {
            "index": self.index,
            "kind": self.kind,
            "path": self.path,
            "detail": self.detail,
            "repairable": self.repairable,
            "repaired": self.repaired,
            "informational": self.informational,
        }


@dataclass
class DoctorReport:
    root: str
    indexes_checked: int = 0
    issues: List[Issue] = field(default_factory=list)
    repaired: bool = False
    # flight-recorder dump (recent query traces + failure snapshots),
    # attached on request — doctor(include_traces=True) is the
    # post-mortem entry point (telemetry/recorder.py)
    traces: Optional[dict] = None

    @property
    def inconsistencies(self) -> List[Issue]:
        """Issues that are real inconsistencies (not informational) and
        not already repaired."""
        return [
            i for i in self.issues if not i.informational and not i.repaired
        ]

    @property
    def ok(self) -> bool:
        return not self.inconsistencies

    def to_json_dict(self) -> dict:
        out = {
            "root": self.root,
            "indexesChecked": self.indexes_checked,
            "repairMode": self.repaired,
            "ok": self.ok,
            "issueCount": len([i for i in self.issues if not i.informational]),
            "issues": [i.to_json_dict() for i in self.issues],
        }
        if self.traces is not None:
            out["traces"] = self.traces
        return out


def _is_index_dir(d: Path) -> bool:
    return (d / C.HYPERSPACE_LOG).is_dir()


def doctor(
    path,
    repair: bool = False,
    conf=None,
    include_traces: bool = False,
) -> DoctorReport:
    """fsck ``path``: either one index directory or a system path holding
    many. Pure scan by default; ``repair=True`` rolls back abandoned
    writers, rebuilds latestStable, and vacuums orphans.
    ``include_traces=True`` attaches the flight recorder's dump for
    post-mortems (telemetry/recorder.py)."""
    root = Path(path)
    report = DoctorReport(root=str(root), repaired=repair)
    if include_traces:
        from ..telemetry.recorder import flight_recorder

        report.traces = flight_recorder.dump()
    if not root.is_dir():
        return report
    if _is_index_dir(root):
        targets = [root]
    else:
        targets = [d for d in sorted(root.iterdir()) if d.is_dir()]
    for d in targets:
        if not _is_index_dir(d):
            continue
        report.indexes_checked += 1
        _check_index(d, report, repair=repair, conf=conf)
    metrics.incr("doctor.scans")
    n_issues = len([i for i in report.issues if not i.informational])
    if n_issues:
        metrics.incr("doctor.issues_found", n_issues)
    n_repaired = len([i for i in report.issues if i.repaired])
    if n_repaired:
        metrics.incr("doctor.issues_repaired", n_repaired)
    return report


def _check_index(index_dir: Path, report: DoctorReport, repair: bool, conf) -> None:
    from ..actions import states
    from ..index.data_manager import IndexDataManagerImpl
    from ..index.log_manager import LATEST_STABLE, IndexLogManagerImpl

    name = index_dir.name
    mgr = IndexLogManagerImpl(index_dir)
    log_dir = index_dir / C.HYPERSPACE_LOG

    def add(kind, path, detail, repairable, repaired=False):
        report.issues.append(
            Issue(name, kind, str(path), detail, repairable, repaired)
        )

    # -- log chain -----------------------------------------------------------
    ids = sorted(
        int(p.name) for p in log_dir.iterdir() if p.name.isdigit()
    )
    entries = {}
    for i in ids:
        try:
            entries[i] = mgr.get_log(i)
        except HyperspaceException as e:
            add(LOG_CORRUPT, log_dir / str(i), str(e), repairable=False)
    if ids and ids != list(range(ids[-1] + 1)):
        missing = sorted(set(range(ids[-1] + 1)) - set(ids))
        add(
            LOG_GAP,
            log_dir,
            f"log ids are not dense: missing {missing}",
            repairable=False,
        )

    # -- latestStable ---------------------------------------------------------
    stable_path = log_dir / LATEST_STABLE
    stable_entry = None
    stable_problem = None
    if stable_path.exists():
        try:
            stable_entry = mgr._read(stable_path)
            if stable_entry is not None and stable_entry.state not in states.STABLE_STATES:
                stable_problem = (
                    f"latestStable carries non-stable state {stable_entry.state}"
                )
        except HyperspaceException as e:
            stable_problem = str(e)
    if stable_problem is None and stable_entry is not None:
        chain = entries.get(stable_entry.id)
        if chain is None or chain.state != stable_entry.state:
            stable_problem = (
                f"latestStable (id {stable_entry.id}, {stable_entry.state}) "
                "disagrees with the log chain"
            )
    if stable_problem is not None:
        repaired = False
        if repair:
            # rebuild from the backward scan: delete the bad copy, then
            # recreate from the newest stable chain entry (if any)
            stable_path.unlink(missing_ok=True)
            for i in range(ids[-1] if ids else -1, -1, -1):
                e = entries.get(i)
                if e is not None and e.state in states.STABLE_STATES:
                    mgr.create_latest_stable_log(i)
                    break
            repaired = True
        add(LATEST_STABLE_BAD, stable_path, stable_problem, True, repaired)

    # -- head state + lease ----------------------------------------------------
    lease_mgr = LeaseManager(index_dir, mgr._fs)
    current_lease = lease_mgr.current()
    head = entries.get(ids[-1]) if ids else None
    # an in-flight writer (transient head under a LIVE lease) is a
    # supported state: its new version dir is not yet referenced by any
    # entry (the end entry carries the content), so the orphan scan
    # below must stand down entirely or it would report — and under
    # repair, DELETE — the live build's data
    writer_live = (
        head is not None
        and head.state not in states.STABLE_STATES
        and current_lease is not None
        and current_lease.is_live()
    )
    is_compaction = (
        current_lease is not None and current_lease.action == "CompactionStep"
    )
    if head is not None and head.state not in states.STABLE_STATES:
        if current_lease is not None and current_lease.is_live():
            add(
                COMPACTION_IN_FLIGHT if is_compaction else WRITER_IN_FLIGHT,
                log_dir / str(head.id),
                ("background compaction step" if is_compaction else
                 f"transient head {head.state}")
                + f" under live lease epoch "
                f"{current_lease.epoch} (owner {current_lease.owner})",
                repairable=False,
            )
        elif current_lease is not None and current_lease.is_abandoned():
            repaired = False
            if repair:
                repaired = maybe_auto_recover(
                    mgr,
                    data_manager=IndexDataManagerImpl(index_dir),
                    conf=conf,
                )
            add(
                COMPACTION_ABANDONED if is_compaction else ABANDONED_WRITER,
                log_dir / str(head.id),
                ("background compaction step died mid-flight" if is_compaction
                 else f"transient head {head.state}")
                + f"; lease epoch "
                f"{current_lease.epoch} expired unreleased (dead writer)",
                True,
                repaired,
            )
        else:
            repaired = False
            if repair:
                # doctor --repair IS the operator: roll back the stuck
                # transient the way a manual cancel() would
                from ..actions.metadata_actions import CancelAction

                try:
                    CancelAction(
                        mgr, conf, data_manager=IndexDataManagerImpl(index_dir)
                    ).run()
                    repaired = True
                except HyperspaceException:
                    repaired = False
            add(
                STUCK_TRANSIENT,
                log_dir / str(head.id),
                f"transient head {head.state} with "
                + (
                    "an aborted lease (writer failed in-process)"
                    if current_lease is not None
                    else "no lease record (legacy writer)"
                ),
                True,
                repaired,
            )

    # -- referenced sets -------------------------------------------------------
    # re-read entries after any repair above (rollback appends entries)
    if repair:
        ids = sorted(int(p.name) for p in log_dir.iterdir() if p.name.isdigit())
        entries = {}
        for i in ids:
            try:
                entries[i] = mgr.get_log(i)
            except HyperspaceException:
                continue
    referenced_files = set()
    for e in entries.values():
        if e is None or not hasattr(e, "content") or e.content is None:
            continue
        for f in e.content.files():
            referenced_files.add(str(Path(f)))
    try:
        latest_stable = mgr.get_latest_stable_log()
    except HyperspaceException:
        latest_stable = None
    stable_versions = set()
    stable_files = set()
    prefix = C.INDEX_VERSION_DIRECTORY_PREFIX + "="
    if latest_stable is not None and hasattr(latest_stable, "content"):
        for f in latest_stable.content.files():
            stable_files.add(str(Path(f)))
            for part in str(f).split("/"):
                if part.startswith(prefix):
                    stable_versions.add(int(part[len(prefix):]))

    # -- data presence ---------------------------------------------------------
    if latest_stable is not None and latest_stable.state == states.ACTIVE:
        for f in sorted(stable_files):
            if not Path(f).exists():
                add(
                    MISSING_DATA_FILE,
                    f,
                    "file referenced by the latest stable entry is missing",
                    repairable=False,
                )

    # -- orphans ---------------------------------------------------------------
    for vdir in sorted(index_dir.glob(prefix + "*")) if not writer_live else []:
        if not vdir.is_dir():
            continue
        try:
            vid = int(vdir.name[len(prefix):])
        except ValueError:
            continue
        files_here = [
            p for p in vdir.rglob("*")
            if p.is_file()
            and not any(part.startswith(".") for part in p.relative_to(vdir).parts)
        ]
        referenced_here = [
            p for p in files_here if str(p) in referenced_files
        ]
        if files_here and not referenced_here:
            # a torn build: data written, entry never committed
            repaired = False
            if repair:
                shutil.rmtree(vdir, ignore_errors=True)
                repaired = True
            add(
                ORPHAN_VERSION_DIR,
                vdir,
                f"version dir v__={vid} is referenced by no log entry "
                f"({len(files_here)} file(s) from a failed build)",
                True,
                repaired,
            )
            continue
        for p in files_here:
            if str(p) not in referenced_files:
                repaired = False
                if repair:
                    p.unlink(missing_ok=True)
                    repaired = True
                add(
                    ORPHAN_DATA_FILE,
                    p,
                    "data file referenced by no log entry",
                    True,
                    repaired,
                )
        spill = vdir / ".spill"
        if spill.is_dir() and vid not in stable_versions:
            repaired = False
            if repair:
                shutil.rmtree(spill, ignore_errors=True)
                repaired = True
            add(
                ORPHAN_SPILL,
                spill,
                "spill scratch from an interrupted streaming build",
                True,
                repaired,
            )

    # atomic_create temp leftovers anywhere under the index dir (skipped
    # while a live writer is in flight — its own claim temp may be that
    # file for a few microseconds)
    for p in sorted(index_dir.rglob(".*.tmp.*")) if not writer_live else []:
        if not p.is_file():
            continue
        repaired = False
        if repair:
            p.unlink(missing_ok=True)
            repaired = True
        add(
            ORPHAN_TEMP,
            p,
            "temp file from a crashed atomic_create (temp-then-link)",
            True,
            repaired,
        )

    # superseded lease epochs (tombstones kept for monotonicity; all but
    # the newest are garbage)
    lease_dir = index_dir / LEASE_DIR
    if lease_dir.is_dir():
        epochs = lease_mgr.epochs()
        for old in epochs[:-1]:
            repaired = False
            if repair:
                (lease_dir / f"{EPOCH_PREFIX}{old}").unlink(missing_ok=True)
                repaired = True
            add(
                STALE_LEASE,
                lease_dir / f"{EPOCH_PREFIX}{old}",
                f"superseded lease epoch {old}",
                True,
                repaired,
            )


def main(argv=None) -> int:
    import argparse
    import json

    ap = argparse.ArgumentParser(
        prog="python -m hyperspace_tpu_torch.reliability.doctor",
        description="fsck for hyperspace index directories "
        "(log-chain integrity, data presence, crash litter)",
    )
    ap.add_argument(
        "path", help="an index system path (holding index dirs) or one index dir"
    )
    ap.add_argument(
        "--repair",
        action="store_true",
        help="roll back abandoned writers, rebuild latestStable, vacuum orphans",
    )
    ap.add_argument("--json", action="store_true", help="emit the report as JSON")
    args = ap.parse_args(argv)

    report = doctor(args.path, repair=args.repair)
    if args.json:
        print(json.dumps(report.to_json_dict(), indent=2, sort_keys=True))
    else:
        print(f"doctor: {report.indexes_checked} index(es) under {report.root}")
        for issue in report.issues:
            tag = (
                "info"
                if issue.informational
                else ("repaired" if issue.repaired else "ISSUE")
            )
            print(
                f"  [{tag}] {issue.index}: {issue.kind} at {issue.path} — "
                f"{issue.detail}"
            )
        bad = report.inconsistencies
        print(
            f"doctor: {len(bad)} unrepaired inconsistencie(s)"
            + ("" if bad else " — clean")
        )
    return 0 if report.ok else 1


if __name__ == "__main__":
    import sys

    sys.exit(main())
