"""Logical-plan signature providers — the index/source fingerprint system.

Parity:
  LogicalPlanSignatureProvider factory — LogicalPlanSignatureProvider.scala:27-62
  FileBasedSignatureProvider  — FileBasedSignatureProvider.scala:39-60
  PlanSignatureProvider       — PlanSignatureProvider.scala:36-43
  IndexSignatureProvider      — IndexSignatureProvider.scala:41-49 (default)

A signature captures "the exact source data + plan shape this index was
built from"; at query time a rule matches candidate indexes by recomputing
the signature over the current plan (RuleUtils.scala:61-76).
"""

from __future__ import annotations

import importlib
from typing import Optional

from ..exceptions import HyperspaceException
from ..plan.ir import LogicalPlan, Scan
from ..utils.hashing import md5_hex
from ..utils.memo import bounded_memo_put

# Per-scan fold memo: the md5 chain over one relation's file snapshot is a
# pure function of (incoming accumulator, per-file stats) and query rules
# recompute it on every fresh plan (with_cached_tag caches per plan, and
# plans are rebuilt per query). The ALGORITHM is unchanged — signatures are
# persisted in index log entries, so only the recomputation is skipped.
_FOLD_MEMO: dict = {}
_FOLD_MEMO_MAX = 256


class LogicalPlanSignatureProvider:
    @property
    def name(self) -> str:
        return type(self).__name__

    def signature(self, plan: LogicalPlan) -> Optional[str]:
        """None if the plan shape is unsupported (e.g. no file-based scan)."""
        raise NotImplementedError


class FileBasedSignatureProvider(LogicalPlanSignatureProvider):
    """md5-fold of every scanned relation's file snapshot: per file
    (path, size, mtime) — DefaultFileBasedSource.scala:188-210 folded
    across relations as FileBasedSignatureProvider.scala:39-60."""

    def signature(self, plan: LogicalPlan) -> Optional[str]:
        scans = plan.collect(lambda n: isinstance(n, Scan))
        if not scans:
            return None
        acc = ""
        for scan in scans:
            # sort once: the fold is name-ordered, and a name-ordered key
            # makes the memo insensitive to discovery order
            files = sorted(scan.relation.files, key=lambda f: f.name)
            key = (
                acc,
                tuple((f.name, f.size, f.modified_time) for f in files),
            )
            hit = _FOLD_MEMO.get(key)
            if hit is None:
                for f in files:
                    acc = md5_hex(acc + f"{f.name}:{f.size}:{f.modified_time}")
                bounded_memo_put(_FOLD_MEMO, key, acc, _FOLD_MEMO_MAX)
            else:
                acc = hit
        return acc


class PlanSignatureProvider(LogicalPlanSignatureProvider):
    """md5-fold of operator node names bottom-up
    (PlanSignatureProvider.scala:36-43)."""

    def signature(self, plan: LogicalPlan) -> Optional[str]:
        acc = ""

        def walk(node: LogicalPlan) -> None:
            nonlocal acc
            for c in node.children:
                walk(c)
            acc = md5_hex(acc + node.node_name)

        walk(plan)
        return acc


class IndexSignatureProvider(LogicalPlanSignatureProvider):
    """md5(fileSignature + planSignature) — the default provider stored in
    every index (IndexSignatureProvider.scala:41-49)."""

    def __init__(self) -> None:
        self._files = FileBasedSignatureProvider()
        self._plan = PlanSignatureProvider()

    def signature(self, plan: LogicalPlan) -> Optional[str]:
        fs = self._files.signature(plan)
        if fs is None:
            return None
        return md5_hex(fs + self._plan.signature(plan))


_BUILTIN = {
    "IndexSignatureProvider": IndexSignatureProvider,
    "FileBasedSignatureProvider": FileBasedSignatureProvider,
    "PlanSignatureProvider": PlanSignatureProvider,
}


def create_signature_provider(name: Optional[str] = None) -> LogicalPlanSignatureProvider:
    """Reflective factory (LogicalPlanSignatureProvider.scala:55-62);
    default is IndexSignatureProvider (:47)."""
    if not name:
        return IndexSignatureProvider()
    if name in _BUILTIN:
        return _BUILTIN[name]()
    if ":" in name:
        mod_name, _, attr = name.partition(":")
    elif "." in name:
        mod_name, _, attr = name.rpartition(".")
    else:
        raise HyperspaceException(f"Unknown signature provider: {name}")
    mod = importlib.import_module(mod_name)
    return getattr(mod, attr)()
