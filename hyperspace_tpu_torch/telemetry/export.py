"""Metrics exporters: the whole registry as Prometheus text format and
JSON-lines, plus an opt-in rotating on-disk writer.

Counterpart of ``hyperspace_tpu.telemetry.export``. Dotted metric names
become ``hyperspace_``-prefixed underscore names (``serve.shed`` ->
``hyperspace_serve_shed_total``). Types map as:

* counters  -> ``<name>_total``            TYPE counter
* gauges    -> ``<name>``                  TYPE gauge
* timers    -> ``<name>_seconds_total`` + ``<name>_calls_total``
* histograms-> ``<name>_bucket{le=...}`` / ``_sum`` / ``_count``

``check_prometheus`` validates a rendering the way a scraper would (name
grammar, one HELP/TYPE per family, label escaping, monotone cumulative
buckets, +Inf == count).

Surfaces: ``QueryServer.stats()["export"]`` and, when
``hyperspace.telemetry.export.dir`` is set ("auto" resolves next to the
operation log under the system path), ``export_to_dir``'s size-rotated
JSON-lines snapshots.
"""

from __future__ import annotations

import json
import re
import threading
from pathlib import Path
from typing import Dict, List, Optional

from .metrics import Metrics, metrics

# one writer at a time through the rotate-and-append sequence: stats()
# is called concurrently under multi-tenant serving, and two racing
# rotations would interleave the .i -> .i+1 renames (history silently
# overwritten) or rename the live file out from under the other's append
_EXPORT_LOCK = threading.Lock()

_PREFIX = "hyperspace"
_NAME_OK = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_SAMPLE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>[^}]*)\})?"
    r"\s+(?P<value>[^ ]+)$"
)
_LABEL = re.compile(r'^[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\\n]|\\[\\"n])*"$')


def _sanitize(name: str) -> str:
    return f"{_PREFIX}_" + re.sub(r"[^a-zA-Z0-9_]", "_", name)


def escape_label_value(value: str) -> str:
    return (
        str(value)
        .replace("\\", r"\\")
        .replace("\n", r"\n")
        .replace('"', r'\"')
    )


def _fmt(v: float) -> str:
    f = float(v)
    return str(int(f)) if f == int(f) else repr(f)


def render_prometheus(registry: Optional[Metrics] = None) -> str:
    """The whole registry in Prometheus text exposition format. Distinct
    dotted names that sanitize to the same underscore name would emit a
    duplicate family — the second is dropped and counted
    (``telemetry.export.name_collisions``) so --check stays green and
    the collision is visible rather than silently corrupting a scrape."""
    snap = (registry if registry is not None else metrics).report()
    gauges: Dict[str, int] = snap.get("gauges", {})
    lines: List[str] = []
    seen: set = set()
    collisions = 0

    def emit(base: str, mtype: str, help_name: str, samples) -> bool:
        nonlocal collisions
        if base in seen:
            collisions += 1
            return False
        seen.add(base)
        lines.append(f"# HELP {base} {help_name}")
        lines.append(f"# TYPE {base} {mtype}")
        lines.extend(samples)
        return True

    for name in sorted(snap["counters"]):
        if name in gauges:
            continue
        base = _sanitize(name) + "_total"
        emit(base, "counter", name, [f"{base} {_fmt(snap['counters'][name])}"])
    for name in sorted(gauges):
        base = _sanitize(name)
        emit(base, "gauge", name, [f"{base} {_fmt(gauges[name])}"])
    for name in sorted(snap["timers_s"]):
        base = _sanitize(name) + "_seconds_total"
        emit(base, "counter", name, [f"{base} {_fmt(snap['timers_s'][name])}"])
        cbase = _sanitize(name) + "_calls_total"
        emit(
            cbase,
            "counter",
            name,
            [f"{cbase} {_fmt(snap['timer_counts'].get(name, 0))}"],
        )
    for name in sorted(snap.get("histograms", {})):
        h = snap["histograms"][name]
        base = _sanitize(name)
        samples = []
        cum = 0
        for bound, c in zip(h["buckets"], h["counts"]):
            cum += c
            samples.append(
                f'{base}_bucket{{le="{_fmt(bound)}"}} {cum}'
            )
        samples.append(f'{base}_bucket{{le="+Inf"}} {h["count"]}')
        samples.append(f"{base}_sum {_fmt(h['sum'])}")
        samples.append(f"{base}_count {h['count']}")
        emit(base, "histogram", name, samples)
    if collisions:
        metrics.incr("telemetry.export.name_collisions", collisions)
    return "\n".join(lines) + ("\n" if lines else "")


def render_jsonl(registry: Optional[Metrics] = None) -> str:
    """One JSON object per metric, one per line — the grep/jq-friendly
    twin of the Prometheus rendering and the on-disk rotation format."""
    snap = (registry if registry is not None else metrics).report()
    gauges = snap.get("gauges", {})
    out: List[str] = []
    for name in sorted(snap["counters"]):
        kind = "gauge" if name in gauges else "counter"
        out.append(
            json.dumps(
                {"name": name, "type": kind, "value": snap["counters"][name]},
                sort_keys=True,
            )
        )
    for name in sorted(snap["timers_s"]):
        out.append(
            json.dumps(
                {
                    "name": name,
                    "type": "timer",
                    "seconds": snap["timers_s"][name],
                    "calls": snap["timer_counts"].get(name, 0),
                },
                sort_keys=True,
            )
        )
    for name in sorted(snap.get("histograms", {})):
        h = snap["histograms"][name]
        out.append(
            json.dumps({"name": name, "type": "histogram", **h}, sort_keys=True)
        )
    return "\n".join(out) + ("\n" if out else "")


def check_prometheus(text: str) -> List[str]:
    """Problems in a Prometheus text rendering, [] when clean: name
    grammar, at most one HELP/TYPE per family, parseable samples, legal
    label escaping, monotone cumulative buckets with +Inf == _count."""
    problems: List[str] = []
    helps: set = set()
    types: set = set()
    buckets: Dict[str, List[float]] = {}
    bucket_counts: Dict[str, List[int]] = {}
    hist_count: Dict[str, int] = {}
    for i, line in enumerate(text.splitlines(), start=1):
        if not line.strip():
            continue
        if line.startswith("# HELP ") or line.startswith("# TYPE "):
            parts = line.split(None, 3)
            if len(parts) < 3:
                problems.append(f"line {i}: malformed comment: {line!r}")
                continue
            kind, name = parts[1], parts[2]
            book = helps if kind == "HELP" else types
            if name in book:
                problems.append(f"line {i}: duplicate {kind} for {name}")
            book.add(name)
            if not _NAME_OK.match(name):
                problems.append(f"line {i}: bad metric name {name!r}")
            continue
        if line.startswith("#"):
            continue
        m = _SAMPLE.match(line)
        if m is None:
            problems.append(f"line {i}: unparseable sample: {line!r}")
            continue
        name = m.group("name")
        if not _NAME_OK.match(name):
            problems.append(f"line {i}: bad metric name {name!r}")
        labels = m.group("labels")
        le = None
        if labels:
            for pair in labels.split(","):
                if not _LABEL.match(pair.strip()):
                    problems.append(
                        f"line {i}: bad label (escaping?): {pair!r}"
                    )
                elif pair.strip().startswith("le="):
                    le = pair.strip()[4:-1]
        try:
            value = float(m.group("value"))
        except ValueError:
            problems.append(f"line {i}: bad value {m.group('value')!r}")
            continue
        if name.endswith("_bucket") and le is not None:
            base = name[: -len("_bucket")]
            bound = float("inf") if le == "+Inf" else float(le)
            buckets.setdefault(base, []).append(bound)
            bucket_counts.setdefault(base, []).append(int(value))
        elif name.endswith("_count"):
            hist_count[name[: -len("_count")]] = int(value)
    for base, bounds in buckets.items():
        counts = bucket_counts[base]
        if sorted(bounds) != bounds:
            problems.append(f"{base}: bucket bounds not sorted")
        if sorted(counts) != counts:
            problems.append(f"{base}: cumulative bucket counts not monotone")
        if bounds and bounds[-1] != float("inf"):
            problems.append(f"{base}: missing +Inf bucket")
        if base in hist_count and counts and counts[-1] != hist_count[base]:
            problems.append(f"{base}: +Inf bucket != _count")
    return problems


# ---------------------------------------------------------------------------
# opt-in on-disk rotation (next to the operation log)
# ---------------------------------------------------------------------------
def export_to_dir(
    directory: str,
    rotate_bytes: int = 4 * 1024 * 1024,
    keep: int = 4,
    registry: Optional[Metrics] = None,
) -> Path:
    """Append one JSON-lines snapshot block to ``<dir>/metrics.jsonl``,
    rotating (``.1`` .. ``.keep``) when the live file exceeds
    ``rotate_bytes``. Returns the live file path. Callers treat failures
    as non-fatal (stats() counts them; telemetry must never take down
    serving)."""
    d = Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    live = d / "metrics.jsonl"
    block = render_jsonl(registry)
    with _EXPORT_LOCK:
        if live.exists() and live.stat().st_size >= max(int(rotate_bytes), 1):
            keep = max(int(keep), 1)
            oldest = d / f"metrics.jsonl.{keep}"
            if oldest.exists():
                oldest.unlink()
            for i in range(keep - 1, 0, -1):
                src = d / f"metrics.jsonl.{i}"
                if src.exists():
                    src.rename(d / f"metrics.jsonl.{i + 1}")
            live.rename(d / "metrics.jsonl.1")
        with live.open("a", encoding="utf-8") as f:
            f.write(block)
    return live
