"""HS014 — metric/span name discipline.

Metric names are an external API: the Prometheus exporter
(telemetry/export.py) renders every registry name into a scrape, the
span taxonomy is part of the trace surface, and dashboards key on
prefixes.
The failure mode this rule closes is the off-grammar name that ships
silently — ``Serve.Shed``, ``scan-path-host``, or a name minted under
no subsystem — which then either breaks the exporter's naming contract
or lands as an orphan family no dashboard ever finds.

Every STRING LITERAL passed as the first argument to a metric
recording/reading call (``incr``/``gauge``/``record_time``/``timer``/
``observe``/``counter``/``time_of``) or a span opener (``span``/
``start_trace``/``add_span``) must:

  * match the dotted-lowercase grammar
    ``segment(.segment)+`` with segments ``[a-z][a-z0-9_]*`` (first
    segment) / ``[a-z0-9_]+`` (rest) — the shape ``_sanitize`` in
    telemetry/export.py maps 1:1 onto Prometheus names;
  * be **unique-prefixed per subsystem**: the first segment must be one
    of the declared SUBSYSTEM_PREFIXES below — minting a new subsystem
    is an explicit registration act here, exactly like declaring a conf
    key in constants.py.

Blind spots (documented): names BUILT at runtime
(f-strings, ``prefix + name`` concatenation) are invisible — every such
family in the tree composes from a literal-prefixed constant that this
rule has already seen, keep it that way.
"""

from __future__ import annotations

import ast
import re
from typing import Iterator, Tuple

from ..core import Rule, terminal_name

_NAME_RE = re.compile(r"^[a-z][a-z0-9_]*(\.[a-z0-9_]+)+$")

# the declared subsystem namespaces — adding one here IS the
# registration act. The reference analyzer's 25, plus the port's own:
#   device — the port's device probe (utils/deviceprobe.py) counts its
#            verdict once for every tier that asks (``device.unreachable``),
#            where the reference counts it per caller (hbm., build.engine.)
SUBSYSTEM_PREFIXES = frozenset(
    {
        "aggregate",
        "build",
        "compaction",
        "compile",
        "device",
        "dist",
        "doctor",
        "hbm",
        "io",
        "join",
        "lease",
        "mesh",
        "optimize",
        "plan",
        "query",
        "recovery",
        "residency",
        "result_cache",
        "router",
        "scan",
        "serve",
        "shuffle",
        "storage",
        "telemetry",
        "trace",
        "union",
    }
)

_METRIC_METHODS = frozenset(
    {"incr", "gauge", "record_time", "timer", "observe", "counter", "time_of"}
)
_SPAN_FUNCS = frozenset({"span", "start_trace", "add_span"})


class MetricNameRule(Rule):
    code = "HS014"
    name = "metric-name-discipline"
    description = (
        "metric/span name literals must match the dotted-lowercase "
        "grammar and carry a declared subsystem prefix — off-grammar "
        "names break the Prometheus exporter's contract, unprefixed "
        "ones land as orphan families"
    )

    def check(self, ctx) -> Iterator[Tuple[int, int, str]]:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call) or not node.args:
                continue
            fn = node.func
            name = terminal_name(fn)
            if name is None:
                continue
            if isinstance(fn, ast.Attribute):
                if name not in _METRIC_METHODS and name not in _SPAN_FUNCS:
                    continue
            else:  # bare Name call: only the span openers qualify
                if name not in _SPAN_FUNCS:
                    continue
            arg = node.args[0]
            if not isinstance(arg, ast.Constant) or not isinstance(
                arg.value, str
            ):
                continue
            value = arg.value
            if not _NAME_RE.match(value):
                yield (
                    arg.lineno,
                    arg.col_offset,
                    f"metric/span name {value!r} does not match the "
                    "dotted-lowercase grammar "
                    "(segment(.segment)+, [a-z0-9_] segments) — the "
                    "exporter and dashboards key on it",
                )
                continue
            prefix = value.split(".", 1)[0]
            if prefix not in SUBSYSTEM_PREFIXES:
                yield (
                    arg.lineno,
                    arg.col_offset,
                    f"metric/span name {value!r} is not prefixed by a "
                    f"declared subsystem ({prefix!r} unknown) — register "
                    "the prefix in hs014_metric_names.SUBSYSTEM_PREFIXES "
                    "or use an existing one",
                )
