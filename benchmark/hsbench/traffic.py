"""The one traffic generator: reads a mix's data file
(``traffic/<name>.json``) and draws, from the seed, each query shape's
pool of parameter sets and each client's sequence of queries.

A mix file holds ``clients`` (a closed loop: each sends its next query
when its last returns), ``server`` (the ``ServeConfig`` fields),
``pool`` (parameter sets a shape), ``tables`` (the tables its queries
read; only their indexes are built), ``warm_queries`` (each client's queries
in set-up) and ``shapes``. A shape has a ``name``, a whole-number
``weight``, a ``table``, ``params``, a ``where`` list of
``[column, op, value]`` terms joined by AND, a ``group_by`` column and
``aggs`` (``[fn, column or null]``). A parameter is drawn as
``{"int": [lo, hi]}`` (inclusive), ``{"choice": [...]}`` or
``{"window": {"column": c, "fraction": f}}`` (``lo``/``hi`` of a window of
that share of the column's domain at a uniform start). A value is a list
of terms added together: numbers, ISO dates (as days since 1970) and
parameter names, ``-name`` subtracting and ``name.field`` reaching into a
drawn object.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

import numpy as np

from .tpch import day

OPS = ("<", "<=", ">", ">=", "==")
FNS = ("sum", "avg", "min", "max", "count")
_DATE = re.compile(r"^\d{4}-\d{2}-\d{2}$")


@dataclass(frozen=True)
class Shape:
    name: str
    weight: int
    table: str
    group_by: str
    aggs: tuple  # ((fn, column or None), ...)
    psets: tuple  # ((column, op, value), ...) a parameter set

    def columns(self) -> list:
        """Every column a query of this shape reads."""
        cols = {self.group_by} | {c for c, _o, _v in self.psets[0]}
        return sorted(cols | {c for _f, c in self.aggs if c})


def _draw(spec: dict, rng, stats: dict):
    if "int" in spec:
        lo, hi = spec["int"]
        return int(rng.integers(lo, hi + 1))
    if "choice" in spec:
        return spec["choice"][int(rng.integers(len(spec["choice"])))]
    if "window" in spec:
        w = spec["window"]
        mn, mx = stats[w["column"]]
        width = max(1, int(round(w["fraction"] * (mx - mn + 1))))
        lo = int(rng.integers(mn, max(mn, mx - width + 1) + 1))
        return {"lo": lo, "hi": lo + width}
    raise ValueError(f"unknown parameter spec {spec}")


def _term(t, drawn: dict):
    if isinstance(t, (int, float)):
        return t
    if _DATE.match(t):
        return day(t)
    sign, t = (-1, t[1:]) if t.startswith("-") else (1, t)
    v = drawn
    for part in t.split("."):
        v = v[part]
    return sign * (day(v) if isinstance(v, str) else v)


def resolve(value, drawn: dict):
    terms = value if isinstance(value, list) else [value]
    return sum(_term(t, drawn) for t in terms)


class Mix:
    """A traffic mix: its shapes with their parameter pools, drawn from the
    seed and the columns' domains (``stats``: column -> (min, max))."""

    def __init__(self, spec: dict, seed: int, stats: dict):
        self.seed = int(seed)
        self.clients = int(spec["clients"])
        self.server = dict(spec["server"])
        self.tables = list(spec["tables"])
        self.warm_queries = int(spec.get("warm_queries", 0))
        shapes = []
        for i, s in enumerate(spec["shapes"]):
            rng = np.random.default_rng([self.seed, 1, i])
            psets = []
            for _ in range(int(spec["pool"])):
                drawn = {k: _draw(p, rng, stats) for k, p in s.get("params", {}).items()}
                psets.append(tuple((c, op, resolve(v, drawn)) for c, op, v in s["where"]))
            for c, op, _v in s["where"]:
                if op not in OPS:
                    raise ValueError(f"{s['name']}: unknown operator {op}")
            for fn, _c in s["aggs"]:
                if fn not in FNS:
                    raise ValueError(f"{s['name']}: unknown aggregate {fn}")
            shapes.append(Shape(s["name"], int(s["weight"]), s["table"], s["group_by"],
                                tuple((fn, c) for fn, c in s["aggs"]), tuple(psets)))
        self.shapes = shapes
        w = [s.weight for s in shapes]
        g = int(np.gcd.reduce(w))
        # every block of a client's stream holds each shape weight / g times
        self._block = np.repeat(np.arange(len(shapes)), [x // g for x in w])

    def stream(self, client: int):
        """Client ``client``'s endless sequence of (shape index, parameter
        set index, u): ``u`` a uniform draw that picks the answers kept
        whole for the comparison. The shapes come in blocks that hold each
        in its weight's proportion, in an order drawn from the seed, so
        every seed sends the same mix. Clients from ``clients`` on are
        set-up's warm-up, apart from the window's."""
        rng = np.random.default_rng([self.seed, 2, client])
        while True:
            for s in rng.permutation(self._block).tolist():
                yield s, int(rng.integers(len(self.shapes[s].psets))), float(rng.random())
