"""Aggregate specs for group-by queries.

The reference delegates aggregation to Spark — its indexes accelerate the
scans and joins *below* an Aggregate (the TPC-H Q17 shape of the north
star: an aggregate over an index-rewritten join). This framework owns the
whole query path, so it carries a small aggregate layer: specs name an
input column and a function; the executor groups by factorized key codes
and reduces with vectorized segment operations.

NULL semantics follow SQL: NULL group keys form their own group;
``count(col)`` counts non-NULL values (string NULLs and float NaNs);
sum/avg/min/max skip NULLs; ``count(*)`` counts rows.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

from ..exceptions import HyperspaceException

_FNS = ("sum", "count", "min", "max", "avg")


@dataclass(frozen=True)
class AggSpec:
    fn: str  # sum | count | min | max | avg
    column: Optional[str]  # None only for count(*)
    name: str  # output column name

    def __post_init__(self):
        if self.fn not in _FNS:
            raise HyperspaceException(
                f"Unknown aggregate {self.fn!r}; use one of {_FNS}."
            )
        if self.column is None and self.fn != "count":
            raise HyperspaceException(f"{self.fn} requires a column.")


def agg_sum(column: str, name: Optional[str] = None) -> AggSpec:
    return AggSpec("sum", column, name or f"sum_{column}")


def agg_count(column: Optional[str] = None, name: Optional[str] = None) -> AggSpec:
    return AggSpec("count", column, name or (f"count_{column}" if column else "count"))


def agg_min(column: str, name: Optional[str] = None) -> AggSpec:
    return AggSpec("min", column, name or f"min_{column}")


def agg_max(column: str, name: Optional[str] = None) -> AggSpec:
    return AggSpec("max", column, name or f"max_{column}")


def agg_avg(column: str, name: Optional[str] = None) -> AggSpec:
    return AggSpec("avg", column, name or f"avg_{column}")


def output_dtype(spec: AggSpec, input_dtype: Optional[str]) -> str:
    """Result dtype of one aggregate (SQL-ish promotion rules)."""
    if spec.fn == "count":
        return "int64"
    if spec.fn == "avg":
        return "float64"
    if spec.fn == "sum":
        if input_dtype is None:
            return "int64"
        return "float64" if input_dtype.startswith("float") else "int64"
    return input_dtype or "string"  # min/max keep the input dtype


def validate_specs(specs: Tuple[AggSpec, ...], group_by: Tuple[str, ...]) -> None:
    seen = set(group_by)
    for s in specs:
        if s.name in seen:
            raise HyperspaceException(
                f"Duplicate output column {s.name!r} in aggregation."
            )
        seen.add(s.name)
