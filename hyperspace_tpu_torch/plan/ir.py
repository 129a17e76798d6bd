"""The logical plan IR — the framework's replacement for Catalyst plans.

Nodes are deliberately at the altitude the reference's rules actually
consume: Scan (LogicalRelation), Filter, Project, Join, Aggregate, plus
the nodes the rewrite layer introduces — IndexScan (the swapped-in index
relation, printing the same ``Hyperspace(Type: CI, Name, LogVersion)``
marker as IndexHadoopFsRelation.scala:42-47) and Hybrid Scan's merges:
Union, BucketUnion (the partition-preserving union of
plans/logical/BucketUnion.scala:31-67) and the Repartition that brings
appended rows into the index's buckets.

Plans are immutable; ``transform_up`` rebuilds bottom-up like Catalyst's
``transformUp`` (JoinIndexRule.scala:57-90 relies on this traversal order).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Callable, Dict, List, Optional, Tuple

from ..exceptions import HyperspaceException
from ..sources.relation import FileRelation
from .expr import Expr


class LogicalPlan:
    """Base node. Subclasses define ``children`` and ``output_columns``."""

    @property
    def node_name(self) -> str:
        return type(self).__name__

    @property
    def children(self) -> Tuple["LogicalPlan", ...]:
        return ()

    def with_children(self, children: Tuple["LogicalPlan", ...]) -> "LogicalPlan":
        if children != self.children:
            raise HyperspaceException(f"{self.node_name} takes no children.")
        return self

    def output_columns(self) -> List[str]:
        raise NotImplementedError

    def output_schema(self) -> Dict[str, str]:
        raise NotImplementedError

    # -- traversal -----------------------------------------------------------
    def transform_up(
        self, fn: Callable[["LogicalPlan"], Optional["LogicalPlan"]]
    ) -> "LogicalPlan":
        """Rebuild bottom-up; ``fn`` returns a replacement or None."""
        new_children = tuple(c.transform_up(fn) for c in self.children)
        node = self if new_children == self.children else self.with_children(new_children)
        replaced = fn(node)
        return replaced if replaced is not None else node

    def collect(self, pred: Callable[["LogicalPlan"], bool]) -> List["LogicalPlan"]:
        out = []
        for c in self.children:
            out.extend(c.collect(pred))
        if pred(self):
            out.append(self)
        return out

    def tree_string(self, indent: int = 0) -> str:
        line = "  " * indent + self.describe()
        return "\n".join([line] + [c.tree_string(indent + 1) for c in self.children])

    def describe(self) -> str:
        return self.node_name

    def __repr__(self) -> str:
        return self.tree_string()


@dataclass(frozen=True)
class Scan(LogicalPlan):
    """Leaf scan of a file-based source relation."""

    relation: FileRelation

    def output_columns(self) -> List[str]:
        return self.relation.column_names

    def output_schema(self) -> Dict[str, str]:
        return dict(self.relation.schema)

    def describe(self) -> str:
        return f"Scan [{self.relation.describe()}] ({len(self.relation.files)} files)"


@dataclass(frozen=True)
class Filter(LogicalPlan):
    condition: Expr
    child: LogicalPlan

    @property
    def children(self):
        return (self.child,)

    def with_children(self, children):
        return replace(self, child=children[0])

    def output_columns(self) -> List[str]:
        return self.child.output_columns()

    def output_schema(self) -> Dict[str, str]:
        return self.child.output_schema()

    def describe(self) -> str:
        return f"Filter [{self.condition!r}]"


@dataclass(frozen=True)
class Project(LogicalPlan):
    columns: Tuple[str, ...]
    child: LogicalPlan

    @property
    def children(self):
        return (self.child,)

    def with_children(self, children):
        return replace(self, child=children[0])

    def output_columns(self) -> List[str]:
        return list(self.columns)

    def output_schema(self) -> Dict[str, str]:
        s = self.child.output_schema()
        return {c: s[c] for c in self.columns}

    def describe(self) -> str:
        return f"Project [{', '.join(self.columns)}]"


@dataclass(frozen=True)
class Join(LogicalPlan):
    """Inner equi-join; ``condition`` is an AND-tree of Col == Col
    comparisons (the only join shape the reference's JoinIndexRule
    accepts, JoinIndexRule.scala:118-124)."""

    left: LogicalPlan
    right: LogicalPlan
    condition: Expr
    join_type: str = "inner"

    @property
    def children(self):
        return (self.left, self.right)

    def with_children(self, children):
        return replace(self, left=children[0], right=children[1])

    def output_columns(self) -> List[str]:
        return self.left.output_columns() + self.right.output_columns()

    def output_schema(self) -> Dict[str, str]:
        return {**self.left.output_schema(), **self.right.output_schema()}

    def describe(self) -> str:
        return f"Join [{self.condition!r}] ({self.join_type})"


@dataclass(frozen=True)
class IndexScan(LogicalPlan):
    """Leaf scan over a covering index's TCB data — what the rewrite rules
    swap in for a Scan. ``use_bucket_spec`` mirrors the reference's
    useBucketSpec: joins keep bucket alignment (shuffle-free SMJ), filters
    drop it to not cap parallelism (FilterIndexRule.scala:58-65)."""

    entry: "object" = field(repr=False)  # IndexLogEntry (untyped to avoid cycle)
    required_columns: Tuple[str, ...] = ()
    use_bucket_spec: bool = False

    def output_columns(self) -> List[str]:
        return list(self.required_columns)

    def output_schema(self) -> Dict[str, str]:
        return {c: self.entry.schema[c] for c in self.required_columns}

    def describe(self) -> str:
        # The plan marker the reference prints (IndexHadoopFsRelation.scala:42-47)
        return (
            f"IndexScan Hyperspace(Type: CI, Name: {self.entry.name}, "
            f"LogVersion: {self.entry.id}) [{', '.join(self.required_columns)}]"
            f"{' bucketed' if self.use_bucket_spec else ''}"
        )


@dataclass(frozen=True)
class Aggregate(LogicalPlan):
    """Hash-aggregate: group by ``group_by`` columns, compute ``aggs``
    (plan.aggregates.AggSpec). Sits ABOVE the index-rewritable subtree —
    the reference's Q17-style queries aggregate over an index-rewritten
    join, with Spark supplying this node; here the framework owns it."""

    group_by: Tuple[str, ...]
    aggs: Tuple["object", ...]  # AggSpec (untyped to avoid import cycle)
    child: LogicalPlan

    def input_columns(self) -> List[str]:
        """The child columns this aggregate reads: group keys + aggregate
        input columns, first-occurrence order. The ONE definition shared
        by execution, the distributed fusion, and column pruning."""
        return list(
            dict.fromkeys(
                list(self.group_by)
                + [a.column for a in self.aggs if a.column is not None]
            )
        )

    @property
    def children(self):
        return (self.child,)

    def with_children(self, children):
        return replace(self, child=children[0])

    def output_columns(self) -> List[str]:
        return list(self.group_by) + [a.name for a in self.aggs]

    def output_schema(self) -> Dict[str, str]:
        from .aggregates import output_dtype

        child_schema = self.child.output_schema()
        out = {c: child_schema[c] for c in self.group_by}
        for a in self.aggs:
            out[a.name] = output_dtype(
                a, child_schema.get(a.column) if a.column else None
            )
        return out

    def describe(self) -> str:
        parts = [f"{a.fn}({a.column or '*'}) AS {a.name}" for a in self.aggs]
        return f"Aggregate [{', '.join(self.group_by)}] [{', '.join(parts)}]"


@dataclass(frozen=True)
class BucketUnion(LogicalPlan):
    """Partition-preserving union: children must agree on schema and bucket
    count (BucketUnion.scala:31-67). Used to merge index data with
    shuffled appended data under Hybrid Scan."""

    children_: Tuple[LogicalPlan, ...]
    bucket_spec: Tuple[Tuple[str, ...], int]  # (bucket columns, numBuckets)

    @property
    def children(self):
        return self.children_

    def with_children(self, children):
        return replace(self, children_=tuple(children))

    def output_columns(self) -> List[str]:
        return self.children_[0].output_columns()

    def output_schema(self) -> Dict[str, str]:
        return self.children_[0].output_schema()

    def describe(self) -> str:
        cols, n = self.bucket_spec
        return f"BucketUnion [{', '.join(cols)}] x{n}"


@dataclass(frozen=True)
class Repartition(LogicalPlan):
    """Hash-repartition of the child by ``columns`` into ``num_buckets`` —
    the on-the-fly shuffle injected for appended data under Hybrid Scan
    (RuleUtils.scala:519-578, RepartitionByExpression)."""

    columns: Tuple[str, ...]
    num_buckets: int
    child: LogicalPlan

    @property
    def children(self):
        return (self.child,)

    def with_children(self, children):
        return replace(self, child=children[0])

    def output_columns(self) -> List[str]:
        return self.child.output_columns()

    def output_schema(self) -> Dict[str, str]:
        return self.child.output_schema()

    def describe(self) -> str:
        return f"Repartition [{', '.join(self.columns)}] x{self.num_buckets}"


@dataclass(frozen=True)
class Union(LogicalPlan):
    """Plain row union (the non-bucketed Hybrid Scan merge,
    RuleUtils.scala:443-446)."""

    children_: Tuple[LogicalPlan, ...]

    @property
    def children(self):
        return self.children_

    def with_children(self, children):
        return replace(self, children_=tuple(children))

    def output_columns(self) -> List[str]:
        return self.children_[0].output_columns()

    def output_schema(self) -> Dict[str, str]:
        return self.children_[0].output_schema()
