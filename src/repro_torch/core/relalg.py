"""Logical relational algebra + fluent query builder.

The builder API below produces this tree (the SQL front-end arrives with a
later slice of this package); the optimizer (optimizer.py) rewrites it; the executor (executor.py) compiles it
into a MAL-style column-at-a-time program (mal.py).  Matches the paper's
§3.1 "Query Plan Execution" pipeline: SQL -> relational tree -> MAL.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

from .expression import Col, Expr, Lit

# ---------------------------------------------------------------------------
# aggregate spec
# ---------------------------------------------------------------------------

AGG_FNS = ("sum", "count", "avg", "min", "max", "median",
           "count_distinct", "first", "var", "std")


@dataclass(frozen=True)
class AggSpec:
    fn: str                      # one of AGG_FNS; count with expr=None = COUNT(*)
    expr: Optional[Expr]
    name: str

    def __post_init__(self):
        if self.fn not in AGG_FNS:
            raise ValueError(f"unknown aggregate {self.fn}")


# ---------------------------------------------------------------------------
# plan nodes
# ---------------------------------------------------------------------------


class PlanNode:
    children: tuple

    def output_columns(self, catalog) -> list[str]:  # pragma: no cover
        raise NotImplementedError

    def with_children(self, children) -> "PlanNode":
        raise NotImplementedError


@dataclass
class ScanNode(PlanNode):
    table: str
    columns: Optional[tuple[str, ...]] = None   # None = all (pruned later)
    children: tuple = ()

    def output_columns(self, catalog):
        if self.columns is not None:
            return list(self.columns)
        return list(catalog.table(self.table).schema.names)

    def with_children(self, children):
        return self


@dataclass
class FilterNode(PlanNode):
    child: PlanNode
    predicate: Expr

    @property
    def children(self):
        return (self.child,)

    def output_columns(self, catalog):
        return self.child.output_columns(catalog)

    def with_children(self, children):
        return FilterNode(children[0], self.predicate)


@dataclass
class ProjectNode(PlanNode):
    child: PlanNode
    exprs: tuple[tuple[Expr, str], ...]      # (expression, output name)

    @property
    def children(self):
        return (self.child,)

    def output_columns(self, catalog):
        return [n for _, n in self.exprs]

    def with_children(self, children):
        return ProjectNode(children[0], self.exprs)


@dataclass
class AggregateNode(PlanNode):
    child: PlanNode
    group_by: tuple[str, ...]                # grouping key column names
    aggs: tuple[AggSpec, ...]

    @property
    def children(self):
        return (self.child,)

    def output_columns(self, catalog):
        return list(self.group_by) + [a.name for a in self.aggs]

    def with_children(self, children):
        return AggregateNode(children[0], self.group_by, self.aggs)


@dataclass
class JoinNode(PlanNode):
    left: PlanNode
    right: PlanNode
    left_keys: tuple[str, ...]
    right_keys: tuple[str, ...]
    how: str = "inner"                       # inner | left | semi | anti

    @property
    def children(self):
        return (self.left, self.right)

    def output_columns(self, catalog):
        lcols = self.left.output_columns(catalog)
        if self.how in ("semi", "anti"):
            return lcols
        rcols = self.right.output_columns(catalog)
        return lcols + [c for c in rcols if c not in lcols]

    def with_children(self, children):
        return JoinNode(children[0], children[1], self.left_keys,
                        self.right_keys, self.how)


@dataclass
class OrderByNode(PlanNode):
    child: PlanNode
    keys: tuple[tuple[str, bool], ...]       # (column, descending)
    limit: Optional[int] = None              # fused top-N

    @property
    def children(self):
        return (self.child,)

    def output_columns(self, catalog):
        return self.child.output_columns(catalog)

    def with_children(self, children):
        return OrderByNode(children[0], self.keys, self.limit)


@dataclass
class LimitNode(PlanNode):
    child: PlanNode
    n: int

    @property
    def children(self):
        return (self.child,)

    def output_columns(self, catalog):
        return self.child.output_columns(catalog)

    def with_children(self, children):
        return LimitNode(children[0], self.n)


def walk(node: PlanNode):
    yield node
    for c in node.children:
        yield from walk(c)


def node_line(node: PlanNode) -> str:
    """One operator's display line (shared by the logical ``plan_repr`` and
    the physical planner's EXPLAIN output)."""
    if isinstance(node, ScanNode):
        return f"Scan({node.table}, cols={list(node.columns) if node.columns else '*'})"
    if isinstance(node, FilterNode):
        return f"Filter({node.predicate!r})"
    if isinstance(node, ProjectNode):
        return f"Project({[n for _, n in node.exprs]})"
    if isinstance(node, AggregateNode):
        return f"Aggregate(by={list(node.group_by)}, aggs={[a.fn + ':' + a.name for a in node.aggs]})"
    if isinstance(node, JoinNode):
        return f"Join({node.how}, {list(node.left_keys)}={list(node.right_keys)})"
    if isinstance(node, OrderByNode):
        return f"OrderBy({list(node.keys)}, limit={node.limit})"
    if isinstance(node, LimitNode):
        return f"Limit({node.n})"
    return repr(node)


def plan_repr(node: PlanNode, indent: int = 0) -> str:
    line = "  " * indent + node_line(node)
    return "\n".join([line] + [plan_repr(c, indent + 1) for c in node.children])


# ---------------------------------------------------------------------------
# fluent builder
# ---------------------------------------------------------------------------


class Query:
    """DataFrame-style builder over the relational algebra.

    ``db.scan("lineitem").filter(...).group_by(...).agg(...)`` etc.  Executed
    via ``.execute()`` (returns a result Table) through the session's
    executor with optimization enabled.
    """

    def __init__(self, plan: PlanNode, database):
        self.plan = plan
        self.database = database

    def _wrap(self, plan) -> "Query":
        return Query(plan, self.database)

    def filter(self, predicate: Expr) -> "Query":
        return self._wrap(FilterNode(self.plan, predicate))

    def project(self, **exprs) -> "Query":
        items = tuple((e if isinstance(e, Expr) else Lit(e), n)
                      for n, e in exprs.items())
        return self._wrap(ProjectNode(self.plan, items))

    def select(self, *names: str) -> "Query":
        items = tuple((Col(n), n) for n in names)
        return self._wrap(ProjectNode(self.plan, items))

    def group_by(self, *keys: str) -> "GroupedQuery":
        return GroupedQuery(self, keys)

    def agg(self, **aggs) -> "Query":
        return GroupedQuery(self, ()).agg(**aggs)

    def join(self, other: "Query", on=None, left_on=None, right_on=None,
             how: str = "inner") -> "Query":
        if on is not None:
            lk = rk = tuple([on] if isinstance(on, str) else on)
        else:
            lk = tuple([left_on] if isinstance(left_on, str) else left_on)
            rk = tuple([right_on] if isinstance(right_on, str) else right_on)
        return self._wrap(JoinNode(self.plan, other.plan, lk, rk, how))

    def order_by(self, *keys, limit: Optional[int] = None) -> "Query":
        norm = tuple((k, False) if isinstance(k, str) else (k[0], bool(k[1]))
                     for k in keys)
        return self._wrap(OrderByNode(self.plan, norm, limit))

    def limit(self, n: int) -> "Query":
        return self._wrap(LimitNode(self.plan, n))

    def having(self, predicate: Expr) -> "Query":
        return self._wrap(FilterNode(self.plan, predicate))

    def explain(self, optimized: bool = True, physical: bool = False,
                distributed: bool = False) -> str:
        """Logical plan text, or — with ``physical=True`` — the unified
        physical planner's lowering: the normalized plan with per-operator
        tier decisions (device-resident / device-streamed / parallel-host /
        in-memory) and budget reservations.  ``distributed=True`` mirrors
        ``execute(distributed=True)`` and enables the device-tier
        annotations."""
        if physical:
            from .physplan import plan_physical
            phys = plan_physical(self.plan, self.database,
                                 do_optimize=optimized,
                                 distributed=distributed)
            return phys.render()
        plan = self.plan
        if optimized:
            from .optimizer import optimize
            plan = optimize(plan, self.database.catalog)
        return plan_repr(plan)

    def execute(self, **kw):
        return self.database.execute_plan(self.plan, **kw)

    def to_dict(self, **kw):
        return self.execute(**kw).to_pydict()


class GroupedQuery:
    def __init__(self, query: Query, keys: Sequence[str]):
        self.query = query
        self.keys = tuple(keys)

    def agg(self, **aggs) -> Query:
        """agg(total=("sum", expr), n=("count", None), ...)"""
        specs = []
        for name, spec in aggs.items():
            fn, expr = spec if isinstance(spec, tuple) else (spec, None)
            if isinstance(expr, str):
                expr = Col(expr)
            specs.append(AggSpec(fn, expr, name))
        return self.query._wrap(
            AggregateNode(self.query.plan, self.keys, tuple(specs)))
