"""Relational-tree optimization passes (paper §3.1 level 1).

Passes, applied in order:
  1. constant folding inside expressions,
  2. predicate decomposition (split top-level ANDs),
  3. filter pushdown (through projections, into join inputs),
  4. inner-join-chain reordering (greedy: smallest estimated input first),
  5. projection / column pruning (scans load only referenced columns).

MAL-level CSE (level 2) lives in executor.compile_plan; tactical decisions
(level 3: join algorithm choice) are made at runtime in executor.run.
"""

from __future__ import annotations

from typing import Optional


from .expression import (BinOp, Case, Cast, Col, Expr, Func, InList, IsNull,
                         Like, Lit, Not)
from .relalg import (AggregateNode, FilterNode, JoinNode, LimitNode,
                     OrderByNode, PlanNode, ProjectNode, ScanNode)


def optimize(plan: PlanNode, catalog) -> PlanNode:
    plan = _fold_expressions(plan)
    plan = _push_filters(plan, catalog)
    plan = _reorder_joins(plan, catalog)
    plan = _push_filters(plan, catalog)     # re-push after reorder
    plan = _prune_columns(plan, catalog)
    return plan


# ---------------------------------------------------------------------------
# 1. constant folding
# ---------------------------------------------------------------------------


def fold_expr(e: Expr) -> Expr:
    if isinstance(e, BinOp):
        l, r = fold_expr(e.left), fold_expr(e.right)
        if isinstance(l, Lit) and isinstance(r, Lit) \
                and l.value is not None and r.value is not None \
                and e.op in ("+", "-", "*", "/") \
                and not isinstance(l.value, str):
            lv, rv = l.value, r.value
            try:
                out = {"+": lv + rv, "-": lv - rv, "*": lv * rv,
                       "/": lv / rv if rv != 0 else None}[e.op]
                if out is not None:
                    return Lit(out)
            except Exception:
                pass
        return BinOp(e.op, l, r)
    if isinstance(e, Not):
        return Not(fold_expr(e.child))
    if isinstance(e, IsNull):
        return IsNull(fold_expr(e.child), e.negate)
    if isinstance(e, InList):
        return InList(fold_expr(e.child), e.values)
    if isinstance(e, Like):
        return Like(fold_expr(e.child), e.pattern)
    if isinstance(e, Func):
        f = Func.__new__(Func)
        f.name, f.args = e.name, tuple(fold_expr(a) for a in e.args)
        return f
    if isinstance(e, Case):
        return Case(tuple((fold_expr(c), fold_expr(v))
                          for c, v in e.branches), fold_expr(e.default))
    if isinstance(e, Cast):
        return Cast(fold_expr(e.child), e.to)
    return e


def _map_exprs(node: PlanNode, fn) -> PlanNode:
    node = node.with_children(tuple(_map_exprs(c, fn) for c in node.children))
    if isinstance(node, FilterNode):
        return FilterNode(node.child, fn(node.predicate))
    if isinstance(node, ProjectNode):
        return ProjectNode(node.child,
                           tuple((fn(e), n) for e, n in node.exprs))
    if isinstance(node, AggregateNode):
        from .relalg import AggSpec
        return AggregateNode(node.child, node.group_by, tuple(
            AggSpec(a.fn, fn(a.expr) if a.expr is not None else None, a.name)
            for a in node.aggs))
    return node


def _fold_expressions(plan: PlanNode) -> PlanNode:
    return _map_exprs(plan, fold_expr)


# ---------------------------------------------------------------------------
# 2+3. predicate decomposition + filter pushdown
# ---------------------------------------------------------------------------


def split_conjuncts(e: Expr) -> list[Expr]:
    if isinstance(e, BinOp) and e.op == "and":
        return split_conjuncts(e.left) + split_conjuncts(e.right)
    return [e]


def _conjoin(preds: list[Expr]) -> Expr:
    out = preds[0]
    for p in preds[1:]:
        out = BinOp("and", out, p)
    return out


def _substitute(e: Expr, mapping: dict[str, Expr]) -> Optional[Expr]:
    """Rewrite column refs through a projection; None if not rewritable."""
    if isinstance(e, Col):
        return mapping.get(e.name)
    if isinstance(e, Lit):
        return e
    if isinstance(e, BinOp):
        l = _substitute(e.left, mapping)
        r = _substitute(e.right, mapping)
        return BinOp(e.op, l, r) if l is not None and r is not None else None
    if isinstance(e, Not):
        c = _substitute(e.child, mapping)
        return Not(c) if c is not None else None
    if isinstance(e, IsNull):
        c = _substitute(e.child, mapping)
        return IsNull(c, e.negate) if c is not None else None
    if isinstance(e, InList):
        c = _substitute(e.child, mapping)
        return InList(c, e.values) if c is not None else None
    if isinstance(e, Like):
        c = _substitute(e.child, mapping)
        return Like(c, e.pattern) if c is not None else None
    if isinstance(e, Func):
        args = [_substitute(a, mapping) for a in e.args]
        if any(a is None for a in args):
            return None
        f = Func.__new__(Func)
        f.name, f.args = e.name, tuple(args)
        return f
    if isinstance(e, Cast):
        c = _substitute(e.child, mapping)
        return Cast(c, e.to) if c is not None else None
    return None  # Case / DateLit handled conservatively


def _push_filters(node: PlanNode, catalog, pending: list[Expr] = None) -> PlanNode:
    pending = list(pending or [])

    if isinstance(node, FilterNode):
        pending.extend(split_conjuncts(node.predicate))
        return _push_filters(node.child, catalog, pending)

    if isinstance(node, ProjectNode):
        mapping = {n: e for e, n in node.exprs}
        stay, push = [], []
        for p in pending:
            sub = _substitute(p, mapping)
            (push if sub is not None else stay).append(
                sub if sub is not None else p)
        child = _push_filters(node.child, catalog, push)
        out: PlanNode = ProjectNode(child, node.exprs)
        return FilterNode(out, _conjoin(stay)) if stay else out

    if isinstance(node, JoinNode):
        lcols = set(node.left.output_columns(catalog))
        rcols = set(node.right.output_columns(catalog))
        lp, rp, stay = [], [], []
        for p in pending:
            refs = p.columns()
            if refs and refs <= lcols:
                lp.append(p)
            elif refs and refs <= rcols and node.how == "inner":
                rp.append(p)
            else:
                stay.append(p)
        left = _push_filters(node.left, catalog, lp)
        right = _push_filters(node.right, catalog, rp)
        out: PlanNode = JoinNode(left, right, node.left_keys,
                                 node.right_keys, node.how)
        return FilterNode(out, _conjoin(stay)) if stay else out

    if isinstance(node, AggregateNode):
        keys = set(node.group_by)
        push, stay = [], []
        for p in pending:
            (push if p.columns() and p.columns() <= keys else stay).append(p)
        child = _push_filters(node.child, catalog, push)
        out: PlanNode = AggregateNode(child, node.group_by, node.aggs)
        return FilterNode(out, _conjoin(stay)) if stay else out

    if isinstance(node, (OrderByNode, LimitNode)):
        # limits do not commute with filters; stop pushing
        child = _push_filters(node.children[0], catalog, [])
        out = node.with_children((child,))
        return FilterNode(out, _conjoin(pending)) if pending else out

    if isinstance(node, ScanNode):
        return FilterNode(node, _conjoin(pending)) if pending else node

    children = tuple(_push_filters(c, catalog, []) for c in node.children)
    out = node.with_children(children)
    return FilterNode(out, _conjoin(pending)) if pending else out


# ---------------------------------------------------------------------------
# 4. inner-join-chain reordering (greedy by estimated cardinality)
# ---------------------------------------------------------------------------


def estimate_rows(node: PlanNode, catalog) -> float:
    """Cardinality estimate (paper optimization level 1 statistics).  Used
    for join-order decisions below and by the execution tiers to predict
    whether a plan's blocking intermediates fit the memory budget."""
    if isinstance(node, ScanNode):
        return float(catalog.table(node.table).num_rows)
    if isinstance(node, FilterNode):
        return 0.25 * estimate_rows(node.child, catalog)
    if isinstance(node, JoinNode):
        l = estimate_rows(node.left, catalog)
        r = estimate_rows(node.right, catalog)
        return max(l, r)
    if isinstance(node, AggregateNode):
        return max(1.0, 0.1 * estimate_rows(node.child, catalog))
    if isinstance(node, LimitNode):
        return float(node.n)
    if node.children:
        return estimate_rows(node.children[0], catalog)
    return 1.0


def estimate_bytes(node: PlanNode, catalog) -> float:
    """Upper-ish bound on the widest intermediate a plan materializes:
    max over plan nodes of (estimated rows x output width).  The parallel
    tier uses this to keep the sharded fast path for fitting inputs and
    leave oversized plans to the host tier's spill operators."""
    try:
        width = 8.0 * max(1, len(node.output_columns(catalog)))
    except Exception:
        width = 8.0
    own = estimate_rows(node, catalog) * width
    return max([own] + [estimate_bytes(c, catalog) for c in node.children])


# Device-tier placement (choose_device_tier) moved to physplan.py: tier
# routing is the unified physical planner's job; this module keeps the
# level-1 statistics (estimate_rows / estimate_bytes) the planner costs
# plans with.


def _reorder_joins(node: PlanNode, catalog) -> PlanNode:
    """Left-deep inner-equi-join chains: put the smaller input on the build
    (right) side of each join.  Conservative: swaps a single join's sides
    when the right side is estimated larger; key lists swap with them."""
    node = node.with_children(
        tuple(_reorder_joins(c, catalog) for c in node.children))
    if isinstance(node, JoinNode) and node.how == "inner":
        l = estimate_rows(node.left, catalog)
        r = estimate_rows(node.right, catalog)
        if r > l * 1.5:
            # probe the big side, build on the small side: swap
            return JoinNode(node.right, node.left, node.right_keys,
                            node.left_keys, "inner")
    return node


# ---------------------------------------------------------------------------
# 5. projection pruning (column pruning down to scans)
# ---------------------------------------------------------------------------


def _prune_columns(node: PlanNode, catalog,
                   needed: Optional[set[str]] = None) -> PlanNode:
    if isinstance(node, ScanNode):
        all_cols = list(catalog.table(node.table).schema.names)
        if needed is None:
            cols = tuple(all_cols)
        else:
            cols = tuple(c for c in all_cols if c in needed)
            if not cols:
                cols = (all_cols[0],)          # keep one col for row count
        return ScanNode(node.table, cols)

    if isinstance(node, FilterNode):
        child_needed = None if needed is None else (
            set(needed) | node.predicate.columns())
        return FilterNode(
            _prune_columns(node.child, catalog, child_needed),
            node.predicate)

    if isinstance(node, ProjectNode):
        exprs = node.exprs if needed is None else tuple(
            (e, n) for e, n in node.exprs if n in needed) or node.exprs[:1]
        child_needed = set()
        for e, _ in exprs:
            child_needed |= e.columns()
        return ProjectNode(
            _prune_columns(node.child, catalog, child_needed or None), exprs)

    if isinstance(node, AggregateNode):
        child_needed = set(node.group_by)
        for a in node.aggs:
            if a.expr is not None:
                child_needed |= a.expr.columns()
        return AggregateNode(
            _prune_columns(node.child, catalog, child_needed or None),
            node.group_by, node.aggs)

    if isinstance(node, JoinNode):
        lcols = set(node.left.output_columns(catalog))
        rcols = set(node.right.output_columns(catalog))
        if needed is None:
            ln, rn = None, None
        else:
            ln = (set(needed) & lcols) | set(node.left_keys)
            rn = (set(needed) & rcols) | set(node.right_keys)
        return JoinNode(_prune_columns(node.left, catalog, ln),
                        _prune_columns(node.right, catalog, rn),
                        node.left_keys, node.right_keys, node.how)

    if isinstance(node, OrderByNode):
        child_needed = None if needed is None else (
            set(needed) | {k for k, _ in node.keys})
        return OrderByNode(
            _prune_columns(node.child, catalog, child_needed),
            node.keys, node.limit)

    if isinstance(node, LimitNode):
        return LimitNode(_prune_columns(node.child, catalog, needed), node.n)

    return node.with_children(
        tuple(_prune_columns(c, catalog, None) for c in node.children))
