"""Unified physical planner: one logical→physical lowering pass.

Every query flows through ``plan_physical`` before execution.  The pass has
three jobs, matching the paper's one-planner-many-frontends architecture
(§3: the same optimizer and execution machinery serve every entry point,
choosing strategies from data statistics rather than per-API code paths):

1. **Normalization** — plans converge to one canonical shape: trivial
   (identity) projections are elided, pure-rename projections over an
   aggregate are pushed into the aggregate's output names, and filter
   conjuncts are merged + canonically ordered.

2. **Tier annotation** — each operator gets a tier decision
   (``device-resident`` / ``device-streamed`` / ``parallel-host`` /
   ``in-memory``) and a budget reservation, from ONE costed policy
   (``TierPolicy``).  Device admission is biased by the
   ``DeviceBufferManager``'s cache-hit history: repeated queries on a
   borderline table flip from streamed to resident.

3. **Observability** — ``PhysicalPlan.render()`` is the EXPLAIN text
   surfaced through ``Query.explain(physical=True)`` and
   ``ExecStats.plan_repr``.

This package holds the scan-agg half of the planner: the device join tier
(``match_join_agg``), imprint skip-sets (``derive_skip_sets``) and the
spill tier's routing wait for their slices.  The device runs on one card,
so the shard count is 1 and there is no mesh.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np

from .expression import BinOp, Col, DateLit, Expr, Lit
from .optimizer import estimate_rows, optimize, split_conjuncts
from .relalg import (AggregateNode, AggSpec, FilterNode, JoinNode, LimitNode,
                     OrderByNode, PlanNode, ProjectNode, ScanNode, node_line)
from .types import DBType, NULL_SENTINEL, date_from_string

# ---------------------------------------------------------------------------
# tier names (the vocabulary of the physical plan)
# ---------------------------------------------------------------------------

TIER_DEVICE_RESIDENT = "device-resident"
TIER_DEVICE_STREAMED = "device-streamed"
TIER_DEVICE_SORT = "device-sort"
TIER_PARALLEL_HOST = "parallel-host"
TIER_SPILL = "spill"
TIER_IN_MEMORY = "in-memory"

# tiers whose reservations count against the DEVICE budget at admission
DEVICE_TIERS = (TIER_DEVICE_RESIDENT, TIER_DEVICE_STREAMED,
                TIER_DEVICE_SORT)

# pattern limits for the device scan-agg tier
MAX_DENSE_GROUPS = 4096
MIN_ROWS_TO_SHARD = 4096      # paper: don't split small columns
DEVICE_BATCH_ROWS = 1 << 16   # morsel batch streamed through the device
                              # cache; fixed per database (not per budget)
                              # so results are budget-invariant
SUPPORTED_DEVICE_AGGS = {"count", "sum", "avg", "min", "max"}

# smarter admission (ROADMAP): a table that fits the device budget but
# would monopolize more than this fraction of the cache is only admitted
# *resident* once its cache-hit history proves repeat access; until then it
# streams (whose blocks still populate the cache, accruing that history).
DEVICE_BORDERLINE_FRACTION = 0.5
DEVICE_PROMOTE_HITS = 1

# table name of the materialized scan-agg core inside a suffix plan ("#"
# prefix: never collides with SQL identifiers, same convention as the
# device cache's pseudo-columns)
AGG_RESULT_NAME = "#agg"


# ---------------------------------------------------------------------------
# scan-agg pattern (THE device-tier shape) — single definition
# ---------------------------------------------------------------------------


@dataclass
class ScanAggSpec:
    table: str
    conjuncts: list[Expr]
    group_keys: list[str]
    key_domains: list[tuple[float, int]]     # (offset, cardinality) per key
    aggs: list[AggSpec]
    n_groups: int
    columns: list[str]                       # all referenced base columns


def match_scan_agg(plan: PlanNode, catalog) -> Optional[ScanAggSpec]:
    """Aggregate( Filter* ( Scan ) ) with dense-domain group keys."""
    if not isinstance(plan, AggregateNode):
        return None
    if any(a.fn not in SUPPORTED_DEVICE_AGGS for a in plan.aggs):
        return None
    node = plan.child
    conjuncts: list[Expr] = []
    while isinstance(node, FilterNode):
        conjuncts = split_conjuncts(node.predicate) + conjuncts
        node = node.child
    if not isinstance(node, ScanNode):
        return None
    table = catalog.table(node.table)
    # dense domains for the keys
    domains = []
    n_groups = 1
    for k in plan.group_by:
        col = table.column(k)
        if col.dbtype == DBType.VARCHAR:
            offset, card = 0.0, len(col.heap)
        elif col.dbtype == DBType.BOOL:
            offset, card = 0.0, 2
        elif col.dbtype in (DBType.INT32, DBType.INT64, DBType.DATE):
            v = np.asarray(col.data)
            nn = v[v != NULL_SENTINEL[col.dbtype]]
            if nn.size == 0:
                return None
            mn, mx = int(nn.min()), int(nn.max())
            offset, card = float(mn), mx - mn + 1
        else:
            return None
        if card > MAX_DENSE_GROUPS:
            return None
        domains.append((offset, card))
        n_groups *= card
    if n_groups > MAX_DENSE_GROUPS:
        return None
    cols: set[str] = set(plan.group_by)
    for c in conjuncts:
        cols |= c.columns()
    for a in plan.aggs:
        if a.expr is not None:
            cols |= a.expr.columns()
    if not cols:
        cols = {table.schema.names[0]}
    return ScanAggSpec(node.table, conjuncts, list(plan.group_by),
                       domains, list(plan.aggs), n_groups, sorted(cols))


SUFFIX_NODES = (OrderByNode, LimitNode, ProjectNode, FilterNode)


def find_scan_agg_core(plan: PlanNode, catalog
                       ) -> tuple[Optional[AggregateNode],
                                  Optional[PlanNode]]:
    """Locate the scan-agg core under a chain of order/limit/project/filter
    suffix operators.  Returns ``(core, suffix)`` where ``core`` is the
    topmost AggregateNode reachable from the root through suffix nodes (or
    None), and ``suffix`` re-applies those nodes over a scan of the core's
    materialized result (``AGG_RESULT_NAME``), or None when the core IS the
    root.  The suffix runs on the host over the (tiny) assembled aggregate,
    which is what lets ORDER BY / LIMIT / HAVING queries keep their
    scan-agg core on the device tier."""
    path = []
    node = plan
    while isinstance(node, SUFFIX_NODES):
        path.append(node)
        node = node.children[0]
    if not isinstance(node, AggregateNode):
        return None, None
    if not path:
        return node, None
    suffix: PlanNode = ScanNode(AGG_RESULT_NAME,
                                tuple(node.output_columns(catalog)))
    for n in reversed(path):
        suffix = n.with_children((suffix,))
    return node, suffix


# ---------------------------------------------------------------------------
# physical layout of the device partial-aggregate matrix
# ---------------------------------------------------------------------------


@dataclass
class PartialLayout:
    """Column layout of the raw-partial matrix one device batch step emits.

    Columns ``[0, n_sum)`` combine by addition (cnt_star, then per-agg
    count and — for sum/avg — value-sum slots, in agg order); the remaining
    columns are one min- or max-combining slot per min/max aggregate.
    Ratios and NULL masking are *not* applied on device — partials stay
    mergeable across batches and ``parallel.finalize_partials`` applies
    them once at the end, so the arithmetic is identical no matter how many
    batches the input was split into."""
    n_sum: int
    plans: list                  # (agg_idx, kind, cnt_col, val_col)
    minmax: list                 # (agg_idx, fn, cnt_col, out_col)
    kinds: np.ndarray            # (K,) int8: 0 add / 1 min / 2 max
    init: np.ndarray             # (K,) float64 combine identity per column


def partial_layout(spec: ScanAggSpec) -> PartialLayout:
    plans, minmax = [], []
    n_sum = 1                                   # col 0: cnt_star
    for i, a in enumerate(spec.aggs):
        if a.expr is None:
            plans.append((i, "count_star", 0, 0))
            continue
        cnt = n_sum
        n_sum += 1
        if a.fn in ("sum", "avg"):
            plans.append((i, a.fn, cnt, n_sum))
            n_sum += 1
        elif a.fn == "count":
            plans.append((i, "count", cnt, 0))
        else:
            minmax.append([i, a.fn, cnt, 0])
    k = n_sum
    for mm in minmax:
        mm[3] = k
        k += 1
    kinds = np.zeros(k, dtype=np.int8)
    init = np.zeros(k, dtype=np.float64)
    for _, fn, _, c in minmax:
        kinds[c] = 1 if fn == "min" else 2
        init[c] = np.inf if fn == "min" else -np.inf
    return PartialLayout(n_sum, plans, [tuple(m) for m in minmax],
                         kinds, init)


@dataclass
class ScanAggGeometry:
    """Batch decomposition + byte footprint of one device scan-agg.  The
    geometry depends only on (table, batch_rows config) —
    never on the budget — which is what keeps the budget matrix
    bit-identical."""
    batch_rows: int
    n_batches: int
    row_bytes: int
    carry_nbytes: int
    batch_bytes: int
    resident_bytes: int


def scan_agg_geometry(spec: ScanAggSpec, table,
                      batch_rows: Optional[int] = None) -> ScanAggGeometry:
    n_rows = table.num_rows
    m = int(batch_rows or DEVICE_BATCH_ROWS)
    # never pad past the table: a small table gets one table-sized batch
    # instead of a full default batch of mostly padding (which would
    # inflate the byte estimates the tier routing runs on up to ~16x)
    rows = min(m, max(1, n_rows))
    n_batches = max(1, -(-n_rows // rows))
    row_bytes = 1                                   # valid mask
    for c in spec.columns:
        row_bytes += table.column(c).data.dtype.itemsize
    carry = spec.n_groups * len(partial_layout(spec).kinds) * 8
    return ScanAggGeometry(
        batch_rows=rows, n_batches=n_batches, row_bytes=row_bytes,
        carry_nbytes=carry,
        batch_bytes=rows * row_bytes + carry,
        resident_bytes=n_batches * rows * row_bytes + carry)


# ---------------------------------------------------------------------------
# device placement
# ---------------------------------------------------------------------------


def choose_device_tier(resident_bytes: float, batch_bytes: float,
                       device_budget: Optional[int],
                       host_budget: Optional[int] = None,
                       host_bytes: Optional[float] = None,
                       hit_history: int = 0) -> str:
    """Device-tier placement decision (paper optimization level 3, one tier
    up): ``"resident"`` when every block of the input fits the device
    budget at once, ``"streamed"`` when only morsel batches do (double-
    buffered: two batch working sets in flight), ``"host"`` when not even
    one batch fits — the plan stays on the host tier, whose blocking
    operators spill.

    ``host_budget``/``host_bytes`` fold in the *host* memory budget: the
    resident path keeps full device-resident copies (host RAM on CPU
    backends), so an input over the host budget is demoted to streaming —
    but only under a real device budget, because streaming bounds
    residency through *eviction*: with ``device_budget=None`` nothing ever
    evicts, so the demotion would silently retain the whole table and the
    plan goes to the bounded host spill tier instead.

    ``hit_history`` biases admission the way the paper's optimizer uses
    runtime statistics: a *borderline* table — one that fits the budget but
    would occupy more than ``DEVICE_BORDERLINE_FRACTION`` of it, crowding
    out every other table's blocks — is admitted resident only once its
    cumulative device-cache hits (``DeviceBufferManager.hit_history``)
    reach ``DEVICE_PROMOTE_HITS``.  A first query on such a table streams;
    its blocks still land in the cache, so a repeat query observes hits and
    flips to resident."""
    streamable = device_budget is not None \
        and 2 * batch_bytes <= device_budget
    if device_budget is not None and resident_bytes > device_budget:
        return "streamed" if streamable else "host"
    if host_budget is not None and host_bytes is not None \
            and host_bytes > host_budget:
        return "streamed" if streamable else "host"
    if device_budget is not None and streamable \
            and resident_bytes > DEVICE_BORDERLINE_FRACTION * device_budget \
            and hit_history < DEVICE_PROMOTE_HITS:
        return "streamed"
    return "resident"


# ---------------------------------------------------------------------------
# simple range conjuncts (the scan_agg kernel route reads them)
# ---------------------------------------------------------------------------


def _simple_range(expr: Expr):
    """Detect `col <cmp> literal` (the scan_agg kernel route's filters).

    Returns (col, lo, hi, lo_strict, hi_strict) with +-inf open ends."""
    if not isinstance(expr, BinOp) \
            or expr.op not in ("<", "<=", ">", ">=", "="):
        return None
    l, r = expr.left, expr.right
    op = expr.op
    if isinstance(r, Col) and isinstance(l, (Lit, DateLit)):
        l, r = r, l
        op = {"<": ">", ">": "<", "<=": ">=", ">=": "<=", "=": "="}[op]
    if not (isinstance(l, Col) and isinstance(r, (Lit, DateLit))):
        return None
    if isinstance(r, DateLit):
        v = float(date_from_string(r.text))
    else:
        if isinstance(r.value, str) or r.value is None:
            return None
        v = float(r.value)
    lo, hi = -np.inf, np.inf
    lo_s = hi_s = False
    if op == "=":
        lo = hi = v
    elif op == "<":
        hi, hi_s = v, True
    elif op == "<=":
        hi = v
    elif op == ">":
        lo, lo_s = v, True
    elif op == ">=":
        lo = v
    return l.name, lo, hi, lo_s, hi_s


# ---------------------------------------------------------------------------
# normalization: entry points converge to identical shapes
# ---------------------------------------------------------------------------


def _conjoin(preds: list[Expr]) -> Expr:
    out = preds[0]
    for p in preds[1:]:
        out = BinOp("and", out, p)
    return out


def _push_renames_into_agg(proj: ProjectNode, agg: AggregateNode,
                           catalog) -> Optional[AggregateNode]:
    """Project(Aggregate) that only renames — group keys identity-mapped in
    key order, then every aggregate output referenced exactly once, in agg
    order — folds into the aggregate's own output names.  This is the SQL
    front-end's ``__aggN`` rename projection; eliding it is what lets the
    device-tier matcher see SQL aggregates."""
    keys = list(agg.group_by)
    exprs = list(proj.exprs)
    if len(exprs) != len(keys) + len(agg.aggs):
        return None
    if any(not isinstance(e, Col) for e, _ in exprs):
        return None
    for (e, n), k in zip(exprs[:len(keys)], keys):
        if e.name != k or n != k:
            return None
    new_aggs = []
    for (e, n), a in zip(exprs[len(keys):], agg.aggs):
        if e.name != a.name:
            return None
        new_aggs.append(AggSpec(a.fn, a.expr, n))
    names = keys + [a.name for a in new_aggs]
    if len(set(names)) != len(names):
        return None
    return AggregateNode(agg.child, agg.group_by, tuple(new_aggs))


def normalize(plan: PlanNode, catalog) -> PlanNode:
    """Semantics-preserving canonicalization applied after optimization:

    * adjacent FilterNodes merge into one whose conjuncts are sorted by
      their (deterministic, value-based) repr — entry points that emitted
      the same predicates in different order converge, and the compiled
      step caches key on one canonical conjunct sequence;
    * identity projections (bare-Col, same names, same order as the child's
      output) are elided;
    * pure-rename projections over an aggregate fold into the aggregate's
      output names (only when the output column order is preserved — a
      reordering projection stays, since result column order is
      observable through the embedding API)."""
    node = plan.with_children(
        tuple(normalize(c, catalog) for c in plan.children))
    if isinstance(node, FilterNode):
        conjs: list[Expr] = []
        inner: PlanNode = node
        while isinstance(inner, FilterNode):
            conjs.extend(split_conjuncts(inner.predicate))
            inner = inner.child
        conjs.sort(key=repr)
        return FilterNode(inner, _conjoin(conjs))
    if isinstance(node, ProjectNode):
        child = node.child
        if all(isinstance(e, Col) and e.name == n for e, n in node.exprs):
            try:
                if [n for _, n in node.exprs] == \
                        list(child.output_columns(catalog)):
                    return child
            except Exception:
                pass
        if isinstance(child, AggregateNode):
            pushed = _push_renames_into_agg(node, child, catalog)
            if pushed is not None:
                return pushed
    return node


# ---------------------------------------------------------------------------
# the costed tier policy — the ONE home of routing thresholds
# ---------------------------------------------------------------------------


@dataclass
class TierPolicy:
    """Every tier-routing threshold in the engine, as one object.

    Plan-time annotation and runtime refinement both go through these
    methods; the executors hold a policy but contain no routing logic of
    their own.  The byte models mirror what the operators actually pin:
    blocking state per row is the key bytes plus ~16 bytes of
    index/gid/bookkeeping overhead."""

    bufman: object = None                 # host BufferManager (or None)
    devman: object = None                 # DeviceBufferManager (or None)

    @classmethod
    def for_db(cls, db) -> "TierPolicy":
        return cls(bufman=getattr(db, "buffer_manager", None),
                   devman=getattr(db, "device_manager", None))

    # -- budgets --------------------------------------------------------------
    @property
    def host_budget(self) -> Optional[int]:
        return None if self.bufman is None else self.bufman.budget

    @property
    def device_budget(self) -> Optional[int]:
        return None if self.devman is None else self.devman.budget

    def over_budget(self, est_bytes: float) -> bool:
        b = self.host_budget
        return b is not None and est_bytes > b

    # -- blocking-operator state models (bytes the op would pin) --------------
    @staticmethod
    def join_state_bytes(n_left: int, n_right: int, key_bytes: int) -> int:
        return (n_left + n_right) * (key_bytes + 16)

    @staticmethod
    def group_state_bytes(n_rows: int, key_bytes: int) -> int:
        return n_rows * (key_bytes + 16)

    @staticmethod
    def sort_state_bytes(n_rows: int, n_keys: int) -> int:
        return n_rows * 8 * (n_keys + 1)

    def blocking_tier(self, est_bytes: float) -> str:
        return TIER_SPILL if self.over_budget(est_bytes) else TIER_IN_MEMORY

    # -- device placement -----------------------------------------------------
    def device_tier(self, geom: ScanAggGeometry, table: str) -> str:
        hits = 0 if self.devman is None else self.devman.hit_history(table)
        return choose_device_tier(
            geom.resident_bytes, geom.batch_bytes, self.device_budget,
            host_budget=self.host_budget, host_bytes=geom.resident_bytes,
            hit_history=hits)


# ---------------------------------------------------------------------------
# the physical plan
# ---------------------------------------------------------------------------


@dataclass
class PhysicalOp:
    """One operator's tier annotation: the decision, the byte estimate it
    was made from, and the budget reservation the tier implies (what the
    operator expects to pin — the whole state in memory, the
    double-buffered batch working set when streaming devices)."""
    node: PlanNode
    tier: str
    est_bytes: int = 0
    reservation: int = 0
    detail: str = ""
    children: tuple = ()

    def lines(self, indent: int = 0) -> list[str]:
        pad = "  " * indent
        extra = f" {self.detail}" if self.detail else ""
        out = [f"{pad}{node_line(self.node)}"
               f" :: {self.tier}"
               f" [est={self.est_bytes}B reserve={self.reservation}B]"
               f"{extra}"]
        for c in self.children:
            out.extend(c.lines(indent + 1))
        return out


@dataclass
class PhysicalPlan:
    """The lowering result every executor consumes."""
    plan: PlanNode                        # normalized logical plan
    policy: TierPolicy
    catalog: object
    scan_agg: Optional[ScanAggSpec] = None
    agg_core: Optional[AggregateNode] = None
    agg_tier: Optional[str] = None        # device-*/parallel-host when set
    suffix_plan: Optional[PlanNode] = None
    geometry: Optional[ScanAggGeometry] = None
    # device sort tier: the ORDER BY suffix node fused onto a device core
    # (sort keys computed + sorted in device memory; only the top rows
    # fetched)
    sort_node: Optional[OrderByNode] = None
    sort_on_device: bool = False
    distributed: bool = False
    # observed group cardinality from a previous execution of this plan
    # shape (serving.PlanCache feedback) — refines the aggregate's
    # annotation with what the runtime actually saw instead of the
    # level-1 row estimate.  Only set when the plan has exactly one
    # aggregate (otherwise the observation is ambiguous).
    group_card_hint: Optional[int] = None
    _reservations: Optional[tuple] = None   # cached total_reservations()

    # -- queries --------------------------------------------------------------
    def device_tier(self) -> bool:
        return self.agg_tier in DEVICE_TIERS

    def total_reservations(self) -> tuple[int, int]:
        """Summed per-operator budget reservations as ``(host_bytes,
        device_bytes)`` — what the admission gate reserves before this plan
        executes.  Each side is capped at its budget: a plan whose
        reservations sum past the budget is exactly what the stream tier
        bounds at runtime, and it must be admissible when alone.  Computed
        once and cached (shallow plan-cache copies share it)."""
        if self._reservations is None:
            host = device = 0

            def visit(op: PhysicalOp):
                nonlocal host, device
                if op.tier in DEVICE_TIERS:
                    device += op.reservation
                else:
                    host += op.reservation
                for c in op.children:
                    visit(c)

            visit(self.annotate())
            hb = self.policy.host_budget
            db = self.policy.device_budget
            if hb is not None:
                host = min(host, hb)
            if db is not None:
                device = min(device, db)
            self._reservations = (int(host), int(device))
        return self._reservations

    def _delta_note(self, node: PlanNode) -> str:
        """Merge-on-read visibility in EXPLAIN: a base-table scan whose
        table carries an uncompacted delta tail says how many rows it will
        merge on read."""
        if not isinstance(node, ScanNode):
            return ""
        t = self.catalog.tables.get(node.table) \
            if hasattr(self.catalog, "tables") else None
        if t is None or not t.delta_rows:
            return ""
        return f"(delta: {t.delta_rows} rows)"

    # -- annotation -----------------------------------------------------------
    def annotate(self) -> PhysicalOp:
        return self._annotate(self.plan)

    def _annotate(self, node: PlanNode) -> PhysicalOp:
        if node is self.agg_core and self.agg_tier in (
                TIER_DEVICE_RESIDENT, TIER_DEVICE_STREAMED):
            return self._annotate_core(node)
        if node is self.sort_node and self.sort_on_device:
            children = tuple(self._annotate(c) for c in node.children)
            est = int(self.policy.sort_state_bytes(
                self.scan_agg.n_groups, len(node.keys)))
            return PhysicalOp(node, TIER_DEVICE_SORT, est, est,
                              "(fused onto device core)", children)
        children = tuple(self._annotate(c) for c in node.children)
        policy = self.policy
        budget = policy.host_budget
        if isinstance(node, JoinNode):
            est = int(policy.join_state_bytes(
                estimate_rows(node.left, self.catalog),
                estimate_rows(node.right, self.catalog),
                8 * len(node.left_keys)))
            tier = policy.blocking_tier(est)
        elif isinstance(node, AggregateNode):
            kb = 8 * max(1, len(node.group_by))
            est = int(policy.group_state_bytes(
                estimate_rows(node.child, self.catalog), kb))
            tier = policy.blocking_tier(est)
            if self.group_card_hint is not None and node.group_by:
                # cardinality feedback (serving.PlanCache): a previous run
                # observed the actual group count
                est = int(policy.group_state_bytes(
                    self.group_card_hint, kb))
        elif isinstance(node, OrderByNode):
            est = int(policy.sort_state_bytes(
                estimate_rows(node.child, self.catalog), len(node.keys)))
            tier = policy.blocking_tier(est)
        else:
            est = int(estimate_rows(node, self.catalog) * 8)
            tier = TIER_IN_MEMORY
        reserve = est if tier == TIER_IN_MEMORY \
            else min(est, budget if budget is not None else est)
        detail = ""
        if isinstance(node, AggregateNode) and node.group_by \
                and self.group_card_hint is not None:
            detail = f"(observed groups={self.group_card_hint})"
        if node is self.agg_core and self.agg_tier == TIER_PARALLEL_HOST:
            # the core matched the device pattern but the planner kept it
            # on the host (not even one batch fits the device budget)
            detail = f"{detail} scan-agg core kept on host".strip()
        dnote = self._delta_note(node)
        if dnote:
            detail = f"{detail} {dnote}".strip()
        return PhysicalOp(node, tier, est, reserve, detail, children)

    def _annotate_core(self, node: PlanNode) -> PhysicalOp:
        """A device-routed scan-agg core: one tier decision covers the
        whole fused subtree (filters and scans execute inside the batch
        step)."""
        g = self.geometry
        if self.agg_tier == TIER_DEVICE_RESIDENT:
            est, reserve = g.resident_bytes, g.resident_bytes
        else:
            est, reserve = g.resident_bytes, 2 * g.batch_bytes
        detail = f"groups={self.scan_agg.n_groups}"
        detail += f" batches={g.n_batches}x{g.batch_rows}rows"

        def fused(n: PlanNode) -> PhysicalOp:
            d = "(fused)"
            dnote = self._delta_note(n)
            if dnote:
                d = f"{d} {dnote}"
            return PhysicalOp(
                n, self.agg_tier, 0, 0, d,
                tuple(fused(c) for c in n.children))

        return PhysicalOp(node, self.agg_tier, int(est), int(reserve),
                          detail, tuple(fused(c) for c in node.children))

    # -- rendering ------------------------------------------------------------
    def render(self) -> str:
        head = "physical plan"
        if self.distributed:
            head += " [distributed]"
        b = self.policy.host_budget
        d = self.policy.device_budget
        head += f" memory_budget={b if b is not None else 'unlimited'}"
        head += f" device_budget={d if d is not None else 'unlimited'}"
        return "\n".join([head] + self.annotate().lines())


# ---------------------------------------------------------------------------
# the lowering pass
# ---------------------------------------------------------------------------


def _walk_nodes(node: PlanNode):
    yield node
    for c in node.children:
        yield from _walk_nodes(c)


def plan_physical(plan: PlanNode, db, *, do_optimize: bool = True,
                  distributed: bool = False,
                  group_card_hint: Optional[int] = None) -> PhysicalPlan:
    """Lower one logical plan to its physical plan: optimize (level 1),
    normalize (entry-point convergence), find the scan-agg core + suffix,
    and annotate tiers.  ``distributed`` enables the device tier on the
    database's one device (shard count 1).  ``group_card_hint`` is an
    observed group cardinality from a previous run of the same plan shape
    (``serving.PlanCache`` feedback); it refines the aggregate annotation
    and only applies when the plan has exactly one aggregate."""
    catalog = db.catalog
    if do_optimize:
        plan = optimize(plan, catalog)
    plan = normalize(plan, catalog)
    policy = TierPolicy.for_db(db)
    phys = PhysicalPlan(plan, policy, catalog, distributed=distributed)
    if group_card_hint is not None:
        n_aggs = sum(isinstance(n, AggregateNode)
                     for n in _walk_nodes(plan))
        if n_aggs == 1:
            phys.group_card_hint = int(group_card_hint)
    if not distributed:
        # the sequential host path never consumes the scan-agg spec, and
        # matching is not free (dense-domain detection scans each group
        # key's min/max) — only the distributed lowering pays for it
        return phys

    core, suffix = find_scan_agg_core(plan, catalog)
    if core is None:
        return phys
    spec = match_scan_agg(core, catalog)
    if spec is None:
        return phys
    phys.agg_core = core
    phys.suffix_plan = suffix
    phys.scan_agg = spec
    table = catalog.table(spec.table)
    if table.num_rows < MIN_ROWS_TO_SHARD:
        return phys
    geom = scan_agg_geometry(spec, table,
                             getattr(db, "device_batch_rows", None))
    phys.geometry = geom
    tier = policy.device_tier(geom, spec.table)
    phys.agg_tier = {"resident": TIER_DEVICE_RESIDENT,
                     "streamed": TIER_DEVICE_STREAMED,
                     "host": TIER_PARALLEL_HOST}[tier]
    # ORDER BY directly over a device-routed core fuses onto the device:
    # sort keys are computed and sorted in device memory, only the
    # surviving rows come back.  Any deeper suffix (projection, HAVING)
    # keeps the host suffix path — the assembled aggregate is tiny there.
    if phys.agg_tier in DEVICE_TIERS and isinstance(plan, OrderByNode) \
            and plan.children[0] is core:
        outputs = set(core.output_columns(catalog))
        if outputs and all(col in outputs for col, _ in plan.keys):
            phys.sort_node = plan
            phys.sort_on_device = True
    return phys
