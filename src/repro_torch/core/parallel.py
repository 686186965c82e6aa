"""Device-tier execution on one CUDA card (paper Fig. 2: per-chunk partial
aggregates merged by an order-fixed carry).

* ``DistributedScanAgg`` — the device tier for the hot OLAP pattern
  Aggregate(Filter*(Scan)) with dense group domains: it streams
  morsel-sized column batches through the budgeted block cache
  (``device_cache.DeviceBufferManager``) and merges per-batch raw partials
  with an order-fixed carry, so the query runs on a device whose memory is
  smaller than the table.  The batch decomposition is *independent of the
  device budget* — unbudgeted, generous and tight budgets all execute the
  identical sequence of batch steps, and the kernels are deterministic, so
  results are bit-identical across budgets and only the transfer/caching
  behaviour differs (resident: blocks stay cached across queries;
  streamed: LRU eviction recycles them, double-buffered prefetch overlaps
  the next batch's host→device copy with the current batch's step).
* ``DistributedJoinAgg`` — the device join tier for Aggregate(inner-join
  tree) (TPC-H Q3): dense build tables are built bottom-up from their own
  batch streams, then the probe table streams through the scan-agg carry
  loop with presence gating against every probe-adjacent table, and the
  grouped result is assembled (and sorted) in device memory.
* ``ParallelExecutor`` — Executor subclass that consumes the physical plan
  (``physplan.plan_physical``): a core annotated device-resident /
  device-streamed / device-join runs through the classes above, a
  host-side suffix (ORDER BY / LIMIT / projection / HAVING) executes over
  the assembled aggregate unless the sort was fused onto the device, and
  everything else goes to the sequential host program.

Each batch step is float64 torch operations around hand-written kernel
launches.  A scan-agg step takes every sum-like partial (``cnt_star``,
per-aggregate counts, sums for sum/avg, in ``partial_layout`` order) from
ONE kernel, on a route fixed when the step is built, from the spec and the
table version:

* ``scan_agg`` (``kernels/scan_agg``): no GROUP BY, every conjunct a simple
  range on a numeric column, every sum/avg a column or a product of two
  columns, no NULL in any referenced column — TPC-H Q6;
* ``hash_group`` (``kernels/hash_group``): every other spec, with masked
  rows sent to the trash group ``n_groups`` — TPC-H Q1.

The join tier's steps take ``radix_probe`` (``kernels/radix_join``) for
every presence gate and ``radix_build`` for the build tables and for the
probe's grouped partials, whose group domain (the orders key domain, 1.5M
at SF 1) is far past what ``hash_group`` takes.  Device assembly gathers
the group build's payload with ``radix_probe`` and sorts with the bitonic
``sort`` kernel (``kernels/sort``).  min/max partials stay torch
``scatter_reduce`` (the reference computes them outside any kernel too).

Imprint data skipping (``physplan.SkipSet``): every stream — the scan-agg
batch stream and the join tier's build and probe streams — drops the
batches whose imprint blocks all fail a filter conjunct (never built,
never uploaded, never stepped), and uploads only the candidate slots of a
boundary batch (the gathered layout), which the step expands back to the
full batch, every row at its batch position and the filler rows invalid,
before any kernel runs.  The kernels therefore see the same tiles with the
same rows either way, and results are bit-identical with skipping on and
off.

Nothing on the device path catches an exception: a build, launch or kernel
failure propagates to the caller.  Two outcomes put a query on the host
tier: the planner's plan-time decision (``"host"``), and the device join's
duplicate-build-key witness (``_DeviceJoinFallback``), a data precondition
the host join handles.
"""

from __future__ import annotations

import math
import threading
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..kernels.hash_group.kernel import hash_group
from ..kernels.radix_join.kernel import radix_build, radix_probe
from ..kernels.scan_agg.kernel import MAX_COLS, MAX_PAIRS, scan_agg
from ..kernels.sort.ops import lexsort
from .device_cache import (DeviceBlockKeys, DeviceBudgetError,
                           DeviceBufferManager)
from .executor import Executor, compile_plan
from .expression import (BinOp, Col, EvalContext, Expr, ExprResult,
                         TorchNamespace, descale)
from .physplan import (AGG_RESULT_NAME, DeviceBuild, JoinAggSpec,
                       PhysicalPlan, ScanAggSpec, SkipSet,
                       TIER_DEVICE_RESIDENT, _simple_range,
                       choose_device_tier, partial_layout, scan_agg_geometry)
from .relalg import PlanNode
from .types import DBType, NULL_SENTINEL

# column types whose decoded float64 value the scan_agg route compares
_RANGE_TYPES = (DBType.INT32, DBType.INT64, DBType.DATE, DBType.DECIMAL,
                DBType.FLOAT32, DBType.FLOAT64)


# ---------------------------------------------------------------------------
# kernel route (fixed at step-build time)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ScanAggRoute:
    """Static inputs of the ``scan_agg`` kernel route: the kernel's column
    order, each column's inclusive float64 bounds, the (a, b) column pairs
    of the sum/avg aggregates in aggregate order, and for every sum-like
    column of ``partial_layout`` the kernel output it reads (P = count)."""
    columns: tuple
    bounds: tuple                # ((lo, hi), ...) per column
    pairs: tuple                 # ((a, b), ...), b == -1: column a alone
    out_index: tuple             # per sum-like partial column


def _inclusive(lo: float, hi: float, lo_strict: bool, hi_strict: bool):
    """Strict bounds as inclusive float64 bounds, exactly: the engine
    compares the column's decoded float64 value (``ExprResult.as_float``)
    with the literal, and x > v  <=>  x >= nextafter(v, +inf) in float64."""
    if lo_strict:
        lo = float(np.nextafter(lo, np.inf))
    if hi_strict:
        hi = float(np.nextafter(hi, -np.inf))
    return lo, hi


def scan_agg_route(spec: ScanAggSpec, table) -> Optional[ScanAggRoute]:
    """The ``scan_agg`` route's static inputs, or None when the spec takes
    the ``hash_group`` route."""
    if spec.group_keys:
        return None
    bounds: dict = {}
    for conj in spec.conjuncts:
        rng = _simple_range(conj)
        if rng is None:
            return None
        name, lo, hi, lo_s, hi_s = rng
        if table.column(name).dbtype not in _RANGE_TYPES:
            return None
        lo, hi = _inclusive(lo, hi, lo_s, hi_s)
        plo, phi = bounds.get(name, (-np.inf, np.inf))
        bounds[name] = (max(plo, lo), min(phi, hi))
    operands = []
    for a in spec.aggs:
        if a.fn not in ("sum", "avg"):
            continue
        e = a.expr
        if isinstance(e, Col):
            operands.append((e.name, None))
        elif isinstance(e, BinOp) and e.op == "*" \
                and isinstance(e.left, Col) and isinstance(e.right, Col):
            operands.append((e.left.name, e.right.name))
        else:
            return None
    cols = set(bounds) | {c for pair in operands for c in pair
                          if c is not None}
    for c in spec.columns:
        col = table.column(c)
        if col.dbtype not in _RANGE_TYPES or col.has_nulls():
            return None
    order = tuple(sorted(cols))
    if not 1 <= len(order) <= MAX_COLS or len(operands) > MAX_PAIRS:
        return None
    pos = {c: i for i, c in enumerate(order)}
    pairs = tuple((pos[x], -1 if y is None else pos[y]) for x, y in operands)
    count = len(pairs)
    out_index = [count]                              # cnt_star
    p = 0
    for a in spec.aggs:
        if a.expr is None:
            continue
        out_index.append(count)                      # per-agg count
        if a.fn in ("sum", "avg"):
            out_index.append(p)
            p += 1
    return ScanAggRoute(order,
                        tuple(bounds.get(c, (-np.inf, np.inf))
                              for c in order),
                        pairs, tuple(out_index))


# ---------------------------------------------------------------------------
# the per-batch fragment (torch operations around one kernel launch)
# ---------------------------------------------------------------------------


def _eval_torch(expr: Expr, arrays: dict, meta: dict, xp) -> ExprResult:
    return expr.eval(EvalContext(arrays, meta, xp=xp))


def _conjunct_mask(conjuncts, arrays: dict, meta: dict, valid, xp):
    """``valid`` AND every conjunct (a NULL conjunct value is false)."""
    mask = valid
    for conj in conjuncts:
        r = _eval_torch(conj, arrays, meta, xp)
        m = r.values != 0
        if r.null is not None:
            m = m & ~r.null
        mask = mask & m
    return mask


def _fragment_mask_gid(spec: ScanAggSpec, meta: dict, valid, arrays, xp):
    """The filter mask and the dense mixed-radix gid (torch operations).
    The key code is clamped into its domain in float64 before the int32
    narrowing, which is what the reference's cast-then-clip computes for
    every in-domain key."""
    mask = _conjunct_mask(spec.conjuncts, arrays, meta, valid, xp)
    gid = torch.zeros(valid.shape, dtype=torch.int32, device=valid.device)
    for k, (off, card) in zip(spec.group_keys, spec.key_domains):
        t, _heap, _scale = meta[k]
        kv = arrays[k].to(torch.float64)
        if t != DBType.VARCHAR:
            kv = kv - off
        code = torch.clamp(kv, 0, card - 1).to(torch.int32)
        gid = gid * card + code
    return mask, gid


def _minmax_partials(spec: ScanAggSpec, evals: dict, gid):
    """min/max partials per group: torch ``scatter_reduce`` (amin/amax)
    over the rows' values, +inf/-inf where a row is masked or NULL."""
    extras = {}
    idx = gid.to(torch.int64)
    for i, fn, _cnt, out_col in partial_layout(spec).minmax:
        ok, f = evals[i]
        big = np.inf if fn == "min" else -np.inf
        init = torch.full((spec.n_groups,), big, dtype=torch.float64,
                          device=gid.device)
        extras[out_col] = init.scatter_reduce(
            0, idx, torch.where(ok, f, big),
            "amin" if fn == "min" else "amax", include_self=True)
    return extras


def _grouped_partials(spec: ScanAggSpec, meta: dict, mask, gid, arrays, xp,
                      group_sum):
    """Stack the sum-like value columns and sum them per group in one
    launch of ``group_sum`` (``hash_group`` or ``radix_build``: the same
    function of (code, vals, n_groups)), masked rows sent to the trash code
    ``n_groups``; then the min/max partials.  Returns the raw partial
    matrix in ``partial_layout`` order."""
    sum_cols = [mask.to(torch.float64)]               # cnt_star
    evals = {}
    for i, a in enumerate(spec.aggs):
        if a.expr is None:
            continue
        r = _eval_torch(a.expr, arrays, meta, xp)
        ok = mask if r.null is None else (mask & ~r.null)
        f = r.as_float(xp)
        evals[i] = (ok, f)
        sum_cols.append(ok.to(torch.float64))         # per-agg count
        if a.fn in ("sum", "avg"):
            sum_cols.append(torch.where(ok, f, 0.0))
    vals = torch.stack(sum_cols)                      # (n_sum, rows)
    trash = torch.where(mask, gid, spec.n_groups).to(torch.int32)
    seg = group_sum(trash, vals, spec.n_groups)       # (n_groups, n_sum)
    extras = _minmax_partials(spec, evals, gid)
    if not extras:
        return seg
    return torch.cat([seg] + [extras[c][:, None] for c in sorted(extras)],
                     dim=1)


def _as_float(values, meta_entry, xp):
    t, heap, scale = meta_entry
    return ExprResult(values, t, None, heap, scale).as_float(xp)


def make_partial_fragment(spec: ScanAggSpec, meta: dict, device,
                          route: Optional[ScanAggRoute]):
    """The per-batch function ``fragment(valid, *cols) -> (n_groups, K)``
    returning *mergeable* raw partials in ``partial_layout`` order (the
    finalization happens once, after the carry merged every batch)."""
    xp = TorchNamespace(device)
    if route is None:
        def fragment(valid, *cols):
            arrays = dict(zip(spec.columns, cols))
            mask, gid = _fragment_mask_gid(spec, meta, valid, arrays, xp)
            return _grouped_partials(spec, meta, mask, gid, arrays, xp,
                                     hash_group)
        return fragment

    lo = torch.tensor([b[0] for b in route.bounds], dtype=torch.float64,
                      device=device)
    hi = torch.tensor([b[1] for b in route.bounds], dtype=torch.float64,
                      device=device)
    pairs = torch.tensor(route.pairs, dtype=torch.int32,
                         device=device).reshape(-1, 2)
    take = torch.tensor(route.out_index, dtype=torch.int64, device=device)
    minmax = bool(partial_layout(spec).minmax)

    def fragment(valid, *cols):
        arrays = dict(zip(spec.columns, cols))
        stacked = torch.stack([_as_float(arrays[c], meta[c], xp)
                               for c in route.columns])
        out = scan_agg(stacked, lo, hi, valid, pairs)     # (P + 1,)
        seg = out[take][None, :]                          # (1, n_sum)
        if not minmax:
            return seg
        # min/max aggregates read the mask too (torch operations)
        mask, gid = _fragment_mask_gid(spec, meta, valid, arrays, xp)
        evals = {}
        for i, a in enumerate(spec.aggs):
            if a.fn in ("min", "max"):
                evals[i] = (mask, _eval_torch(a.expr, arrays, meta,
                                              xp).as_float(xp))
        extras = _minmax_partials(spec, evals, gid)
        return torch.cat(
            [seg] + [extras[c][:, None] for c in sorted(extras)], dim=1)

    return fragment


def finalize_partials(spec: ScanAggSpec, partial: np.ndarray) -> np.ndarray:
    """Merged raw partials -> the (n_groups, n_aggs + 1) matrix
    ``_assemble`` consumes (avg ratios, NULL where a group saw no valid
    rows)."""
    layout = partial_layout(spec)
    cnt_star = partial[:, 0]
    outs = {}
    for i, kind, cnt_col, val_col in layout.plans:
        if kind == "count_star":
            outs[i] = cnt_star
        elif kind == "count":
            outs[i] = partial[:, cnt_col]
        else:
            cnt = partial[:, cnt_col]
            v = partial[:, val_col]
            outs[i] = np.where(
                cnt > 0,
                v if kind == "sum" else v / np.maximum(cnt, 1.0),
                np.nan)
    for i, _fn, cnt_col, out_col in layout.minmax:
        outs[i] = np.where(partial[:, cnt_col] > 0, partial[:, out_col],
                           np.nan)
    cols = [outs[i] for i in range(len(spec.aggs))] + [cnt_star]
    return np.stack(cols, axis=1)


def _gather_expand(gather, inv, valid, cols):
    """Rebuild a batch's full rows from its gathered (compact) slots.
    ``gather = (ublock, L)``: the batch is ``L`` slots of ``ublock`` rows.
    ``inv`` maps each slot to its position among the ``q`` uploaded
    candidate slots (-1 = not uploaded).  Filler rows get ``valid =
    False`` and zero values, which is the state the full upload's rows
    reach after masking: zone-map soundness guarantees a
    non-candidate slot's rows all fail some conjunct, and a masked row
    contributes the combine identity whatever its values.  Every row keeps
    its batch position, so each kernel sums the same tiles in the same
    order as on the full batch — bit-identical partials."""
    ublock, n_slots = gather
    q = valid.shape[0] // ublock
    hit = (inv >= 0)[:, None]
    idx = inv.clamp(0, q - 1).to(torch.int64)

    def expand(comp, fill):
        rows = comp.reshape(q, ublock)[idx]
        return torch.where(hit, rows, fill).reshape(n_slots * ublock)

    return expand(valid, False), [expand(c, 0) for c in cols]


def _gathered(step, gather, n_lead: int):
    """The gathered variant of a batch step: ``step(*lead, valid, *cols)``
    becomes ``step(*lead, inv, valid_compact, *cols_compact)`` (the block
    order of a gathered batch, ``#ginv`` first), expanding the batch on
    the device before the step runs.  ``gather`` None: the step itself."""
    if gather is None:
        return step

    def gstep(*args):
        lead, (inv, valid), cols = (args[:n_lead],
                                    args[n_lead:n_lead + 2],
                                    args[n_lead + 2:])
        valid, full = _gather_expand(gather, inv, valid, cols)
        return step(*lead, valid, *full)

    return gstep


def build_batch_step(spec: ScanAggSpec, meta: dict, device,
                     route: Optional[ScanAggRoute], gather=None):
    """(init_fn, step_fn): ``step(carry, valid, *cols) -> carry'`` — the
    partial fragment plus the carry combine (add / min / max per column),
    out of place.  ``init_fn`` materializes the combine identity on the
    device.  With ``gather = (ublock, L)`` (intra-batch skipping) the step
    takes ``step(carry, inv, valid_compact, *cols_compact)``."""
    layout = partial_layout(spec)
    frag = make_partial_fragment(spec, meta, device, route)
    kinds = torch.as_tensor(layout.kinds, device=device)
    identity = torch.as_tensor(layout.init, device=device)
    g, k = spec.n_groups, len(layout.kinds)

    def step(carry, *args):
        return _combine(kinds, carry, frag(*args))

    def init():
        return identity.expand(g, k).clone()

    return init, _gathered(step, gather, 1)


def _combine(kinds, carry, part):
    """The carry merge, out of place: add / min / max per column (``kinds``
    0 / 1 / 2, from ``partial_layout``)."""
    return torch.where(kinds == 0, carry + part,
                       torch.where(kinds == 1, torch.minimum(carry, part),
                                   torch.maximum(carry, part)))


_STEP_CACHE: dict = {}
# concurrent queries may race to build the same step; the lock makes the
# check-then-build atomic so one step is built and shared
_STEP_CACHE_LOCK = threading.Lock()

# ONE device dispatch at a time: the whole batch loop of a query holds it,
# so the launches of concurrent device queries never interleave on the
# card's compute stream (parity with the reference engine, whose collective
# steps deadlock when dispatched concurrently).  Host-tier queries are
# unaffected and still run concurrently.
_DEVICE_DISPATCH_LOCK = threading.Lock()


def _meta_key(columns, meta: dict) -> tuple:
    """The step-relevant identity of each referenced column: dtype, scale
    and — for VARCHAR — the heap content fingerprint (string literal codes
    are resolved against the heap when the step evaluates a predicate)."""
    out = []
    for c in columns:
        t, heap, scale = meta[c]
        out.append((c, t, scale,
                    heap.fingerprint() if heap is not None else None))
    return tuple(out)


def _cached_batch_step(spec: ScanAggSpec, meta: dict, device,
                       batch_rows: int, route: Optional[ScanAggRoute],
                       gather=None):
    key = ("batch", spec.table, repr(spec.conjuncts),
           tuple(spec.group_keys),
           tuple(spec.key_domains),     # a shifted key domain must not
                                        # reuse a stale step
           tuple((a.fn, repr(a.expr)) for a in spec.aggs),
           _meta_key(spec.columns, meta),
           spec.n_groups, batch_rows, str(device), route, gather)
    with _STEP_CACHE_LOCK:
        if key not in _STEP_CACHE:
            _STEP_CACHE[key] = build_batch_step(spec, meta, device, route,
                                                gather=gather)
        return _STEP_CACHE[key]


# ---------------------------------------------------------------------------
# device join tier: build / probe steps (torch operations around radix_join)
# ---------------------------------------------------------------------------


def _join_edge_mask(arrays, meta: dict, mask, edge_cols, domains, btabs):
    """Probe-side join gating: for each equi-join edge, exclude rows whose
    local key is NULL, outside the build's dense domain, or absent from
    the build table (presence lane 0 == 0, read by one ``radix_probe``
    launch).  The domain comparison runs in float64 *before* the int32
    narrowing — an out-of-domain key must never alias an in-domain code;
    it gets the code -1, which the probe reads as a miss."""
    for cname, (off, card), btab in zip(edge_cols, domains, btabs):
        kv = arrays[cname]
        sent = NULL_SENTINEL[meta[cname][0]]
        codef = kv.to(torch.float64) - off
        ok = (kv != sent) & (codef >= 0) & (codef < card)
        code = torch.where(ok, codef, -1.0).to(torch.int32)
        mask = mask & (radix_probe(code, btab)[:, 0] > 0)
    return mask


def build_join_build_step(build: DeviceBuild, meta: dict, device,
                          child_domains, gather=None):
    """(init_fn, step_fn) for one join build table:
    ``step(btab, child_btabs, valid, *cols) -> btab'`` (with ``gather``:
    ``step(btab, child_btabs, inv, valid_compact, *cols_compact)``).

    One batch of the build table's stream is filtered (its own conjuncts +
    NULL/domain/presence gating against already-built child tables) and
    scatter-added into the (card, 1 + n_payload) build matrix by one
    ``radix_build`` launch: lane 0 counts presence (the runtime uniqueness
    witness — any slot > 1 means duplicate build keys and the query falls
    back to the host join), the payload lanes hold the build's group-key
    columns as float64 (unique keys make the add a set; the integer-coded
    payload types decode exactly).  Masked rows take the trash code
    ``card``.  All-add combine: the same carry idiom as the scan-agg tier,
    so dirty-writeback/eviction compose unchanged."""
    off, card = build.domain
    width = 1 + len(build.payload)
    edge_cols = [c for _, c in build.probe_edges]
    xp = TorchNamespace(device)

    def step(btab, child_btabs, valid, *cols):
        arrays = dict(zip(build.columns, cols))
        mask = _conjunct_mask(build.conjuncts, arrays, meta, valid, xp)
        kv = arrays[build.key]
        sent = NULL_SENTINEL[meta[build.key][0]]
        codef = kv.to(torch.float64) - off
        mask = mask & (kv != sent) & (codef >= 0) & (codef < card)
        mask = _join_edge_mask(arrays, meta, mask, edge_cols,
                               child_domains, child_btabs)
        lanes = [mask.to(torch.float64)]
        for p in build.payload:
            lanes.append(torch.where(mask, arrays[p].to(torch.float64),
                                     0.0))
        code = torch.where(mask, codef, float(card)).to(torch.int32)
        return btab + radix_build(code, torch.stack(lanes), card)

    def init():
        return torch.zeros((card, width), dtype=torch.float64,
                           device=device)

    return init, _gathered(step, gather, 2)


def _cached_join_build_step(build: DeviceBuild, meta: dict, device,
                            batch_rows: int, child_domains, gather=None):
    key = ("jbuild", build.table, repr(build.conjuncts), build.key,
           build.domain, tuple(build.payload), tuple(build.probe_edges),
           tuple(child_domains), _meta_key(build.columns, meta),
           batch_rows, str(device), gather)
    with _STEP_CACHE_LOCK:
        if key not in _STEP_CACHE:
            _STEP_CACHE[key] = build_join_build_step(
                build, meta, device, child_domains, gather=gather)
        return _STEP_CACHE[key]


def build_join_probe_step(spec: JoinAggSpec, meta: dict, device,
                          gather=None):
    """(init_fn, step_fn) for the probe (fact) side of a device join:
    ``step(carry, edge_btabs, valid, *cols) -> carry'`` (with ``gather``:
    ``step(carry, edge_btabs, inv, valid_compact, *cols_compact)``).

    The probe phase IS the scan-agg batch step over the probe table —
    identical prologue, partials and carry combine — plus presence gating
    through every probe-adjacent build matrix.  The gid is the group
    build's key code; rows with NULL / out-of-domain / unmatched keys are
    masked and contribute the combine identity.  The route is fixed here:
    the sum-like partials take ``radix_build``, because the group domain
    is the build key's (1.5M codes for Q3 at SF 1), far past the
    ``hash_group`` cap."""
    pspec = spec.probe_spec()
    layout = partial_layout(pspec)
    domains = [spec.builds[bi].domain for bi, _ in spec.probe_edges]
    edge_cols = [c for _, c in spec.probe_edges]
    xp = TorchNamespace(device)
    kinds = torch.as_tensor(layout.kinds, device=device)
    identity = torch.as_tensor(layout.init, device=device)
    g, k = pspec.n_groups, len(layout.kinds)

    def step(carry, edge_btabs, valid, *cols):
        arrays = dict(zip(pspec.columns, cols))
        mask, gid = _fragment_mask_gid(pspec, meta, valid, arrays, xp)
        mask = _join_edge_mask(arrays, meta, mask, edge_cols, domains,
                               edge_btabs)
        part = _grouped_partials(pspec, meta, mask, gid, arrays, xp,
                                 radix_build)
        return _combine(kinds, carry, part)

    def init():
        return identity.expand(g, k).clone()

    return init, _gathered(step, gather, 2)


def _cached_join_probe_step(spec: JoinAggSpec, meta: dict, device,
                            batch_rows: int, gather=None):
    pspec = spec.probe_spec()
    key = ("jprobe", spec.probe_table, repr(pspec.conjuncts),
           tuple(pspec.group_keys), tuple(pspec.key_domains),
           tuple((a.fn, repr(a.expr)) for a in pspec.aggs),
           tuple(spec.probe_edges),
           tuple(b.domain for b in spec.builds),
           _meta_key(pspec.columns, meta), pspec.n_groups,
           batch_rows, str(device), gather)
    with _STEP_CACHE_LOCK:
        if key not in _STEP_CACHE:
            _STEP_CACHE[key] = build_join_probe_step(spec, meta, device,
                                                     gather=gather)
        return _STEP_CACHE[key]


def _dupmax(btab) -> float:
    """The largest presence count of a build matrix: the uniqueness
    witness the device join's soundness rests on (> 1 means a duplicate
    build key)."""
    return float(btab[:, 0].max())


# ---------------------------------------------------------------------------
# device-resident assembly (the fused ORDER BY of Q1 and Q3)
# ---------------------------------------------------------------------------


def _finalize_rows_torch(spec: ScanAggSpec, carry):
    """Device mirror of ``finalize_partials`` — identical formulas, torch
    operations — used by the device-resident assembly step."""
    layout = partial_layout(spec)
    cnt_star = carry[:, 0]
    nan = torch.tensor(np.nan, dtype=torch.float64, device=carry.device)
    outs = {}
    for i, kind, cnt_col, val_col in layout.plans:
        if kind == "count_star":
            outs[i] = cnt_star
        elif kind == "count":
            outs[i] = carry[:, cnt_col]
        else:
            cnt = carry[:, cnt_col]
            v = carry[:, val_col]
            outs[i] = torch.where(
                cnt > 0,
                v if kind == "sum" else v / torch.clamp_min(cnt, 1.0),
                nan)
    for i, _fn, cnt_col, out_col in layout.minmax:
        outs[i] = torch.where(carry[:, cnt_col] > 0, carry[:, out_col], nan)
    cols = [outs[i] for i in range(len(spec.aggs))] + [cnt_star]
    return torch.stack(cols, dim=1)


def _device_sort_key(v, dbt, scale: int, desc: bool):
    """Device mirror of ``executor._sort_key_float`` over a float64 copy
    of an assembled output column — identical arithmetic, so the sort
    permutation is identical to the host suffix sort's."""
    v = v.to(torch.float64)
    if dbt == DBType.VARCHAR:
        k, nulls = v, v == 0
    elif dbt == DBType.DECIMAL:
        k = descale(v, scale)
        nulls = v == float(NULL_SENTINEL[dbt])
    elif dbt in (DBType.FLOAT64, DBType.FLOAT32):
        k, nulls = v, torch.isnan(v)
    else:
        k, nulls = v, v == float(NULL_SENTINEL[dbt])
    return torch.where(nulls, np.inf, -k if desc else k)


def build_assemble_step(spec: ScanAggSpec, sort_cols, limit,
                        n_payload: int):
    """Device-resident assembly: finalize the carry, compact it to the
    non-empty groups, gather the group build's payload lanes (one
    ``radix_probe`` launch on the compacted gids) and — when an ORDER BY
    suffix was fused — compute the float sort keys and the
    (top-``limit``) sort permutation (``sort`` kernel launches), all in
    device memory.  Only the compacted (and sorted) rows are fetched to
    host.

    ``sort_cols`` is a tuple of ``(source, dbtype, scale, desc)`` where
    ``source`` is ``("digit", i)`` (mixed-radix group-key digit — for the
    join tier the single digit IS the build key code), ``("payload", j)``
    (a build payload lane) or ``("agg", i)``.  Returns
    ``(gids, finalized_rows, payload_rows)``."""
    doms = spec.key_domains

    def assemble(carry, btab=None):
        final = _finalize_rows_torch(spec, carry)
        if spec.group_keys:
            gids = torch.nonzero(carry[:, 0] > 0)[:, 0]
        else:
            gids = torch.zeros(1, dtype=torch.int64, device=carry.device)
        compact = final[gids]
        if n_payload:
            pay = radix_probe(gids.to(torch.int32), btab)[:, 1:]
        else:
            pay = torch.zeros((gids.shape[0], 0), dtype=torch.float64,
                              device=carry.device)
        if sort_cols:
            rem = gids
            digits = []
            for off, card in reversed(doms):
                digits.append(rem % card)
                rem = rem // card
            digits.reverse()
            fkeys = []
            for (src, dbt, scale, desc) in sort_cols:
                if src[0] == "digit":
                    i = src[1]
                    v = digits[i].to(torch.float64)
                    if dbt != DBType.VARCHAR:
                        v = v + doms[i][0]
                elif src[0] == "payload":
                    v = pay[:, src[1]]
                else:
                    v = compact[:, src[1]]
                fkeys.append(_device_sort_key(v, dbt, scale, desc))
            perm = lexsort(fkeys, limit)
            gids, compact, pay = gids[perm], compact[perm], pay[perm]
        return gids, compact, pay

    return assemble


def _cached_assemble_step(spec: ScanAggSpec, sort_cols, limit,
                          n_payload: int, device):
    key = ("assemble", spec.table, tuple(spec.group_keys),
           tuple(spec.key_domains),
           tuple((a.fn, repr(a.expr)) for a in spec.aggs),
           spec.n_groups, sort_cols, limit, n_payload, str(device))
    with _STEP_CACHE_LOCK:
        if key not in _STEP_CACHE:
            _STEP_CACHE[key] = build_assemble_step(spec, sort_cols, limit,
                                                   n_payload)
        return _STEP_CACHE[key]


# requires-lock: _DEVICE_DISPATCH_LOCK
def _assemble_on_device(plan: tuple, device, carry, btab=None):
    """Device-resident assembly dispatch: run the finalize / compact /
    payload-gather / fused-sort step and fetch only the surviving rows.
    ``plan`` is ``(spec, sort_cols, limit, n_payload)`` — data, not a
    closure, so the dispatch stays inside the lock-annotated call
    graph."""
    pspec, sort_cols, limit, n_payload = plan
    fn = _cached_assemble_step(pspec, tuple(sort_cols), limit, n_payload,
                               device)
    gids, vals, pay = fn(carry, btab)
    return gids.cpu().numpy(), vals.cpu().numpy(), pay.cpu().numpy()


# ---------------------------------------------------------------------------
# the streamed device scan-agg
# ---------------------------------------------------------------------------


class DistributedScanAgg:
    """Streamed device-tier execution of one Aggregate(Filter*(Scan)).

    The table's rows are cut into fixed-size batches (``batch_rows``; NOT
    derived from the budget — identical batching across budgets is what
    makes the budget matrix bit-identical).  Each (column, batch) block
    flows through the ``DeviceBufferManager``:

    * resident tier: every block fits the budget at once; after the first
      query all blocks are cache hits and no host→device bytes move;
    * streamed tier: only batches fit; blocks of consumed batches are
      LRU-evicted to make room, and batch N+1's copies are issued on the
      side stream before batch N's step, so copy and compute overlap; the
      step waits on each block's copy event (``DeviceBufferManager.ready``)
      and the final host fetch of the carry is the fence.

    The merge carry (a dirty intermediate block) may itself be evicted
    under a tight budget: it is copied back to host and transparently
    re-uploaded — the only writeback case, since base-column blocks are
    clean by definition.

    An imprint skip-set (``physplan.SkipSet``) cuts the stream to its live
    batches and gathers the candidate slots of boundary batches."""

    def __init__(self, db, spec: ScanAggSpec,
                 batch_rows: Optional[int] = None,
                 skip_set: Optional[SkipSet] = None):
        self.db = db
        self.spec = spec
        self.devman: DeviceBufferManager = db.device_manager
        self.device = self.devman.device
        self.table = db.catalog.table(spec.table)
        self.n_rows = self.table.num_rows
        # transaction snapshots run under a unique key namespace: their
        # tables reuse the version number the next committed write gets,
        # so bare versions would let rolled-back rows alias committed ones
        self._key_ns = getattr(db, "device_key_namespace", 0)
        # delta geometry (base tables report delta_rows == 0): batches that
        # lie fully inside the immutable base are keyed by base_version only
        # and so survive appends; tail-overlapping batches carry the delta
        # epoch and are the only entries an append invalidates
        self.base_rows = self.table.base_rows
        self.delta_rows = self.table.delta_rows
        self.base_version_key = (self._key_ns, "b", self.table.base_version)
        self.delta_version_key = (self._key_ns, "d", self.table.base_version,
                                  self.table.delta_epoch)
        # batch decomposition + byte footprint come from the physical
        # planner's shared geometry model
        geom = scan_agg_geometry(spec, self.table, batch_rows)
        self.batch_rows = geom.batch_rows
        self.n_batches = geom.n_batches
        self.row_bytes = geom.row_bytes
        self.carry_nbytes = geom.carry_nbytes
        self.batch_bytes = geom.batch_bytes
        self.resident_bytes = geom.resident_bytes
        # imprint-derived skip-set: intersected with the batch geometry so
        # non-qualifying batches are never built, never prefetched and
        # never uploaded.  Execution-time re-validation: a skip-set derived
        # against another table version (an append raced the lowering) is
        # discarded, not half-trusted.
        if skip_set is not None and not skip_set.valid_for(self.table):
            skip_set = None
        self.skip_set = skip_set
        m = self.batch_rows
        self.live_batches = [
            b for b in range(self.n_batches)
            if skip_set is None or skip_set.batch_qualifies(
                b * m, min(self.n_rows, b * m + m))]
        # intra-batch skipping (gather): a boundary batch — one the zone
        # maps could not skip whole — usually still holds non-candidate
        # imprint blocks.  Cut the batch into L skip-aligned slots of
        # ``ublock`` rows and upload only its q candidate slots plus an
        # (L,) int32 inverse map; the step rebuilds the full rows on the
        # device (``_gather_expand``).  A batch whose every slot qualifies
        # keeps the full layout.  The reference pads q to one power of two
        # for every gathered batch, so that one jitted trace serves them
        # all; eager torch has no trace to share, so each batch uploads
        # exactly its own candidate slots (with the shared q, date-sorted
        # TPC-H at SF 1 gathers no batch: ROADMAP.md §4).  One card:
        # shard count 1.
        self.gather = None
        self._gather_sel: dict = {}
        if skip_set is not None and self.live_batches:
            ublock = math.gcd(skip_set.block, m)
            L = m // ublock
            for b in self.live_batches:
                s0 = b * m
                e = min(self.n_rows, s0 + m)
                sel = tuple(
                    slot for slot in range(L)
                    if skip_set.batch_qualifies(
                        s0 + slot * ublock,
                        min(s0 + slot * ublock + ublock, e)))
                if len(sel) < L:              # this batch has gaps: gather
                    self._gather_sel[b] = sel
            if self._gather_sel:
                self.gather = (ublock, L)
        self.meta = {}
        for c in spec.columns:
            col = self.table.column(c)
            self.meta[c] = (col.dbtype, col.heap, col.scale)
        # the kernel route is fixed here, from the spec and this version
        self.route = scan_agg_route(spec, self.table)

    # -- placement decision ---------------------------------------------------
    def choose_tier(self) -> str:
        return choose_device_tier(
            self.resident_bytes, self.batch_bytes, self.devman.budget,
            hit_history=self.devman.hit_history(self.spec.table))

    # -- block builders -------------------------------------------------------
    def _builders(self, b: int):
        """Yield (cache key, host-build thunk) for batch ``b``'s blocks:
        the valid mask first, then every referenced column, each padded to
        exactly ``batch_rows`` rows.  The shard component of the key is
        ``(device, batch_rows, b)``: a different ``device_batch_rows`` cuts
        different row ranges, so a bare batch index would serve the wrong
        rows as a cache hit.  A gathered batch yields its ``#ginv`` map
        first, then the valid mask and the columns of its candidate slots
        (``ublock`` rows each); the selection joins the shard key, so two
        queries whose conjuncts pick different slots never alias blocks."""
        spec, table = self.spec, self.table
        m = self.batch_rows
        s = b * m
        e = min(self.n_rows, s + m)
        vkey = self._batch_version_key(b)
        if b in self._gather_sel:
            yield from self._gathered_builders(b, s, e, vkey)
            return
        shard = (str(self.device), m, b)

        def bvalid():
            a = np.zeros(m, dtype=bool)
            a[:e - s] = True
            return a

        yield DeviceBlockKeys.valid(spec.table, vkey, shard), bvalid
        for c in spec.columns:
            col = table.column(c)

            def bcol(col=col):
                a = np.zeros(m, dtype=col.data.dtype)
                a[:e - s] = col.data[s:e]
                return a

            yield (DeviceBlockKeys.column(spec.table, c, vkey, shard),
                   bcol)

    def _gathered_builders(self, b: int, s: int, e: int, vkey):
        ublock, L = self.gather
        sel = self._gather_sel[b]
        q = len(sel)
        table = self.spec.table
        shard = (str(self.device), self.batch_rows, b, "g", sel)

        def rows(slot):                 # (first row, real rows) of a slot
            ss = s + slot * ublock
            return ss, max(0, min(ss + ublock, e) - ss)

        def binv():
            a = np.full(L, -1, dtype=np.int32)
            a[list(sel)] = np.arange(len(sel), dtype=np.int32)
            return a

        yield DeviceBlockKeys.column(table, "#ginv", vkey, shard), binv

        def bvalid():
            a = np.zeros(q * ublock, dtype=bool)
            for j, slot in enumerate(sel):
                a[j * ublock:j * ublock + rows(slot)[1]] = True
            return a

        yield DeviceBlockKeys.valid(table, vkey, shard), bvalid
        for c in self.spec.columns:
            col = self.table.column(c)

            def bcol(col=col):
                a = np.zeros(q * ublock, dtype=col.data.dtype)
                for j, slot in enumerate(sel):
                    ss, nv = rows(slot)
                    a[j * ublock:j * ublock + nv] = col.data[ss:ss + nv]
                return a

            yield DeviceBlockKeys.column(table, c, vkey, shard), bcol

    def _batch_version_key(self, b: int):
        """Epoch-keyed caching (delta store): a batch whose rows lie
        entirely within the immutable base is keyed ``(ns, "b",
        base_version)`` — stable across appends, so a repeat scan after an
        append re-uploads only the tail.  A batch overlapping the delta
        tail is keyed ``(ns, "d", base_version, delta_epoch)``; the next
        append bumps the epoch, orphaning exactly those entries."""
        if self.delta_rows == 0:
            return self.base_version_key
        e = min(self.n_rows, (b + 1) * self.batch_rows)
        if e <= self.base_rows:
            return self.base_version_key
        return self.delta_version_key

    # requires-lock: _DEVICE_DISPATCH_LOCK
    def _issue_prefetch(self, b: int, prefetched: set,
                        query_keys: set) -> None:
        """Start batch ``b``'s host→device copies (on the side stream) so
        they overlap the current batch's step.  ``put`` recycles the budget
        by evicting *unpinned* (already-consumed) blocks, and the loop
        stops issuing the moment room would require touching a pinned one
        — double-buffering never breaks ``device_bytes_peak <= budget``."""
        for key, build in self._builders(b):
            if key in self.devman or key in prefetched:
                continue       # cached: will be a cache hit at consumption
            try:
                self.devman.get_or_put(key, build, pin=True)
            except DeviceBudgetError:
                return
            prefetched.add(key)
            query_keys.add(key)

    def _account_skipping(self) -> None:
        """Bump what the zone maps saved: every block of every whole
        skipped batch would have been padded to batch_rows and uploaded.
        A skipped batch contributes exactly the carry-combine identity
        (+0 / +inf / -inf): not running its step leaves the carry
        bit-identical to running it."""
        live = self.live_batches
        if len(live) >= self.n_batches:
            return
        blk = self.skip_set.block
        live_set = set(live)
        skipped_blocks = 0
        for b in range(self.n_batches):
            if b in live_set:
                continue
            s = b * self.batch_rows
            e = min(self.n_rows, s + self.batch_rows)
            skipped_blocks += -(-(e - s) // blk)
        self.devman.bump(
            blocks_skipped=skipped_blocks,
            bytes_skipped_h2d=(self.n_batches - len(live))
            * self.batch_rows * self.row_bytes)

    # requires-lock: _DEVICE_DISPATCH_LOCK
    def _stream_batches(self, query_keys: set, pinned: set,
                        prefetched: set):
        """Generator driving the live batches through the block cache:
        yields ``(b, arrs, nxt)`` per batch — the batch index (the caller
        picks the gathered or full step by membership in ``_gather_sel``),
        the device blocks (pinned, and ordered after their copies on the
        compute stream), and the NEXT live batch index (None on the last
        batch).  The caller pins its own carry state *before* calling
        ``_issue_prefetch(nxt, ...)`` (so double-buffering can never evict
        it), dispatches its step, and resumes the generator, which unpins
        the consumed batch."""
        devman = self.devman
        self._account_skipping()
        live = self.live_batches
        for i, b in enumerate(live):
            arrs = []
            batch_keys = []
            for key, build in self._builders(b):
                if key in prefetched:
                    prefetched.discard(key)         # pinned at issue
                    arr = devman.peek(key)
                    devman.bump(device_prefetch_hits=1)
                else:
                    # single-flight: a concurrent query needing the same
                    # block attaches to one in-flight upload
                    arr = devman.get_or_put(key, build, pin=True)
                pinned.add(key)
                query_keys.add(key)
                batch_keys.append(key)
                arrs.append(arr)
            for key in batch_keys:
                devman.ready(key)
            if b in self._gather_sel:
                # intra-batch savings, counted at consumption: the full
                # upload would have moved L slots, the gathered one moves
                # its q candidates — whether the blocks were cache hits or
                # not
                ublock, L = self.gather
                q = len(self._gather_sel[b])
                devman.bump(bytes_skipped_h2d=(L - q) * ublock
                            * self.row_bytes)
            yield b, arrs, (live[i + 1] if i + 1 < len(live) else None)
            for key in batch_keys:
                devman.unpin(key)
                pinned.discard(key)

    # -- execution ------------------------------------------------------------
    def run(self, tier: Optional[str] = None, assemble=None):
        tier = tier or self.choose_tier()
        if tier == "host":
            raise DeviceBudgetError("input does not fit the device tier")
        with _DEVICE_DISPATCH_LOCK:
            return self._run_locked(tier, assemble=assemble)

    def _run_locked(self, tier: str, assemble=None):  # requires-lock: _DEVICE_DISPATCH_LOCK
        """Merge every batch into the carry; then either fetch + finalize
        on host (default) or run the device-resident assembly described by
        the ``assemble`` plan tuple."""
        devman = self.devman
        spec = self.spec
        init_fn, step = _cached_batch_step(spec, self.meta, self.device,
                                           self.batch_rows, self.route)
        step_g = None
        if self.gather is not None:
            _, step_g = _cached_batch_step(spec, self.meta, self.device,
                                           self.batch_rows, self.route,
                                           gather=self.gather)
        carry_key = DeviceBlockKeys.carry()
        query_keys: set = {carry_key}
        pinned: set = set()
        prefetched: set = set()
        try:
            carry = devman.adopt(carry_key, init_fn(),
                                 nbytes=self.carry_nbytes, dirty=True)
            for b, arrs, nxt in self._stream_batches(
                    query_keys, pinned, prefetched):
                # the carry is unpinned between batches so a tight budget
                # may have evicted it (writeback); re-upload before use
                if carry_key not in devman:
                    host = devman.take_host(carry_key)
                    carry = devman.put(carry_key, host, pin=False,
                                       dirty=True)
                    devman.ready(carry_key)
                devman.pin(carry_key)
                if nxt is not None:
                    self._issue_prefetch(nxt, prefetched, query_keys)
                st = step_g if b in self._gather_sel else step
                carry = st(carry, *arrs)                # async on device
                devman.unpin(carry_key)
                devman.adopt(carry_key, carry, nbytes=self.carry_nbytes,
                             dirty=True)
            if assemble is not None:
                return _assemble_on_device(assemble, self.device, carry)
            out = devman.take_host(carry_key)   # blocks: the final fence
            return finalize_partials(spec, out)
        finally:
            for key in pinned | prefetched:
                devman.unpin(key)
            devman.drop(carry_key)
            if devman.budget is None:
                # zero-config: no silent device-memory growth across
                # queries — cross-query caching is a budgeted feature
                for key in query_keys:
                    devman.drop(key)


class _DeviceJoinFallback(Exception):
    """A runtime precondition of the device join failed (duplicate build
    keys): the executor runs the host join, which is the truth for such
    data.  The one exception the device path hands to the host tier."""


class DistributedJoinAgg:
    """Streamed device-tier execution of one Aggregate(inner-join tree).

    Orchestrates per-table ``DistributedScanAgg`` block streams through the
    shared ``DeviceBufferManager``: build matrices are populated bottom-up
    (each build's batches probe the already-built child matrices, so
    semi-join filtering folds into the build itself), verified unique
    (``_dupmax`` — a duplicate build key would double-count and falls back
    to the host join), then the probe table streams through the scan-agg
    carry loop with presence gating against every probe-adjacent matrix.
    Assembly is device-resident: the caller's ``assemble`` plan tuple
    drives ``_assemble_on_device`` — finalize / compact / payload gather /
    sort happen in device memory and only the surviving rows are fetched;
    the (n_groups, K) carry and the (card, 1+P) group-build matrix never
    reach the host."""

    def __init__(self, db, spec: JoinAggSpec,
                 batch_rows: Optional[int] = None, skip_sets=None):
        self.spec = spec
        self.pspec = spec.probe_spec()
        skip_sets = skip_sets or {}
        self.probe = DistributedScanAgg(
            db, self.pspec, batch_rows=batch_rows,
            skip_set=skip_sets.get(spec.probe_table))
        self.devman = self.probe.devman
        self.device = self.probe.device
        # build-side streams: bare column streams (no grouping) — the
        # build step applies the build's own conjuncts; a build skip-set
        # is sound because a masked row scatter-adds nothing
        self.builds = [
            DistributedScanAgg(
                db, ScanAggSpec(b.table, [], [], [], [], 1,
                                list(b.columns)),
                batch_rows=batch_rows, skip_set=skip_sets.get(b.table))
            for b in spec.builds]
        self.delta_rows = self.probe.delta_rows \
            + sum(s.delta_rows for s in self.builds)

    def run(self, assemble: tuple):
        with _DEVICE_DISPATCH_LOCK:
            return self._run_locked(assemble)

    def _run_locked(self, assemble):  # requires-lock: _DEVICE_DISPATCH_LOCK
        devman = self.devman
        query_keys: set = set()
        pinned: set = set()
        prefetched: set = set()
        btab_keys: list = []
        btabs: list = []
        carry_key = DeviceBlockKeys.carry()
        query_keys.add(carry_key)
        try:
            for b, stream in zip(self.spec.builds, self.builds):
                child_idx = [ci for ci, _ in b.probe_edges]
                child_domains = tuple(self.spec.builds[ci].domain
                                      for ci in child_idx)
                init_fn, step = _cached_join_build_step(
                    b, stream.meta, self.device, stream.batch_rows,
                    child_domains)
                step_g = None
                if stream.gather is not None:
                    _, step_g = _cached_join_build_step(
                        b, stream.meta, self.device, stream.batch_rows,
                        child_domains, gather=stream.gather)
                key = DeviceBlockKeys.carry()
                btab_keys.append(key)
                query_keys.add(key)
                children = [btabs[ci] for ci in child_idx]
                # build matrices stay pinned for the whole query: later
                # builds and every probe batch read them (the planner
                # reserved state_bytes for exactly this residency)
                btab = devman.adopt(key, init_fn(), nbytes=b.table_bytes,
                                    dirty=True, pin=True)
                for bb, arrs, nxt in stream._stream_batches(
                        query_keys, pinned, prefetched):
                    if nxt is not None:
                        stream._issue_prefetch(nxt, prefetched, query_keys)
                    st = step_g if bb in stream._gather_sel else step
                    btab = st(btab, children, *arrs)
                    devman.adopt(key, btab, nbytes=b.table_bytes,
                                 dirty=True, pin=True)
                # runtime uniqueness witness: the single-key gid is only
                # sound for unique build keys (one code, one group/row)
                if _dupmax(btab) > 1.0:
                    raise _DeviceJoinFallback(
                        f"duplicate join keys in build table {b.table}")
                btabs.append(btab)
            init_fn, pstep = _cached_join_probe_step(
                self.spec, self.probe.meta, self.device,
                self.probe.batch_rows)
            pstep_g = None
            if self.probe.gather is not None:
                _, pstep_g = _cached_join_probe_step(
                    self.spec, self.probe.meta, self.device,
                    self.probe.batch_rows, gather=self.probe.gather)
            edge_btabs = [btabs[bi] for bi, _ in self.spec.probe_edges]
            carry = devman.adopt(carry_key, init_fn(),
                                 nbytes=self.probe.carry_nbytes, dirty=True)
            for bb, arrs, nxt in self.probe._stream_batches(
                    query_keys, pinned, prefetched):
                # the carry is unpinned between batches so a tight budget
                # may have evicted it (writeback); re-upload before use
                if carry_key not in devman:
                    host = devman.take_host(carry_key)
                    carry = devman.put(carry_key, host, pin=False,
                                       dirty=True)
                    devman.ready(carry_key)
                devman.pin(carry_key)
                if nxt is not None:
                    self.probe._issue_prefetch(nxt, prefetched, query_keys)
                st = pstep_g if bb in self.probe._gather_sel else pstep
                carry = st(carry, edge_btabs, *arrs)
                devman.unpin(carry_key)
                devman.adopt(carry_key, carry,
                             nbytes=self.probe.carry_nbytes, dirty=True)
            gb = self.spec.group_build
            return _assemble_on_device(
                assemble, self.device, carry,
                btabs[gb] if gb is not None else None)
        finally:
            for key in pinned | prefetched:
                devman.unpin(key)
            for key in btab_keys + [carry_key]:
                devman.unpin(key)
                devman.drop(key)
            if devman.budget is None:
                for key in query_keys:
                    devman.drop(key)


# ---------------------------------------------------------------------------
# executor integration
# ---------------------------------------------------------------------------


class _SuffixDatabase:
    """Minimal database view for suffix execution: one catalog entry — the
    assembled scan-agg core under ``AGG_RESULT_NAME`` — sharing the parent
    database's buffer manager (one stats accounting)."""

    class _Catalog:
        def __init__(self, table):
            self._table = table

        def table(self, name):
            if name != AGG_RESULT_NAME:
                raise KeyError(name)
            return self._table

    def __init__(self, table, buffer_manager):
        self.catalog = self._Catalog(table)
        self.buffer_manager = buffer_manager


class ParallelExecutor(Executor):
    """Routes device-tier plans to ``DistributedScanAgg`` and
    ``DistributedJoinAgg`` (paper Fig. 2)."""

    def __init__(self, database):
        super().__init__(database)
        self.distributed_hits = 0

    def execute(self, plan: PlanNode, do_optimize: bool = True):
        from .serving import lower_cached
        phys, rendered, hit = lower_cached(self.db, plan,
                                           do_optimize=do_optimize,
                                           distributed=True)
        self.policy = phys.policy
        self.stats.plan_repr = rendered
        self.stats.plan_cache_hit = hit
        with self._admitted(phys):
            if phys.device_tier():
                # no fallback: a device failure propagates to the caller;
                # only duplicate build keys (a property of the data that
                # the host join handles) send the query to the host tier
                try:
                    return self._run_device(phys)
                except _DeviceJoinFallback as dup:
                    phys.demote_device(str(dup))
                    self.stats.plan_repr = phys.render()
            prog = compile_plan(phys.plan, self.db.catalog)
            result = self.run_program(prog)
        self._plan_feedback(plan, True)
        return result

    @staticmethod
    def _stats_window():
        from .executor import (DEVICE_DELTA_FIELDS, INGEST_DELTA_FIELDS,
                               SKIP_DELTA_FIELDS, stats_base)
        fields = DEVICE_DELTA_FIELDS + SKIP_DELTA_FIELDS \
            + INGEST_DELTA_FIELDS
        return fields, stats_base

    def _claim_device(self, tier: str, fields, base, end, dm,
                      device_sorted: bool) -> None:
        self.distributed_hits += 1
        self.stats.device_tier = tier
        self.stats.device_sorted = device_sorted
        for f, b, e in zip(fields, base, end):
            setattr(self.stats, f, getattr(self.stats, f) + e - b)
        # lifetime gauge, reported only by queries that ran on the device
        # tier (host-tier queries keep 0 alongside device_tier == "")
        self.stats.device_bytes_peak = dm.device_bytes_peak

    # -- device scan-agg ------------------------------------------------------
    def _run_device(self, phys: PhysicalPlan):
        """Run the physical plan's core through the device tier (the tier
        the planner annotated), then the host-side suffix (ORDER BY /
        LIMIT / projection / HAVING) over the assembled aggregate — unless
        the sort was fused onto the device (``sort_on_device``), in which
        case assembly returns already-ordered rows and the suffix is
        skipped entirely."""
        if phys.join_agg is not None:
            return self._run_join(phys)
        spec = phys.scan_agg
        table = self.db.catalog.table(spec.table)
        agg = DistributedScanAgg(
            self.db, spec,
            batch_rows=getattr(self.db, "device_batch_rows", None),
            skip_set=phys.core_skip_set())
        tier = "resident" if phys.agg_tier == TIER_DEVICE_RESIDENT \
            else "streamed"
        fields, stats_base = self._stats_window()
        dm = agg.devman.stats
        base = stats_base(dm, fields)
        assemble = None
        if phys.sort_on_device:
            sort_cols = self._sort_cols_scan(spec, table,
                                             phys.sort_node.keys)
            if sort_cols is not None:
                assemble = (spec, sort_cols, phys.sort_node.limit, 0)
        out = agg.run(tier, assemble=assemble)
        if agg.delta_rows:
            # merge-on-read visibility: the scan consumed a delta tail
            agg.devman.bump(delta_rows=agg.delta_rows)
        if assemble is not None:
            gids, vals, _pay = out
            result = self._assemble(spec, vals, table, gids=gids)
        else:
            result = self._assemble(spec, out, table)
        # close the device-counter window BEFORE the suffix runs (its host
        # program threads the same delta fields through run_program)
        end = stats_base(dm, fields)
        if phys.suffix_plan is not None and assemble is None:
            result = self._run_suffix(phys.suffix_plan, result)
        self._claim_device(tier, fields, base, end, dm,
                           device_sorted=assemble is not None)
        return result

    # -- device join-agg -------------------------------------------------------
    def _run_join(self, phys: PhysicalPlan):
        """Run the physical plan's join-agg core through the device join
        tier: builds bottom-up, probe stream, device-resident assembly
        (finalize + compact + payload gather + fused ORDER BY, all in
        device memory)."""
        jspec = phys.join_agg
        tables = [jspec.probe_table] + [b.table for b in jspec.builds]
        agg = DistributedJoinAgg(
            self.db, jspec,
            batch_rows=getattr(self.db, "device_batch_rows", None),
            skip_sets={t: phys.skip_set_for_table(t) for t in tables})
        fields, stats_base = self._stats_window()
        dm = agg.devman.stats
        base = stats_base(dm, fields)
        gb = jspec.group_build
        n_payload = len(jspec.builds[gb].payload) if gb is not None else 0
        sort_cols, limit = (), None
        if phys.sort_on_device:
            sort_cols = self._sort_cols_join(jspec, phys.sort_node.keys) \
                or ()
            if sort_cols:
                limit = phys.sort_node.limit
        gids, vals, pay = agg.run((agg.pspec, sort_cols, limit, n_payload))
        if agg.delta_rows:
            agg.devman.bump(delta_rows=agg.delta_rows)
        result = self._assemble_join(jspec, gids, vals, pay)
        end = stats_base(dm, fields)
        if phys.suffix_plan is not None and not sort_cols:
            result = self._run_suffix(phys.suffix_plan, result)
        self._claim_device("join-" + phys.join_mode, fields, base, end, dm,
                           device_sorted=bool(sort_cols))
        return result

    def _sort_cols_join(self, jspec: JoinAggSpec, keys):
        """Join-core ORDER BY keys: group keys resolve through
        ``group_sources`` — the build key digit or a payload lane of the
        group build's matrix; None when a key is unmappable."""
        gb = jspec.builds[jspec.group_build] \
            if jspec.group_build is not None else None
        cols = []
        agg_names = [a.name for a in jspec.aggs]
        for col, desc in keys:
            if col in jspec.group_keys:
                src = jspec.group_sources[jspec.group_keys.index(col)]
                table = self.db.catalog.table(gb.table)
                if src[0] == "key":
                    c = table.column(gb.key)
                    cols.append((("digit", 0), c.dbtype, c.scale,
                                 bool(desc)))
                else:
                    c = table.column(gb.payload[src[1]])
                    cols.append((("payload", src[1]), c.dbtype, c.scale,
                                 bool(desc)))
            elif col in agg_names:
                i = agg_names.index(col)
                dbt = DBType.INT64 if jspec.aggs[i].fn == "count" \
                    else DBType.FLOAT64
                cols.append((("agg", i), dbt, 0, bool(desc)))
            else:
                return None
        return tuple(cols)

    def _sort_cols_scan(self, spec: ScanAggSpec, table, keys):
        """Map ORDER BY keys of a scan-agg core onto assembly sort sources
        (group-key digit or agg column); None when a key is unmappable."""
        cols = []
        agg_names = [a.name for a in spec.aggs]
        for col, desc in keys:
            if col in spec.group_keys:
                c = table.column(col)
                cols.append((("digit", spec.group_keys.index(col)),
                             c.dbtype, c.scale, bool(desc)))
            elif col in agg_names:
                i = agg_names.index(col)
                dbt = DBType.INT64 if spec.aggs[i].fn == "count" \
                    else DBType.FLOAT64
                cols.append((("agg", i), dbt, 0, bool(desc)))
            else:
                return None
        return tuple(cols)

    def _run_suffix(self, suffix_plan: PlanNode, table):
        """Execute the suffix operators over the assembled aggregate: a
        host program against a one-table catalog holding the (tiny) core
        result.  Stats and policy are shared with this query."""
        sdb = _SuffixDatabase(table, self.bufman)
        sub = Executor(sdb)
        sub.stats = self.stats
        sub.policy = self.policy
        prog = compile_plan(suffix_plan, sdb.catalog)
        return sub.run_program(prog)

    def _assemble(self, spec: ScanAggSpec, out: np.ndarray, table,
                  gids: Optional[np.ndarray] = None):
        from .column import Column
        from .table import Table
        from .types import ColumnSchema, TableSchema
        if gids is None:
            cnt_star = out[:, -1]
            present = cnt_star > 0 if spec.group_keys else np.ones(1, bool)
            gids = np.nonzero(present)[0]
            vals = out[gids]
        else:
            # device-resident assembly already compacted (and ordered)
            # the rows; ``out`` is (n_present, n_aggs + 1)
            vals = out
        cols = {}
        schemas = []
        # reconstruct key values from the mixed-radix gid
        rem = gids.copy()
        digits = []
        for off, card in reversed(spec.key_domains):
            digits.append(rem % card)
            rem = rem // card
        digits.reverse()
        for k, (off, card), d in zip(spec.group_keys, spec.key_domains,
                                     digits):
            col = table.column(k)
            if col.dbtype == DBType.VARCHAR:
                kv = d.astype(np.int32)
                cols[k] = Column(DBType.VARCHAR, kv, heap=col.heap)
            else:
                kv = (d + off).astype(col.data.dtype)
                cols[k] = Column(col.dbtype, kv, scale=col.scale)
            schemas.append(ColumnSchema(k, col.dbtype, scale=col.scale))
        for i, a in enumerate(spec.aggs):
            v = vals[:, i]
            if a.fn == "count":
                cols[a.name] = Column(DBType.INT64, v.astype(np.int64))
                schemas.append(ColumnSchema(a.name, DBType.INT64))
            else:
                cols[a.name] = Column(DBType.FLOAT64, v.astype(np.float64))
                schemas.append(ColumnSchema(a.name, DBType.FLOAT64))
        return Table(TableSchema("result", tuple(schemas)), cols)

    def _assemble_join(self, jspec: JoinAggSpec, gids: np.ndarray,
                       vals: np.ndarray, pay: np.ndarray):
        """Build the core result table of a device join from the
        device-assembled triple: group keys resolve through
        ``group_sources`` (build key code / payload lane), aggregates from
        the finalized rows — column order matches the host program's
        aggregate output (keys, then aggs)."""
        from .column import Column
        from .table import Table
        from .types import ColumnSchema, TableSchema
        catalog = self.db.catalog
        gb = jspec.builds[jspec.group_build] \
            if jspec.group_build is not None else None
        cols = {}
        schemas = []
        for k, src in zip(jspec.group_keys, jspec.group_sources):
            if src[0] == "key":
                col = catalog.table(gb.table).column(gb.key)
                v = (gids.astype(np.float64) + jspec.key_domain[0]) \
                    .astype(col.data.dtype)
            else:
                col = catalog.table(gb.table).column(gb.payload[src[1]])
                v = pay[:, src[1]].astype(col.data.dtype)
            if col.dbtype == DBType.VARCHAR:
                cols[k] = Column(DBType.VARCHAR, v, heap=col.heap)
            else:
                cols[k] = Column(col.dbtype, v, scale=col.scale)
            schemas.append(ColumnSchema(k, col.dbtype, scale=col.scale))
        for i, a in enumerate(jspec.aggs):
            v = vals[:, i]
            if a.fn == "count":
                cols[a.name] = Column(DBType.INT64, v.astype(np.int64))
                schemas.append(ColumnSchema(a.name, DBType.INT64))
            else:
                cols[a.name] = Column(DBType.FLOAT64, v.astype(np.float64))
                schemas.append(ColumnSchema(a.name, DBType.FLOAT64))
        return Table(TableSchema("result", tuple(schemas)), cols)
