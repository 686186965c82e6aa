"""Concurrent serving layer: admission control, plan cache, shared scans.

MonetDBLite is an *embedded* engine — it lives inside analytical host
processes that are themselves multi-threaded, so many queries contend for
ONE ``memory_budget`` and ONE ``device_budget``.  Everything below builds on
the unified physical planner (``physplan.PhysicalPlan``), which already
attaches a byte reservation to every operator:

* ``AdmissionGate`` — atomically reserves a plan's summed per-operator
  budget reservations against the host and device budgets *before*
  execution.  Queries whose reservations do not fit queue on a condition
  variable with a bounded wait instead of discovering pressure mid-flight
  (and then racing each other's eviction/spill decisions).  A reservation
  is an admission-control figure, not a pin: the ``BufferManager`` still
  enforces the real budget underneath, so the gate bounds *expected*
  pressure while pin accounting bounds actual bytes.

* ``PlanCache`` — maps ``(plan repr, entry-point flags, table versions,
  budgets, device)`` to a finished ``PhysicalPlan`` so hot repeated queries
  skip optimize→normalize→annotate entirely.  Entries are invalidated by ``append`` / ``DROP TABLE`` /
  ``DELETE`` (the version component of the key makes stale hits impossible
  even without the explicit invalidation — the invalidation bounds the
  cache, the key guarantees correctness).  The cache also carries the
  feedback loop the ROADMAP asks for: observed group cardinalities from
  execution are keyed by plan shape *without* versions, so a re-plan after
  an append refines its ``TierPolicy`` estimate with what the last run
  actually saw.

* ``SingleFlight`` — the shared-morsel-scan primitive ("The End of an
  Architectural Era": concurrent queries over the same table should attach
  to one in-flight scan, not each re-read it).  ``do(key, build)`` lets the
  first caller run ``build`` while every concurrent caller of the same key
  blocks and *attaches* to that result — one host read and one
  host→device upload instead of N.  ``DeviceBufferManager.get_or_put``
  wires it under the block cache; the host tier shares base columns by
  reference already, so the device path is where the duplicated work was.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable, Optional

from .relalg import PlanNode, ScanNode, plan_repr, walk

# ---------------------------------------------------------------------------
# admission control
# ---------------------------------------------------------------------------


class AdmissionTimeout(RuntimeError):
    """The bounded wait for budget reservations elapsed: the serving layer
    is saturated.  Embedders catch this and shed load instead of piling
    more queries onto an already over-committed budget."""


@dataclass
class AdmissionStats:
    admitted: int = 0            # queries that acquired their reservation
    queued: int = 0              # admissions that had to wait at least once
    timeouts: int = 0            # bounded waits that expired
    host_reserved_peak: int = 0  # high-water mark of summed host reservations
    device_reserved_peak: int = 0


class AdmissionGate:
    """Atomic budget reservations for whole queries.

    ``admit(host_bytes, device_bytes)`` blocks until both reservations fit
    their budgets (``None`` = unlimited: that side always fits) and returns
    a context-managed ticket; exiting the ticket releases the reservation
    and wakes queued queries.  Requests are capped at the budget itself —
    a plan whose per-operator reservations sum past the budget is exactly
    the plan the spill/stream tiers exist for, and it must be admissible
    when running alone."""

    def __init__(self, host_budget: Optional[int],
                 device_budget: Optional[int],
                 max_wait: float = 30.0):
        self.host_budget = host_budget
        self.device_budget = device_budget
        self.max_wait = float(max_wait)
        self._cond = threading.Condition()
        self._host_reserved = 0
        self._device_reserved = 0
        self.stats = AdmissionStats()

    # -- introspection -------------------------------------------------------
    @property
    def host_reserved(self) -> int:
        with self._cond:
            return self._host_reserved

    @property
    def device_reserved(self) -> int:
        with self._cond:
            return self._device_reserved

    def _cap(self, req: int, budget: Optional[int]) -> int:
        if budget is None:
            return 0                  # unlimited: nothing to reserve against
        return min(int(req), budget)

    def _fits(self, host_req: int, device_req: int) -> bool:  # requires-lock: _cond
        if self.host_budget is not None \
                and self._host_reserved + host_req > self.host_budget:
            return False
        if self.device_budget is not None \
                and self._device_reserved + device_req > self.device_budget:
            return False
        return True

    class _Ticket:
        def __init__(self, gate: "AdmissionGate", host: int, device: int,
                     waited: float):
            self._gate = gate
            self.host_bytes = host
            self.device_bytes = device
            self.waited = waited      # seconds spent queued (0.0 = immediate)
            self._released = False

        def release(self) -> None:
            if self._released:
                return
            self._released = True
            gate = self._gate
            with gate._cond:
                gate._host_reserved -= self.host_bytes
                gate._device_reserved -= self.device_bytes
                gate._cond.notify_all()

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            self.release()
            return False

    def admit(self, host_bytes: int, device_bytes: int = 0,
              timeout: Optional[float] = None) -> "_Ticket":
        """Reserve-or-queue.  Raises ``AdmissionTimeout`` after ``timeout``
        (default ``max_wait``) seconds of queueing."""
        host_req = self._cap(host_bytes, self.host_budget)
        device_req = self._cap(device_bytes, self.device_budget)
        limit = self.max_wait if timeout is None else float(timeout)
        start = time.monotonic()
        waited = False
        with self._cond:
            while not self._fits(host_req, device_req):
                if not waited:
                    waited = True
                    self.stats.queued += 1
                remaining = limit - (time.monotonic() - start)
                if remaining <= 0 or not self._cond.wait(remaining):
                    self.stats.timeouts += 1
                    raise AdmissionTimeout(
                        f"admission wait exceeded {limit:.1f}s "
                        f"(host {self._host_reserved}/{self.host_budget}, "
                        f"device {self._device_reserved}"
                        f"/{self.device_budget})")
            self._host_reserved += host_req
            self._device_reserved += device_req
            self.stats.admitted += 1
            self.stats.host_reserved_peak = max(
                self.stats.host_reserved_peak, self._host_reserved)
            self.stats.device_reserved_peak = max(
                self.stats.device_reserved_peak, self._device_reserved)
        return self._Ticket(self, host_req, device_req,
                            time.monotonic() - start if waited else 0.0)


# ---------------------------------------------------------------------------
# physical-plan cache
# ---------------------------------------------------------------------------


def plan_tables(plan: PlanNode) -> list[str]:
    """Every base table a plan scans (duplicates removed, order stable)."""
    seen: list[str] = []
    for node in walk(plan):
        if isinstance(node, ScanNode) and node.table not in seen:
            seen.append(node.table)
    return seen


@dataclass
class _CacheEntry:
    phys: object                     # the finished PhysicalPlan
    rendered: str                    # its EXPLAIN text (annotation, cached)
    tables: tuple[str, ...]          # for explicit invalidation


class PlanCache:
    """LRU cache of finished physical plans + the cardinality feedback map.

    Keys carry the logical plan's repr, the lowering flags, every scanned
    table's version, both budgets and the batch geometry knob — anything
    that changes the lowering changes the key, so a hit is always safe to
    reuse (modulo the per-query mutable bits, which ``get`` strips by
    handing out a shallow copy)."""

    def __init__(self, capacity: int = 256):
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._entries: "OrderedDict[tuple, _CacheEntry]" = OrderedDict()
        # plan shape (no versions/budgets) -> observed group cardinality:
        # survives invalidation on purpose — the whole point of the loop is
        # that a re-plan after an append knows what the last run saw
        self._cards: dict[tuple, int] = {}
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    # -- keys -----------------------------------------------------------------
    @staticmethod
    def key(db, plan: PlanNode, *, do_optimize: bool,
            distributed: bool) -> tuple:
        from .physplan import DEVICE_PROMOTE_HITS
        bm = getattr(db, "buffer_manager", None)
        dm = getattr(db, "device_manager", None)
        tables = plan_tables(plan)
        # delta geometry joins the version fence: an append bumps the
        # table version AND the delta epoch, and a threshold compaction
        # keeps the version but changes base_version/delta_epoch (and the
        # physical layout the plan annotated), so the key must see all
        # three — a compacted table must never be served the pre-compaction
        # plan's delta annotations
        versions = tuple(
            (t, (db.catalog.tables[t].version,
                 db.catalog.tables[t].base_version,
                 db.catalog.tables[t].delta_epoch))
            for t in tables if t in db.catalog.tables)
        # tier evidence: choose_device_tier flips a borderline table from
        # streamed to resident once its hit history crosses the promotion
        # threshold — key on the *decision input* (the crossed/not-crossed
        # boolean, which stabilizes) rather than the raw counter (which
        # would change every query and defeat the cache)
        promoted = None if (dm is None or not distributed) else tuple(
            dm.hit_history(t) >= DEVICE_PROMOTE_HITS for t in tables)
        return (plan_repr(plan), bool(do_optimize), bool(distributed),
                versions,
                None if bm is None else bm.budget,
                None if dm is None else dm.budget,
                getattr(db, "device_batch_rows", None),
                str(getattr(db, "device", "")), promoted,
                # imprint-driven skipping: cached plans carry skip-sets, so
                # the forced-off knob must never be served a skipping plan
                # (and vice versa); skip-sets bind a table version, which
                # ``versions`` already keys on
                bool(getattr(db, "data_skipping", True)))

    @staticmethod
    def shape_key(plan: PlanNode, distributed: bool) -> tuple:
        """Version/budget-free identity used by the cardinality feedback."""
        return (plan_repr(plan), bool(distributed))

    # -- lookup / store -------------------------------------------------------
    def get(self, key: tuple):
        """Hit returns ``(physical plan copy, rendered text)``; the copy
        shields the cached entry from per-query mutation (a runtime device
        demotion must not downgrade every future hit)."""
        import copy
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            return copy.copy(entry.phys), entry.rendered

    def put(self, key: tuple, phys, rendered: str) -> None:
        with self._lock:
            self._entries[key] = _CacheEntry(
                phys, rendered, tuple(t for t, _ in key[3]))
            self._entries.move_to_end(key)
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)

    # -- invalidation ---------------------------------------------------------
    def invalidate_table(self, table: str) -> None:
        """Drop every cached plan that scans ``table`` (append / DROP /
        DELETE).  The version component of the key already prevents stale
        hits; this keeps dead versions from occupying cache slots."""
        with self._lock:
            for k in [k for k, e in self._entries.items()
                      if table in e.tables]:
                del self._entries[k]

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._cards.clear()

    # -- cardinality feedback -------------------------------------------------
    def note_group_card(self, shape: tuple, n_groups: int) -> None:
        with self._lock:
            self._cards[shape] = int(n_groups)

    def group_card(self, shape: tuple) -> Optional[int]:
        with self._lock:
            return self._cards.get(shape)


# ---------------------------------------------------------------------------
# shared scans (single-flight)
# ---------------------------------------------------------------------------


class SingleFlight:
    """Per-key in-flight deduplication: the first caller of ``do(key,
    build)`` runs ``build``; concurrent callers with the same key block and
    receive the same result (``attached=True``).  A failed build propagates
    to the builder only — attachers retry as builders, so one thread's
    error never poisons another's query."""

    class _Call:
        __slots__ = ("event", "result", "error")

        def __init__(self):
            self.event = threading.Event()
            self.result = None
            self.error = None

    def __init__(self):
        self._lock = threading.Lock()
        self._calls: dict = {}
        self.attaches = 0            # callers served by another's build

    def do(self, key, build: Callable[[], object]):
        """Returns ``(result, attached)``."""
        while True:
            with self._lock:
                call = self._calls.get(key)
                if call is None:
                    call = self._Call()
                    self._calls[key] = call
                    mine = True
                else:
                    mine = False
            if mine:
                try:
                    call.result = build()
                except BaseException as e:
                    call.error = e
                    raise
                finally:
                    with self._lock:
                        self._calls.pop(key, None)
                    call.event.set()
                return call.result, False
            call.event.wait()
            if call.error is None:
                with self._lock:
                    self.attaches += 1
                return call.result, True
            # builder failed: loop and try to become the builder ourselves


# ---------------------------------------------------------------------------
# cached lowering (the executor entry point)
# ---------------------------------------------------------------------------


def lower_cached(db, plan: PlanNode, *, do_optimize: bool = True,
                 distributed: bool = False):
    """``physplan.plan_physical`` with the serving layer's plan cache in
    front: returns ``(phys, rendered, cache_hit)``.  Databases without a
    cache (suffix views, snapshot scratch dbs) lower directly."""
    from .physplan import plan_physical
    cache: Optional[PlanCache] = getattr(db, "plan_cache", None)
    if cache is None:
        phys = plan_physical(plan, db, do_optimize=do_optimize,
                             distributed=distributed)
        return phys, phys.render(), False
    key = PlanCache.key(db, plan, do_optimize=do_optimize,
                        distributed=distributed)
    bm = getattr(db, "buffer_manager", None)
    hit = cache.get(key)
    if hit is not None:
        if bm is not None:
            bm.bump(plan_cache_hits=1)
        phys, rendered = hit
        return phys, rendered, True
    if bm is not None:
        bm.bump(plan_cache_misses=1)
    phys = plan_physical(plan, db, do_optimize=do_optimize,
                         distributed=distributed,
                         group_card_hint=cache.group_card(
                             PlanCache.shape_key(plan, distributed)))
    rendered = phys.render()
    cache.put(key, phys, rendered)
    # the cached object is also the returned one on a miss: hand the
    # caller a copy for the same per-query-mutation reason get() does
    import copy
    return copy.copy(phys), rendered, False
