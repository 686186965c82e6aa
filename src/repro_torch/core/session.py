"""Embedding interface (paper §3.2): startup / connect / query / append.

The API mirrors MonetDBLite's C API:

    db  = startup()                    # monetdb_startup (in-memory)
    con = db.connect()                 # monetdb_connect  (dummy client ctx)
    res = con.query(db.scan("t")...)   # a builder query -> Result
    col = res.fetch(0)                 # monetdb_result_fetch
    con.append("tbl", {...})           # monetdb_append (bulk)
    db.shutdown()                      # in-process shutdown, state released

This is the in-memory database of the port.  Persistence (``path``), the
SQL front-end and out-of-core execution (``memory_budget``) belong to later
slices and raise ``NotImplementedError`` naming their slice.  Imprint data
skipping (``data_skipping``) is on by default, as in the reference.
"""

from __future__ import annotations

import itertools
import threading
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from .executor import Executor
from .indexes import IndexManager
from .relalg import PlanNode, Query, ScanNode
from .table import Table
from .transactions import Transaction, TransactionManager
from .types import DBType

# device-cache key namespaces for transaction snapshots (0 = committed
# catalog; see Connection.query)
_snapshot_ns = itertools.count(1)

PERSISTENCE_SLICE = ("a database path (persistence) belongs to the "
                     "persistence slice of repro_torch, which is not ported "
                     "yet; call startup() without a path")
SQL_SLICE = ("SQL text belongs to the SQL front-end slice of repro_torch, "
             "which is not ported yet; pass a builder Query")


class DatabaseError(RuntimeError):
    pass


@dataclass
class Catalog:
    tables: dict[str, Table] = field(default_factory=dict)

    def table(self, name: str) -> Table:
        if name not in self.tables:
            raise DatabaseError(f"no such table: {name!r}")
        return self.tables[name]

    def __contains__(self, name):
        return name in self.tables


def _resolve_device(device) -> torch.device:
    """The database's device: whatever the caller named, never a silent
    substitute.  A CUDA device without CUDA raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise DatabaseError(
            "startup(device='cuda') needs a CUDA device and none is "
            "available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise DatabaseError(f"unsupported device {dev}")
    return dev


class Database:
    """One embedded in-memory database instance (explicit state — no
    process globals).

    ``device`` is where the device tier runs: ``"cuda"`` (default) or
    ``"cpu"``.  ``device_budget`` (bytes) bounds device-resident column
    blocks for distributed execution — over-budget inputs stream morsel
    batches through the device cache (``core.device_cache``) instead of
    requiring residency.  The default ``None`` means unlimited: zero
    configuration, no eviction."""

    def __init__(self, path: Optional[str] = None,
                 memory_budget: Optional[int] = None,
                 device_budget: Optional[int] = None,
                 device_batch_rows: Optional[int] = None,
                 data_skipping: bool = True,
                 device="cuda"):
        from .buffers import BufferManager
        from .device_cache import DeviceBufferManager
        from .serving import AdmissionGate, PlanCache
        if path is not None:
            raise NotImplementedError(PERSISTENCE_SLICE)
        self.path = None
        self.memory_budget = memory_budget
        self.device_budget = device_budget
        self.device_batch_rows = device_batch_rows
        self.data_skipping = data_skipping
        self.device = _resolve_device(device)
        self.catalog = Catalog()
        # imprints (built by the imprint kernel on ``device``) and order
        # indexes, keyed by table version
        self.index_manager = IndexManager(self)
        self.txn_manager = TransactionManager()
        self._shutdown = False
        # per-thread last_stats view: one mutable attribute would be
        # clobbered by concurrent queries (thread A reads thread B's stats)
        self._stats_local = threading.local()
        self.buffer_manager = BufferManager(memory_budget)
        # device tier: blocks share the host tier's stats object so one
        # BufferStats reports both tiers
        self.device_manager = DeviceBufferManager(
            device_budget, stats=self.buffer_manager.stats,
            device=self.device)
        # serving layer: plan cache + admission gate (core.serving)
        self.plan_cache = PlanCache()
        self.admission_gate = AdmissionGate(memory_budget, device_budget)

    # ---- embedding API ------------------------------------------------------
    def connect(self) -> "Connection":
        self._check_alive()
        return Connection(self)

    def shutdown(self) -> None:
        """In-process shutdown: free all state (everything must be
        reclaimable without process exit)."""
        if self._shutdown:
            return
        self.catalog.tables.clear()
        self.index_manager.imprints.clear()
        self.index_manager.order_indexes.clear()
        self.buffer_manager.cleanup()
        self.device_manager.cleanup()
        self.plan_cache.clear()
        self._shutdown = True

    def __enter__(self) -> "Database":
        self._check_alive()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.shutdown()
        return False

    # ---- data definition ----------------------------------------------------
    def create_table(self, name: str, data, types=None, scales=None) -> Table:
        self._check_alive()
        t = data if isinstance(data, Table) else Table.from_dict(
            name, data, types, scales)
        if isinstance(data, Table) and data.name != name:
            t = data.rename(name)
        txn = self.txn_manager.begin(self)
        txn.create_table(t)
        txn.commit()
        return t

    def drop_table(self, name: str) -> None:
        self._check_alive()
        txn = self.txn_manager.begin(self)
        txn.drop_table(name)
        txn.commit()
        # a future table reusing this name is a different table: forget
        # the admission hit history along with the blocks
        self.device_manager.invalidate_table(name, drop_history=True)
        self.plan_cache.invalidate_table(name)

    def append(self, name: str, data, types=None, scales=None) -> None:
        """Bulk append (monetdb_append): no per-row INSERT parsing."""
        self._check_alive()
        base = self.catalog.table(name)
        chunk = data if isinstance(data, Table) else Table.from_dict(
            name, data,
            types or {c.name: c.dbtype for c in base.schema.columns},
            scales or {c.name: c.scale for c in base.schema.columns})
        txn = self.txn_manager.begin(self)
        txn.append(name, chunk)
        txn.commit()
        self._post_append(name)

    def _post_append(self, name: str) -> None:
        """Epoch-keyed cache invalidation after a committed append: a delta
        append leaves the base blocks byte-identical, so only the
        delta-tail device blocks (keyed on the old epoch) die; a rebase
        (VARCHAR heap re-sort) retires everything for the table."""
        new = self.catalog.tables.get(name)
        if new is not None and new.delta_rows:
            self.device_manager.invalidate_delta(name)
        else:
            self.device_manager.invalidate_table(name)
            self.plan_cache.invalidate_table(name)

    def create_order_index(self, table: str, column: str):
        """CREATE ORDER INDEX (paper §3.1): explicit sorted index used for
        point lookups (binary search) and merge joins."""
        self._check_alive()
        self.catalog.table(table)
        return self.index_manager.create_order_index(table, column)

    # ---- querying -------------------------------------------------------------
    def scan(self, name: str) -> Query:
        self._check_alive()
        self.catalog.table(name)
        return Query(ScanNode(name), self)

    def sql(self, text: str) -> Query:
        raise NotImplementedError(SQL_SLICE)

    # ``last_stats`` is a thread-local view: each thread sees the stats of
    # the last query IT ran.  Per-result stats travel on ``Result.stats``
    # as well, which is the concurrency-proof API.
    @property
    def last_stats(self):
        return getattr(self._stats_local, "stats", None)

    @last_stats.setter
    def last_stats(self, value) -> None:
        self._stats_local.stats = value

    def execute_plan(self, plan: PlanNode, do_optimize: bool = True,
                     distributed: bool = False) -> Table:
        self._check_alive()
        if distributed:
            from .parallel import ParallelExecutor
            ex = ParallelExecutor(self)
        else:
            ex = Executor(self)
        self.last_stats = ex.stats
        return ex.execute(plan, do_optimize=do_optimize)

    # ---- hooks --------------------------------------------------------------
    def _commit(self, txn: Transaction) -> None:
        self.txn_manager.commit(self, txn)

    def _check_alive(self):
        if self._shutdown:
            raise DatabaseError("database has been shut down")

    # ---- introspection -----------------------------------------------------
    def table_names(self) -> list[str]:
        return sorted(self.catalog.tables)

    def table(self, name: str) -> Table:
        return self.catalog.table(name)


def startup(path: Optional[str] = None,
            memory_budget: Optional[int] = None,
            device_budget: Optional[int] = None,
            device_batch_rows: Optional[int] = None,
            data_skipping: bool = True,
            device="cuda") -> Database:
    """monetdb_startup for an in-memory database.

    ``device`` (default ``"cuda"``) is where the device tier runs.  Without
    CUDA, ``startup()`` raises; it never picks the CPU by itself — pass
    ``device="cpu"`` to run the device tier's torch path (and the kernels'
    plain versions) on the CPU, as the tests do.

    ``device_budget`` (bytes, default unlimited): all device-resident
    column blocks live under this budget in an LRU cache keyed on (table,
    column, version, shard).  Inputs that fit stay resident (repeat scans
    skip the host→device copy entirely); larger inputs stream morsel
    batches through the cache with double-buffered async prefetch and
    partial-aggregate carry — results are bit-identical across budgets.
    ``device_batch_rows`` fixes the streaming batch size (default 65536;
    the batch decomposition — not the budget — determines floating-point
    summation order).

    ``data_skipping`` (default True) wires the paper's §3.1 column imprints
    into planning: every ``Filter(Scan)`` over a base table gets a plan-time
    skip-set from zone maps that the ``imprint`` kernel builds on
    ``device``; the device batch streams never upload a skipped batch and
    upload only the candidate blocks of a boundary batch, and the host
    program selects through the zone maps.  Results are bit-identical with
    ``data_skipping=False``, the forced-off knob.  ``path`` (persistence)
    and ``memory_budget`` (out-of-core execution) raise
    ``NotImplementedError`` naming their slice."""
    return Database(path, memory_budget=memory_budget,
                    device_budget=device_budget,
                    device_batch_rows=device_batch_rows,
                    data_skipping=data_skipping, device=device)


@dataclass
class ResultColumnMeta:
    """High-level column header (paper Listing 2)."""
    name: str
    dbtype: DBType
    null_value: object
    scale: float
    count: int


class Result:
    """monetdb_result: semi-opaque header + per-column fetch.

    ``stats`` carries the query's own ``ExecStats``."""

    def __init__(self, table: Table, stats=None):
        self._table = table
        self.nrows = table.num_rows
        self.ncols = table.num_cols
        self.names = list(table.schema.names)
        self.stats = stats

    def fetch_raw(self, i: int) -> np.ndarray:
        """Low-level fetch: the engine's own packed array (requires
        knowledge of sentinel encoding — for wrappers)."""
        return self._table.columns[self.names[i]].data

    def fetch(self, i: int):
        """High-level fetch: decoded numpy + header struct."""
        from .types import NULL_SENTINEL
        name = self.names[i]
        col = self._table.columns[name]
        meta = ResultColumnMeta(name, col.dbtype,
                                NULL_SENTINEL[col.dbtype],
                                10.0 ** -col.scale if col.scale else 1.0,
                                len(col))
        return col.to_numpy(), meta

    def to_pydict(self):
        return self._table.to_pydict()


class Connection:
    """Dummy client context (paper §3.2): holds a query/transaction scope;
    many connections per database give inter-query parallelism + isolation."""

    def __init__(self, database: Database):
        self.database = database
        self._txn: Optional[Transaction] = None

    # -- transactions -----------------------------------------------------------
    def begin(self) -> None:
        if self._txn is not None:
            raise DatabaseError("transaction already open")
        self._txn = self.database.txn_manager.begin(self.database)

    def commit(self) -> None:
        if self._txn is None:
            raise DatabaseError("no open transaction")
        self._txn.commit()
        self._txn = None

    def rollback(self) -> None:
        if self._txn is None:
            raise DatabaseError("no open transaction")
        self._txn.rollback()
        self._txn = None

    # -- queries -----------------------------------------------------------------
    def query(self, query, **kw) -> Result:
        """Run a builder ``Query`` (SQL text belongs to a later slice).
        Inside a transaction the query runs against the snapshot."""
        if isinstance(query, str):
            raise NotImplementedError(SQL_SLICE)
        db = self.database
        if self._txn is None:
            table = db.execute_plan(query.plan, **kw)
            return Result(table, stats=db.last_stats)
        # run against the snapshot: a view database sharing the parent's
        # accounting, device manager and admission gate under a unique
        # device-key namespace (snapshot tables reuse the version number
        # the next committed write gets)
        snap = Database(None, device_budget=db.device_budget,
                        device_batch_rows=db.device_batch_rows,
                        data_skipping=db.data_skipping, device=db.device)
        # the snapshot database has its own fresh IndexManager: skip-sets
        # and imprints derive from the snapshot's (uncommitted) tables,
        # never from the committed table sharing the version number
        snap.catalog.tables = self._txn.tables()
        snap.buffer_manager = db.buffer_manager
        snap.admission_gate = db.admission_gate
        snap.device_manager = db.device_manager
        ns = next(_snapshot_ns)
        snap.device_key_namespace = ns
        try:
            table = snap.execute_plan(query.plan, **kw)
        finally:
            db.device_manager.invalidate_namespace(ns)
        db.last_stats = snap.last_stats
        return Result(table, stats=db.last_stats)

    def append(self, name: str, data, **kw) -> None:
        if self._txn is not None:
            base = self._txn.table(name)
            chunk = Table.from_dict(
                name, data,
                {c.name: c.dbtype for c in base.schema.columns},
                {c.name: c.scale for c in base.schema.columns})
            self._txn.append(name, chunk)
        else:
            self.database.append(name, data, **kw)
