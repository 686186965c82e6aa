"""Optimistic concurrency control (paper §3.1 "Concurrency Control").

Transactions operate on a snapshot of the database (a pinned set of
immutable table versions).  Writes are buffered; commit performs optimistic
conflict detection — first committer wins per table — and either installs
new versions atomically or raises ``ConflictError``.

Because tables are immutable values, snapshot isolation is structural: a
reader's snapshot can never observe a concurrent writer.  This is the
functional-array restatement of MonetDBLite's model.  This package holds
the in-memory commit path; the write-ahead log and the index hooks arrive
with the persistence and imprint slices.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field

from .delta import delta_append
from .table import Table


class ConflictError(RuntimeError):
    pass


class TransactionError(RuntimeError):
    pass


@dataclass
class Transaction:
    database: object
    snapshot: dict[str, Table]                 # pinned versions
    writes: dict[str, list[Table]] = field(default_factory=dict)  # appends
    creates: dict[str, Table] = field(default_factory=dict)
    replaces: dict[str, Table] = field(default_factory=dict)      # DELETE
    drops: set = field(default_factory=set)
    state: str = "open"                        # open | committed | aborted

    # -- reads ---------------------------------------------------------------
    def table(self, name: str) -> Table:
        self._check_open()
        if name in self.creates:
            return self.creates[name]
        if name in self.drops:
            raise KeyError(f"table {name} dropped in this transaction")
        t = self.replaces.get(name, self.snapshot[name])
        for chunk in self.writes.get(name, ()):   # read-your-own-writes
            t = delta_append(t, chunk)
        return t

    def tables(self) -> dict[str, Table]:
        out = {n: self.table(n)
               for n in list(self.snapshot) + list(self.creates)
               if n not in self.drops}
        return out

    # -- writes --------------------------------------------------------------
    def append(self, name: str, chunk: Table) -> None:
        self._check_open()
        if name not in self.snapshot and name not in self.creates:
            raise KeyError(f"unknown table {name}")
        self.writes.setdefault(name, []).append(chunk)

    def replace(self, name: str, table: Table) -> None:
        """Replace a table's contents wholesale (the DELETE path).  Validated
        against the snapshot version at commit, exactly like appends."""
        self._check_open()
        if name not in self.snapshot:
            raise KeyError(f"unknown table {name}")
        self.replaces[name] = table

    def create_table(self, table: Table) -> None:
        self._check_open()
        if table.name in self.snapshot or table.name in self.creates:
            raise TransactionError(f"table {table.name} already exists")
        self.creates[table.name] = table

    def drop_table(self, name: str) -> None:
        self._check_open()
        if name not in self.snapshot and name not in self.creates:
            raise KeyError(name)
        self.creates.pop(name, None)
        self.drops.add(name)

    # -- lifecycle -------------------------------------------------------------
    def commit(self) -> None:
        self._check_open()
        self.database._commit(self)
        self.state = "committed"

    def rollback(self) -> None:
        self._check_open()
        self.state = "aborted"

    def _check_open(self):
        if self.state != "open":
            raise TransactionError(f"transaction is {self.state}")


class TransactionManager:
    """Owns the committed table map; serializes commits under a lock
    (commits are short: version checks + pointer swaps)."""

    def __init__(self):
        self._lock = threading.Lock()

    def begin(self, database) -> Transaction:
        with self._lock:
            snap = dict(database.catalog.tables)
        return Transaction(database, snap)

    def commit(self, database, txn: Transaction) -> None:
        with self._lock:
            cat = database.catalog
            # optimistic validation: every written table must be unchanged
            for name in (list(txn.writes) + list(txn.replaces)
                         + list(txn.drops)):
                if name in txn.creates:
                    continue
                cur = cat.tables.get(name)
                base = txn.snapshot.get(name)
                if cur is None or base is None or cur.version != base.version:
                    raise ConflictError(
                        f"write-write conflict on table {name!r}")
            for name in txn.creates:
                if name in cat.tables:
                    raise ConflictError(f"table {name!r} created concurrently")
            # install
            for name, table in txn.creates.items():
                cat.tables[name] = table
            for name, table in txn.replaces.items():
                cat.tables[name] = table
            for name, chunks in txn.writes.items():
                t = cat.tables[name]
                for chunk in chunks:
                    # delta install: the base version is shared, the chunk
                    # rides as an immutable tail — O(delta rows) per commit
                    t = delta_append(t, chunk)
                cat.tables[name] = t
            for name in txn.drops:
                del cat.tables[name]
