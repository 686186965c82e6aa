"""Delta store: O(delta-rows) appends over the immutable columnar base.

The paper's ACID story installs a whole new table version per append; that
makes a hot append O(table) (every column rewritten on checkpoint) and a
giant bulk load fully resident.  Following the delta-store design from
"Mainlining Databases" (PAPERS.md), an append now installs an immutable
*delta chunk* next to the untouched base version:

* **write side** — ``delta_append`` returns a ``DeltaTable`` sharing the
  same base object, so commit cost is O(delta rows).
* **read side** — merge-on-read: ``DeltaTable.columns`` materializes the
  concatenated (base ++ chunks) columns lazily, once, so every executor
  (sequential, device) consumes one stream bit-identical to the
  eager-append layout.
* **compaction** folds the tail back into a plain base table; it belongs
  to the persistence slice of this package and is not here yet, so a tail
  only grows.

Keeping the base blocks immutable is what lets the device block cache stay
valid for the base portion across appends — the lakehouse argument from
"The Data Lakehouse" (PAPERS.md).
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np

from .column import Column, heaps_equal
from .table import Table
from .types import DBType


class DeltaTable(Table):
    """Immutable base version + an ordered tail of append chunks.

    Readers see one logical table: the ``columns`` property merges
    (base ++ chunks) lazily under ``_merge_lock``.  Writers never touch the
    base — ``delta_append`` returns a new ``DeltaTable`` sharing the same
    base object, so an append costs O(delta rows) regardless of table size.

    VARCHAR invariant: every chunk's codes are already expressed in the
    *base* column's heap (``delta_append`` recodes on the way in, and falls
    back to a full rebase when a novel value would re-sort the heap), so
    the merge is a plain concatenate for every type.

    ``version`` advances by one per chunk — exactly the sequence the eager
    ``append_table`` path would have produced — so optimistic conflict
    detection, skip-set fencing, and imprint keys are unchanged.
    """

    def __init__(self, base: Table, chunks: tuple):
        # Deliberately not calling the dataclass __init__: ``columns`` is a
        # read-only merging property here, not a stored field.
        self.schema = base.schema
        self.base = base
        self.chunks = tuple(chunks)
        self.version = base.version + len(self.chunks)
        self._tail_rows = int(sum(c.num_rows for c in self.chunks))
        self._merge_lock = threading.Lock()
        self._merged = None

    # -- delta geometry ------------------------------------------------------
    @property
    def base_version(self) -> int:
        return self.base.version

    @property
    def delta_epoch(self) -> int:
        return len(self.chunks)

    @property
    def base_rows(self) -> int:
        return self.base.num_rows

    @property
    def delta_rows(self) -> int:
        return self._tail_rows

    @property
    def num_rows(self) -> int:
        # Never materializes the merge: the planner asks for row counts far
        # more often than anyone scans.
        return self.base.num_rows + self._tail_rows

    # -- merge-on-read -------------------------------------------------------
    @property
    def columns(self) -> dict[str, Column]:
        with self._merge_lock:
            if self._merged is None:
                self._merged = {
                    cs.name: _concat_column(
                        [self.base.columns[cs.name]]
                        + [c.columns[cs.name] for c in self.chunks])
                    for cs in self.schema.columns}
            return self._merged

    def column_pieces(self, name: str) -> list[Column]:
        """The physical pieces (base column first) without merging."""
        return ([self.base.columns[name]]
                + [c.columns[name] for c in self.chunks])

    def tail_array(self, name: str, start: int) -> np.ndarray:
        """Raw storage values of rows ``[start:]`` without materializing the
        merge — O(rows returned) when ``start >= base_rows`` (the incremental
        imprint-extension path)."""
        pieces, off = [], 0
        for col in self.column_pieces(name):
            n = len(col)
            s = max(start - off, 0)
            if s < n:
                pieces.append(np.asarray(col.data)[s:n])
            off += n
        if not pieces:
            return np.empty(0, dtype=self.base.columns[name].data.dtype)
        return pieces[0] if len(pieces) == 1 else np.concatenate(pieces)

    def __repr__(self) -> str:
        return (f"DeltaTable({self.schema.name!r}, version={self.version}, "
                f"base_rows={self.base_rows}, delta_rows={self.delta_rows})")


def _concat_column(pieces: list) -> Column:
    head = pieces[0]
    if len(pieces) == 1:
        return head
    data = np.concatenate([np.asarray(p.data) for p in pieces])
    return Column(head.dbtype, data, heap=head.heap, scale=head.scale)


def _recode_to_base(base: Table, chunk: Table) -> Optional[Table]:
    """Re-express ``chunk`` in the base's column heaps.

    Returns None when a VARCHAR chunk carries a value absent from the base
    heap: order preservation would re-sort the heap and recode the *base*
    codes (prefix instability), so the caller must rebase instead.
    """
    cols: dict[str, Column] = {}
    for cs in base.schema.columns:
        c = chunk.columns[cs.name]
        bcol = base.columns[cs.name]
        if c.dbtype != bcol.dbtype:
            raise TypeError(
                f"append type mismatch {bcol.dbtype} vs {c.dbtype}")
        if c.dbtype != DBType.VARCHAR:
            cols[cs.name] = c
            continue
        if heaps_equal(c.heap, bcol.heap):
            cols[cs.name] = Column(DBType.VARCHAR, np.asarray(c.data),
                                   heap=bcol.heap)
            continue
        strings = [None if code == 0 else str(c.heap.values[code])
                   for code in c.data]
        heap, _recode, new_codes = bcol.heap.merge(strings)
        if heap is not bcol.heap:     # novel value: heap re-sorted
            return None
        cols[cs.name] = Column(DBType.VARCHAR, new_codes, heap=bcol.heap)
    return Table(base.schema, cols)


def delta_append(t: Table, chunk: Table) -> Table:
    """Append ``chunk`` to ``t`` as an immutable delta chunk when possible.

    Returns a ``DeltaTable`` sharing ``t``'s base (an O(delta) install).
    Falls back to the eager ``append_table`` copy — a *rebase* — when a
    VARCHAR chunk would force a heap re-sort; either way the result's
    ``version`` is ``t.version + 1``.
    """
    names = {cs.name for cs in t.schema.columns}
    if set(chunk.columns) != names:
        raise ValueError("append schema mismatch")
    base = t.base if isinstance(t, DeltaTable) else t
    recoded = _recode_to_base(base, chunk)
    if recoded is None:
        return t.append_table(chunk)
    chunks = (t.chunks + (recoded,)) if isinstance(t, DeltaTable) \
        else (recoded,)
    return DeltaTable(base, chunks)
