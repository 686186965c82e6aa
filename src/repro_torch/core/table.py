"""Tables: ordered collections of equal-length column versions.

A ``Table`` is immutable; the transactional layer (transactions.py) swaps
whole-table versions atomically.  This is the unit the snapshot isolation
model works on (paper §3.1 "Concurrency Control").
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable, Optional

import numpy as np

from .column import Column
from .types import ColumnSchema, DBType, TableSchema


@dataclass
class Table:
    schema: TableSchema
    columns: dict[str, Column] = field(default_factory=dict)
    version: int = 0

    def __post_init__(self):
        lens = {len(c) for c in self.columns.values()}
        if len(lens) > 1:
            raise ValueError(f"ragged table {self.schema.name}: lengths {lens}")

    # ---- constructors ----------------------------------------------------
    @classmethod
    def from_dict(cls, name: str, data: dict, types: Optional[dict] = None,
                  scales: Optional[dict] = None) -> "Table":
        """Build from {col: values}. Types inferred from numpy dtypes unless
        given explicitly."""
        types = types or {}
        scales = scales or {}
        cols: dict[str, Column] = {}
        schemas: list[ColumnSchema] = []
        for cname, values in data.items():
            t = types.get(cname)
            if t is None:
                t = _infer_type(values)
            sc = scales.get(cname, 2 if t == DBType.DECIMAL else 0)
            col = Column.from_values(values, t, scale=sc)
            cols[cname] = col
            schemas.append(ColumnSchema(cname, t, scale=sc))
        return cls(TableSchema(name, tuple(schemas)), cols)

    # ---- accessors ---------------------------------------------------------
    @property
    def name(self) -> str:
        return self.schema.name

    @property
    def num_rows(self) -> int:
        if not self.columns:
            return 0
        return len(next(iter(self.columns.values())))

    @property
    def num_cols(self) -> int:
        return len(self.columns)

    def column(self, name: str) -> Column:
        return self.columns[name]

    def __getitem__(self, name: str) -> Column:
        return self.columns[name]

    @property
    def nbytes(self) -> int:
        return sum(c.nbytes for c in self.columns.values())

    # ---- delta-store geometry (delta.py overrides; a plain table is all
    # base, epoch 0) ---------------------------------------------------------
    @property
    def base_version(self) -> int:
        return self.version

    @property
    def delta_epoch(self) -> int:
        return 0

    @property
    def base_rows(self) -> int:
        return self.num_rows

    @property
    def delta_rows(self) -> int:
        return 0

    def tail_array(self, name: str, start: int) -> np.ndarray:
        """Raw storage values of rows ``[start:]`` (DeltaTable overrides
        with an O(tail) implementation that avoids the merge)."""
        return np.asarray(self.columns[name].data)[start:]

    # ---- functional updates ------------------------------------------------
    def take(self, idx: np.ndarray) -> "Table":
        return Table(self.schema,
                     {n: c.take(idx) for n, c in self.columns.items()},
                     version=self.version)

    def slice_rows(self, start: int, stop: int) -> "Table":
        """Zero-copy row window [start, stop) — the ingest path's re-chunking
        primitive (views share the source arrays; no heap work)."""
        cols = {n: Column(c.dbtype, np.asarray(c.data)[start:stop],
                          heap=c.heap, scale=c.scale)
                for n, c in self.columns.items()}
        return Table(self.schema, cols, version=self.version)

    def select_columns(self, names: Iterable[str]) -> "Table":
        names = list(names)
        sch = TableSchema(self.schema.name,
                          tuple(self.schema.column(n) for n in names))
        return Table(sch, {n: self.columns[n] for n in names},
                     version=self.version)

    def append_table(self, other: "Table") -> "Table":
        if set(other.columns) != set(self.columns):
            raise ValueError("append schema mismatch")
        cols = {n: self.columns[n].append(other.columns[n])
                for n in self.columns}
        return Table(self.schema, cols, version=self.version + 1)

    def rename(self, name: str) -> "Table":
        sch = TableSchema(name, self.schema.columns)
        return Table(sch, dict(self.columns), version=self.version)

    def to_pydict(self) -> dict[str, np.ndarray]:
        """Decode all columns (the eager-conversion path; see exchange.py
        for the zero-copy / lazy paths)."""
        return {n: c.to_numpy() for n, c in self.columns.items()}

    def head(self, n: int = 5) -> dict[str, np.ndarray]:
        return {k: v[:n] for k, v in self.to_pydict().items()}


def _infer_type(values) -> DBType:
    if isinstance(values, np.ndarray):
        dt = values.dtype
        if dt == np.int32:
            return DBType.INT32
        if np.issubdtype(dt, np.integer):
            return DBType.INT64
        if dt == np.float32:
            return DBType.FLOAT32
        if np.issubdtype(dt, np.floating):
            return DBType.FLOAT64
        if dt == np.bool_:
            return DBType.BOOL
        if dt.kind in ("U", "S", "O"):
            return DBType.VARCHAR
        raise TypeError(f"cannot infer DBType for dtype {dt}")
    for v in values:
        if v is None:
            continue
        if isinstance(v, bool):
            return DBType.BOOL
        if isinstance(v, (int, np.integer)):
            return DBType.INT64
        if isinstance(v, (float, np.floating)):
            return DBType.FLOAT64
        if isinstance(v, str):
            return DBType.VARCHAR
    return DBType.INT64
