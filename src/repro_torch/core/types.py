"""Type system for the embedded columnar engine.

Mirrors MonetDBLite's storage model (paper §3.1):

* every column is a tightly packed 1-D array;
* row numbers are implicit (position in the array);
* missing values are stored as *in-domain sentinel values* -- e.g. a NULL in
  an INTEGER column is ``-2**31`` -- never as a separate validity bitmap;
* variable-length values (VARCHAR) are dictionary-encoded: the column holds
  int32 codes into a duplicate-eliminated heap (paper's "variable-sized
  heap"), with code 0 reserved for NULL.

The sentinel choice matters on the device: predicates and aggregates stay
branch-free vector ops over packed arrays.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

import numpy as np


class DBType(enum.Enum):
    INT32 = "int32"
    INT64 = "int64"
    FLOAT32 = "float32"
    FLOAT64 = "float64"
    BOOL = "bool"           # stored as int8; sentinel -128
    DATE = "date"           # stored as int32 days since 1970-01-01
    DECIMAL = "decimal"     # stored as int64 scaled by 10**scale
    VARCHAR = "varchar"     # stored as int32 dictionary codes; 0 == NULL


# numpy storage dtype for each logical type
STORAGE_DTYPE: dict[DBType, np.dtype] = {
    DBType.INT32: np.dtype(np.int32),
    DBType.INT64: np.dtype(np.int64),
    DBType.FLOAT32: np.dtype(np.float32),
    DBType.FLOAT64: np.dtype(np.float64),
    DBType.BOOL: np.dtype(np.int8),
    DBType.DATE: np.dtype(np.int32),
    DBType.DECIMAL: np.dtype(np.int64),
    DBType.VARCHAR: np.dtype(np.int32),
}

# in-domain NULL sentinel per type (paper §3.1 "Data Storage")
NULL_SENTINEL = {
    DBType.INT32: np.int32(-(2**31)),
    DBType.INT64: np.int64(-(2**63)),
    DBType.FLOAT32: np.float32(np.nan),
    DBType.FLOAT64: np.float64(np.nan),
    DBType.BOOL: np.int8(-128),
    DBType.DATE: np.int32(-(2**31)),
    DBType.DECIMAL: np.int64(-(2**63)),
    DBType.VARCHAR: np.int32(0),
}

_FLOAT_TYPES = (DBType.FLOAT32, DBType.FLOAT64)
_NUMERIC_TYPES = (
    DBType.INT32,
    DBType.INT64,
    DBType.FLOAT32,
    DBType.FLOAT64,
    DBType.DECIMAL,
)


def is_numeric(t: DBType) -> bool:
    return t in _NUMERIC_TYPES


def is_float(t: DBType) -> bool:
    return t in _FLOAT_TYPES


def null_mask(values: np.ndarray, t: DBType) -> np.ndarray:
    """Boolean mask of NULL positions, derived from the sentinel."""
    if is_float(t):
        return np.isnan(values)
    return values == NULL_SENTINEL[t]


def common_type(a: DBType, b: DBType) -> DBType:
    """Implicit arithmetic type promotion."""
    if a == b:
        return a
    order = [DBType.BOOL, DBType.INT32, DBType.DATE, DBType.INT64,
             DBType.DECIMAL, DBType.FLOAT32, DBType.FLOAT64]
    if a in order and b in order:
        return order[max(order.index(a), order.index(b))]
    raise TypeError(f"no common type for {a} and {b}")


@dataclass(frozen=True)
class ColumnSchema:
    name: str
    dbtype: DBType
    scale: int = 0          # DECIMAL scale (10**scale fixed-point)
    nullable: bool = True

    @property
    def storage_dtype(self) -> np.dtype:
        return STORAGE_DTYPE[self.dbtype]


@dataclass(frozen=True)
class TableSchema:
    name: str
    columns: tuple[ColumnSchema, ...]

    def __post_init__(self):
        names = [c.name for c in self.columns]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate column names in {self.name}: {names}")

    def column(self, name: str) -> ColumnSchema:
        for c in self.columns:
            if c.name == name:
                return c
        raise KeyError(f"{self.name} has no column {name!r}")

    @property
    def names(self) -> tuple[str, ...]:
        return tuple(c.name for c in self.columns)


# ---------------------------------------------------------------------------
# DATE helpers: DATE is int32 days since epoch.  We provide vectorized
# conversions without external deps (paper: dependencies stripped, §3.4).
# ---------------------------------------------------------------------------

_EPOCH = np.datetime64("1970-01-01", "D")


def date_from_string(s) -> np.ndarray:
    """Parse 'YYYY-MM-DD' strings (scalar or array-like) to day numbers."""
    arr = np.asarray(s, dtype="datetime64[D]")
    return (arr - _EPOCH).astype(np.int32)


def date_to_string(days: np.ndarray) -> np.ndarray:
    return (np.asarray(days, dtype=np.int32).astype("timedelta64[D]")
            + _EPOCH).astype(str)


def date_year(days: np.ndarray) -> np.ndarray:
    d = np.asarray(days).astype("timedelta64[D]") + _EPOCH
    return d.astype("datetime64[Y]").astype(np.int32) + 1970


def decimal_encode(x, scale: int) -> np.ndarray:
    """Fixed-point encode floats/ints at 10**scale (DECIMAL storage)."""
    return np.round(np.asarray(x, dtype=np.float64) * (10**scale)).astype(np.int64)


def decimal_decode(v: np.ndarray, scale: int) -> np.ndarray:
    return np.asarray(v, dtype=np.float64) / (10**scale)
