"""Core engine of the port.

Public API:
    startup(device="cuda") -> Database  # the embedding interface
    Col, Lit, DateLit, Func, Case, ...  # expression builders
"""

from .buffers import BufferManager
from .column import Column, StringHeap
from .device_cache import DeviceBufferManager
from .expression import (BinOp, Case, Cast, Col, DateLit, Func, InList,
                         IsNull, Like, Lit, Not)
from .relalg import AggSpec, Query
from .session import Connection, Database, DatabaseError, Result, startup
from .table import Table
from .transactions import ConflictError, TransactionError
from .types import ColumnSchema, DBType, TableSchema

__all__ = [
    "AggSpec", "BinOp", "BufferManager", "Case", "Cast", "Col", "Column",
    "ColumnSchema", "ConflictError", "Connection", "Database",
    "DatabaseError", "DateLit", "DeviceBufferManager", "DBType", "Func",
    "InList", "IsNull", "Like", "Lit", "Not", "Query", "Result",
    "StringHeap", "Table", "TableSchema", "TransactionError", "startup",
]
