"""Data for the port: the TPC-H generator (``tpch``), the TPC-H queries of
this slice (``tpch_queries``) and ``load_tables``, which carries a data set
across into a database — the state a database has in place of weights."""

from __future__ import annotations

from ..core.types import DBType


def load_tables(db, tables: dict) -> None:
    """Create one table per entry of ``{name: (arrays, types, scales)}`` —
    the triples ``tpch.generate`` returns, or the arrays of a reference
    ``Table`` with its column types and scales — so that two databases
    built from the same arrays query the same bytes.  A type is taken by
    its value (``"decimal"``, ...), so the reference engine's enum members
    and plain strings name the same ``DBType``."""
    for name, (arrays, types, scales) in tables.items():
        types = {c: DBType(getattr(t, "value", t)) for c, t in types.items()}
        db.create_table(name, arrays, types=types, scales=scales)
