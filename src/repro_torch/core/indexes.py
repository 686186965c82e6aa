"""Automatic indexing (paper §3.1): imprints, order indexes.

* **Imprints** — per-block zone maps: min/max and a 16-bin presence bitmap
  per 2048-row block, built on the database's device by the hand-written
  ``imprint`` kernel (``kernels/imprint``; its plain version on the CPU).
  Range selections consult the zone maps and skip non-qualifying blocks
  entirely; the planner derives per-scan skip-sets from them
  (``physplan.derive_skip_sets``).
* **Order index** — an argsort permutation (paper: CREATE ORDER INDEX).  It
  answers point lookups by binary search and turns equi-joins into merge
  joins.  It is also *auto-created* on join keys of base tables, playing
  the role of the paper's automatically-built hash tables.
* Lifecycle follows the paper: built on first qualifying use, cached, and
  invalidated on column modification — except imprints on append, which
  are extended over the new tail.

The column copy that feeds the kernel is a transient tensor, freed after
the build: it is not a query's upload and never goes through the device
block cache (``DeviceBufferManager``) or its counters.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ..kernels.imprint import ops as imprint_ops
from ..kernels.imprint.ref import BINS as IMPRINT_BINS
from ..kernels.imprint.ref import BLOCK as IMPRINT_BLOCK
from .column import Column
from .types import DBType, NULL_SENTINEL, is_float

AUTO_ORDER_MIN_ROWS = 1024    # don't index tiny columns (paper: heuristics)


@dataclass
class Imprint:
    block: int
    mins: np.ndarray          # (n_blocks,) float64
    maxs: np.ndarray          # (n_blocks,) float64
    bitmaps: np.ndarray       # (n_blocks,) uint16 presence bitmap
    lo: float                 # histogram range for the bitmap bins
    hi: float
    n_rows: int

    def candidate_blocks(self, lo: float, hi: float,
                         lo_strict: bool, hi_strict: bool) -> np.ndarray:
        """Boolean per-block: may this block contain values in [lo, hi]?

        A histogram range with an infinite end (a float column holding
        -inf, or both infinities) makes the bin position of a finite bound
        inf/inf = NaN; every block is then a candidate (the reference
        engine raises there)."""
        ok_lo = (self.maxs > lo) if lo_strict else (self.maxs >= lo)
        ok_hi = (self.mins < hi) if hi_strict else (self.mins <= hi)
        cand = ok_lo & ok_hi
        # refine with the presence bitmap for equality/narrow ranges
        if np.isfinite(lo) and np.isfinite(hi) and self.hi > self.lo:
            f0 = (lo - self.lo) / (self.hi - self.lo) * IMPRINT_BINS
            f1 = (hi - self.lo) / (self.hi - self.lo) * IMPRINT_BINS
            if math.isnan(f0) or math.isnan(f1):
                return np.ones(len(self.mins), dtype=bool)
            b0 = int(np.clip(f0, 0, IMPRINT_BINS - 1))
            b1 = int(np.clip(f1, 0, IMPRINT_BINS - 1))
            want = np.uint16(0)
            for b in range(b0, b1 + 1):
                want |= np.uint16(1 << b)
            cand &= (self.bitmaps & want) != 0
        return cand


def _divisor(dbtype: DBType, scale: int) -> float:
    """What the imprint divides a stored value by: 10**scale for DECIMAL."""
    return float(10 ** scale) if dbtype == DBType.DECIMAL else 1.0


def _column_tensor(values: np.ndarray, device) -> torch.Tensor:
    """A transient copy of a column's stored values on ``device`` (not a
    cached device block: no DeviceBufferManager accounting)."""
    return torch.from_numpy(np.ascontiguousarray(values)).to(device)


def build_imprint(col: Column, device) -> Optional[Imprint]:
    """Zone maps for a numeric/date/decimal column, built by the imprint
    kernel on ``device`` (its plain version for a CPU device)."""
    if col.dbtype == DBType.VARCHAR or col.dbtype == DBType.BOOL:
        return None
    v = np.asarray(col.data)
    mins, maxs, bitmaps, lo, hi = imprint_ops.build_zone_maps(
        _column_tensor(v, device), _divisor(col.dbtype, col.scale))
    return Imprint(IMPRINT_BLOCK, mins, maxs, bitmaps, lo, hi, len(v))


def _extend_imprint(imp: Imprint, t, cname: str,
                    device) -> Optional[Imprint]:
    """Extend zone maps over appended rows without touching complete blocks.

    Recomputes only blocks covering rows ``[floor(prev/block)*block, n)``.
    Appended values are binned against the ORIGINAL ``(lo, hi)`` histogram
    range with clamping — the same monotone transform ``candidate_blocks``
    applies to query bounds — so the presence bitmap stays a superset of
    the truth and pruning stays sound even when new values fall outside the
    old range (mins/maxs stay exact either way)."""
    try:
        cs = t.schema.column(cname)
    except KeyError:
        return None
    if cs.dbtype == DBType.VARCHAR or cs.dbtype == DBType.BOOL:
        return None
    n_rows = t.num_rows
    if n_rows < imp.n_rows:
        return None
    keep = imp.n_rows // imp.block          # complete, untouched blocks
    start = keep * imp.block
    v = np.asarray(t.tail_array(cname, start))
    if len(v):
        mins, maxs, bitmaps = imprint_ops.extend_zone_maps(
            _column_tensor(v, device), _divisor(cs.dbtype, cs.scale),
            imp.lo, imp.hi)
    else:
        mins = maxs = np.zeros(0)
        bitmaps = np.zeros(0, dtype=np.uint16)
    return Imprint(imp.block,
                   np.concatenate([imp.mins[:keep], mins]),
                   np.concatenate([imp.maxs[:keep], maxs]),
                   np.concatenate([imp.bitmaps[:keep], bitmaps]),
                   imp.lo, imp.hi, n_rows)


@dataclass
class IndexManager:
    """Per-database index cache keyed by (table, column, table_version)."""
    database: object
    imprints: dict = field(default_factory=dict)
    order_indexes: dict = field(default_factory=dict)
    stats_hits: int = 0
    stats_built: int = 0

    # -- invalidation --------------------------------------------------------
    def invalidate_table(self, table: str) -> None:
        self.imprints = {k: v for k, v in self.imprints.items()
                         if k[0] != table}
        self.order_indexes = {k: v for k, v in self.order_indexes.items()
                              if k[0] != table}

    def on_append(self, table: str) -> None:
        """Append lifecycle: imprints are *extended*, not destroyed.

        Every append path preserves the existing row prefix (delta chunks
        by construction), so zone maps for blocks fully inside the old
        prefix remain exact — only the trailing (possibly partial) block
        and the new tail are recomputed, an O(delta rows) update read
        through ``tail_array`` so the delta tail never forces a merge.
        Order indexes rebuild lazily (the paper's contract).  Drops go
        through ``invalidate_table`` instead."""
        t = self.database.catalog.tables.get(table)
        extended = {}
        if t is not None:
            for (tb, cname, ver), imp in self.imprints.items():
                if tb != table or imp is None or ver >= t.version:
                    continue
                ext = _extend_imprint(imp, t, cname,
                                      self.database.device)
                if ext is not None:
                    extended[(table, cname, t.version)] = ext
        self.invalidate_table(table)
        self.imprints.update(extended)

    # -- imprints -------------------------------------------------------------
    def _key(self, table: str, column: str):
        t = self.database.catalog.table(table)
        return (table, column, t.version)

    def get_imprint(self, table: str, column: str) -> Optional[Imprint]:
        key = self._key(table, column)
        if key not in self.imprints:
            col = self.database.catalog.table(table).column(column)
            if len(col) < AUTO_ORDER_MIN_ROWS:
                return None
            self.imprints[key] = build_imprint(col, self.database.device)
            self.stats_built += 1
        return self.imprints[key]

    def imprint_mask(self, table: str, column: str, lo: float, hi: float,
                     lo_strict: bool, hi_strict: bool):
        """Range-select through zone maps.  Returns (mask, blocks_skipped)
        or None when no imprint applies."""
        imp = self.get_imprint(table, column)
        if imp is None:
            return None
        self.stats_hits += 1
        col = self.database.catalog.table(table).column(column)
        v = np.asarray(col.data)
        if col.dbtype == DBType.DECIMAL:
            f = v.astype(np.float64) / (10 ** col.scale)
        else:
            f = v.astype(np.float64)
        cand = imp.candidate_blocks(lo, hi, lo_strict, hi_strict)
        mask = np.zeros(len(v), dtype=bool)
        skipped = int((~cand).sum())
        for b in np.nonzero(cand)[0]:
            s, e = b * imp.block, min((b + 1) * imp.block, len(v))
            fv = f[s:e]
            m = np.ones(e - s, dtype=bool)
            m &= (fv > lo) if lo_strict else (fv >= lo)
            m &= (fv < hi) if hi_strict else (fv <= hi)
            if is_float(col.dbtype):
                m &= ~np.isnan(fv)
            else:
                # the NULL sentinel (INT64_MIN) satisfies open lower bounds
                # like ``col < x`` (lo = -inf); SQL comparisons reject NULL
                m &= v[s:e] != NULL_SENTINEL[col.dbtype]
            mask[s:e] = m
        return mask, skipped

    def candidate_info(self, table: str, column: str, lo: float, hi: float,
                       lo_strict: bool, hi_strict: bool):
        """Planning-side zone-map probe: per-block candidate bitmap without
        materializing a row mask.  Returns (cand, block_rows, n_rows) or
        None when no imprint applies (small/VARCHAR/BOOL columns)."""
        imp = self.get_imprint(table, column)
        if imp is None:
            return None
        self.stats_hits += 1
        cand = imp.candidate_blocks(lo, hi, lo_strict, hi_strict)
        return cand, imp.block, imp.n_rows

    # -- order index ----------------------------------------------------------
    def create_order_index(self, table: str, column: str) -> np.ndarray:
        """Explicit CREATE ORDER INDEX (paper §3.1)."""
        key = self._key(table, column)
        if key not in self.order_indexes:
            col = self.database.catalog.table(table).column(column)
            self.order_indexes[key] = np.argsort(
                np.asarray(col.data), kind="stable").astype(np.int64)
            self.stats_built += 1
        return self.order_indexes[key]

    def get_order_index(self, table: str, column: str) -> Optional[np.ndarray]:
        return self.order_indexes.get(self._key(table, column))

    def auto_order_index(self, table: str, column: str,
                         probe_codes: np.ndarray) -> Optional[np.ndarray]:
        """Auto-create on join-key use (paper's auto hash tables).

        Only valid when the join ran on raw column codes — a single
        non-VARCHAR build key whose factorized codes are order-isomorphic
        to the raw values (factorization through np.unique is monotone), on
        an unfiltered build side (the caller guarantees that).  Returns the
        permutation that sorts the column, which then also sorts the
        codes."""
        t = self.database.catalog.table(table)
        col = t.column(column)
        if col.dbtype == DBType.VARCHAR:
            return None   # cross-heap factorization need not be monotone
        if len(col) < AUTO_ORDER_MIN_ROWS or len(probe_codes) != len(col):
            return None
        return self.create_order_index(table, column)

    # -- point lookup through order index (binary search; paper §3.1) --------
    def point_lookup(self, table: str, column: str, value) -> np.ndarray:
        perm = self.create_order_index(table, column)
        col = self.database.catalog.table(table).column(column)
        v = np.asarray(col.data)[perm]
        lo = np.searchsorted(v, value, "left")
        hi = np.searchsorted(v, value, "right")
        return perm[lo:hi]
