"""Columns: tightly packed arrays + duplicate-eliminated string heaps.

Storage tiers (paper §3.1 "Memory Management"):

* **host tier**: a numpy array.  This plays the role of MonetDB's
  memory-mapped column: the OS keeps it paged in/out on the host.
* **device tier**: a ``torch.Tensor`` produced on first touch by a query
  (`.device(dev)`), the explicit analogue of a page fault pulling a column
  into device memory.  Hot columns stay cached; `evict()` drops the device
  copy.

Columns are **immutable versions**: appends/updates produce a new ``Column``
(functional copy-on-write — the strong form of the paper's mprotect-CoW).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from .types import (DBType, NULL_SENTINEL, STORAGE_DTYPE, is_float,
                    null_mask)


class StringHeap:
    """Order-preserving dictionary heap for VARCHAR columns.

    The paper's variable-sized heap performs duplicate elimination; we make
    that total: every distinct value appears exactly once and codes are
    assigned in *sorted order* (code 1 = smallest string), so range
    predicates and sorts operate directly on int32 codes.  Code 0 is NULL.
    """

    __slots__ = ("values", "_fp")

    def __init__(self, values: Optional[np.ndarray] = None):
        # values[0] is the NULL placeholder; values[1:] sorted ascending.
        if values is None:
            values = np.array([""], dtype=object)
        self.values = values
        self._fp: Optional[bytes] = None

    def fingerprint(self) -> bytes:
        """Content hash of the heap (cached; heaps are immutable once built).

        Two heaps with equal fingerprints assign equal codes to equal
        strings, so their columns' int32 codes are directly comparable —
        the cheap content-equality that lets operators treat separately
        loaded copies of the same dictionary as one."""
        if self._fp is None:
            import hashlib
            h = hashlib.blake2b(digest_size=16)
            h.update(len(self.values).to_bytes(8, "little"))
            for v in self.values:
                b = str(v).encode("utf-8")
                h.update(len(b).to_bytes(4, "little"))
                h.update(b)
            self._fp = h.digest()
        return self._fp

    def content_equal(self, other: Optional["StringHeap"]) -> bool:
        """True iff both heaps hold the same values in the same order."""
        if self is other:
            return True
        if other is None:
            return False
        return (len(self.values) == len(other.values)
                and self.fingerprint() == other.fingerprint())

    @classmethod
    def encode(cls, strings) -> tuple["StringHeap", np.ndarray]:
        """Encode an iterable of (str | None) into (heap, codes)."""
        arr = np.asarray(
            [("\0NULL" if s is None else s) for s in strings], dtype=object)
        isnull = np.array([s is None for s in strings], dtype=bool)
        present = arr[~isnull]
        uniq = np.unique(present.astype(str)) if present.size else np.array([], dtype=str)
        heap_vals = np.empty(len(uniq) + 1, dtype=object)
        heap_vals[0] = ""
        heap_vals[1:] = uniq
        codes = np.zeros(len(arr), dtype=np.int32)
        if present.size:
            codes[~isnull] = (
                np.searchsorted(uniq, present.astype(str)).astype(np.int32) + 1)
        return cls(heap_vals), codes

    def decode(self, codes: np.ndarray) -> np.ndarray:
        out = self.values[np.asarray(codes, dtype=np.int64)]
        return out

    def code_of(self, s: Optional[str]) -> int:
        """Exact-match code; -1 if the value is absent from the heap."""
        if s is None:
            return 0
        i = np.searchsorted(self.values[1:].astype(str), s) + 1
        if i < len(self.values) and self.values[i] == s:
            return int(i)
        return -1

    def lower_bound(self, s: str) -> int:
        """Smallest code whose value >= s (for range predicates on codes)."""
        return int(np.searchsorted(self.values[1:].astype(str), s, "left")) + 1

    def upper_bound(self, s: str) -> int:
        return int(np.searchsorted(self.values[1:].astype(str), s, "right")) + 1

    def merge(self, strings) -> tuple["StringHeap", np.ndarray, np.ndarray]:
        """Merge new values in; returns (new_heap, recode_map, new_codes).

        ``recode_map`` maps old codes -> new codes so existing columns can be
        re-encoded (order preservation requires global re-sort on novel
        values; appends of already-present values are O(1) in heap size:
        the heap object is returned unchanged with an identity recode map,
        never re-sorted — ``new is self`` on that path).
        """
        new_heap, new_codes = StringHeap.encode(strings)
        old_strs = self.values[1:].astype(str)
        if len(old_strs) == 0:
            recode = np.zeros(1, dtype=np.int32)
            return new_heap, recode, new_codes
        nvals = new_heap.values[1:].astype(str)
        if len(nvals) == 0:
            # all-NULL input: nothing to add, heap identity preserved
            recode = np.arange(len(self.values), dtype=np.int32)
            return self, recode, new_codes
        pos = np.searchsorted(old_strs, nvals)
        safe = np.minimum(pos, len(old_strs) - 1)
        if bool((old_strs[safe] == nvals).all()):
            # every incoming value is already present: O(1) in heap size —
            # no global re-sort, identity recode, same heap object
            recode = np.arange(len(self.values), dtype=np.int32)
            nc = np.zeros_like(new_codes)
            mask = new_codes > 0
            nc[mask] = (pos[new_codes[mask] - 1] + 1).astype(np.int32)
            return self, recode, nc
        merged = np.unique(np.concatenate(
            [old_strs, new_heap.values[1:].astype(str)]))
        heap_vals = np.empty(len(merged) + 1, dtype=object)
        heap_vals[0] = ""
        heap_vals[1:] = merged
        out = StringHeap(heap_vals)
        recode = np.zeros(len(self.values), dtype=np.int32)
        recode[1:] = np.searchsorted(merged, old_strs).astype(np.int32) + 1
        nc = np.zeros_like(new_codes)
        mask = new_codes > 0
        nc[mask] = (np.searchsorted(
            merged, new_heap.values[new_codes[mask]].astype(str)
        ).astype(np.int32) + 1)
        return out, recode, nc

    def __len__(self) -> int:
        return len(self.values)

    def nbytes(self) -> int:
        return int(sum(len(str(v)) for v in self.values)) + 8 * len(self.values)


def heaps_equal(a: Optional[StringHeap], b: Optional[StringHeap]) -> bool:
    """Content equality for possibly-absent heaps: identical objects (or
    both absent) short-circuit; otherwise compare cached fingerprints."""
    if a is b:
        return True
    if a is None or b is None:
        return False
    return a.content_equal(b)


@dataclass
class Column:
    """One column version: packed data + optional heap + cached device copy."""

    dbtype: DBType
    data: np.ndarray                       # host tier (may be np.memmap)
    heap: Optional[StringHeap] = None      # VARCHAR only
    scale: int = 0                         # DECIMAL only
    _device: object = field(default=None, repr=False, compare=False)
    _has_nulls: object = field(default=None, repr=False, compare=False)

    def __post_init__(self):
        want = STORAGE_DTYPE[self.dbtype]
        if self.data.dtype != want:
            self.data = self.data.astype(want)   # dtype mismatch: convert
        if self.dbtype == DBType.VARCHAR and self.heap is None:
            raise ValueError("VARCHAR column requires a heap")

    # ---- constructors ----------------------------------------------------
    @classmethod
    def from_values(cls, values, dbtype: DBType, scale: int = 0) -> "Column":
        from .types import date_from_string, decimal_encode
        if dbtype == DBType.VARCHAR:
            heap, codes = StringHeap.encode(values)
            return cls(dbtype, codes, heap=heap)
        vals = list(values) if not isinstance(values, np.ndarray) else values
        if isinstance(vals, list):
            isnull = np.array([v is None for v in vals], dtype=bool)
            filled = [0 if v is None else v for v in vals]
            if dbtype == DBType.DATE and filled and isinstance(
                    next((v for v in vals if v is not None), 0), str):
                arr = np.zeros(len(vals), dtype=np.int32)
                nn = [v for v in vals if v is not None]
                if nn:
                    arr[~isnull] = date_from_string(nn)
            elif dbtype == DBType.DECIMAL:
                arr = decimal_encode(np.asarray(filled), scale)
            elif dbtype == DBType.BOOL:
                arr = np.asarray(filled).astype(np.int8)
            else:
                arr = np.asarray(filled).astype(STORAGE_DTYPE[dbtype])
            if isnull.any():
                arr = arr.copy()
                arr[isnull] = NULL_SENTINEL[dbtype]
        else:
            if dbtype == DBType.DECIMAL and np.issubdtype(vals.dtype, np.floating):
                arr = decimal_encode(vals, scale)
            else:
                # zero-copy adoption when the dtype already matches
                arr = vals.astype(STORAGE_DTYPE[dbtype], copy=False)
        return cls(dbtype, arr, scale=scale)

    # ---- tiers -----------------------------------------------------------
    def device(self, dev="cuda"):
        """Device-resident tensor on the database's device ``dev``
        (explicit 'page-in'; cached per column version)."""
        import torch
        want = torch.device(dev)
        cached = self._device
        if cached is None or cached.device.type != want.type:
            cached = torch.from_numpy(
                np.ascontiguousarray(self.data).copy()).to(want)
            object.__setattr__(self, "_device", cached)
        return cached

    def evict(self) -> None:
        object.__setattr__(self, "_device", None)

    # ---- basic accessors ---------------------------------------------------
    def __len__(self) -> int:
        return int(self.data.shape[0])

    @property
    def nbytes(self) -> int:
        n = int(self.data.nbytes)
        if self.heap is not None:
            n += self.heap.nbytes()
        return n

    def nulls(self) -> np.ndarray:
        return null_mask(self.data, self.dbtype)

    def has_nulls(self) -> bool:
        """Cached null presence (columns are immutable versions, so the
        answer never changes) — keeps zero-copy eligibility O(1)."""
        if self._has_nulls is None:
            object.__setattr__(self, "_has_nulls", bool(self.nulls().any()))
        return self._has_nulls

    def to_numpy(self, decode: bool = True) -> np.ndarray:
        """Decode to a user-facing numpy array (NULLs -> None/NaN)."""
        from .types import decimal_decode
        if not decode:
            return self.data
        if self.dbtype == DBType.VARCHAR:
            out = self.heap.decode(self.data)
            out = out.copy()
            out[self.data == 0] = None
            return out
        if self.dbtype == DBType.DECIMAL:
            out = decimal_decode(self.data, self.scale)
            out[self.nulls()] = np.nan
            return out
        if self.dbtype == DBType.BOOL:
            out = self.data.astype(object)
            m = self.nulls()
            out = (self.data != 0).astype(object)
            out[m] = None
            return out
        if is_float(self.dbtype):
            return self.data
        out = self.data.astype(object)
        out[self.nulls()] = None
        return out

    def take(self, idx: np.ndarray) -> "Column":
        return Column(self.dbtype, np.asarray(self.data)[idx],
                      heap=self.heap, scale=self.scale)

    def append(self, other: "Column") -> "Column":
        """Functional append -> new column version (bulk append path)."""
        if other.dbtype != self.dbtype:
            raise TypeError(f"append type mismatch {self.dbtype} vs {other.dbtype}")
        if self.dbtype == DBType.VARCHAR:
            heap, recode, new_codes = self.heap.merge(
                [None if c == 0 else str(other.heap.values[c])
                 for c in other.data])
            data = np.concatenate([recode[self.data], new_codes])
            return Column(self.dbtype, data, heap=heap)
        return Column(self.dbtype,
                      np.concatenate([self.data, other.data]),
                      scale=self.scale)
