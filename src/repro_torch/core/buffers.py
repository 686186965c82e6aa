"""Host buffer accounting: the stats every tier reports into.

``BufferStats`` is the one counter object a database shares between its
host tier and its device tier (``device_cache.DeviceBufferManager``), and
``BufferManager`` owns it.  In this package the manager does the counter
accounting only (``bump``): out-of-core execution — spill
files, run-file codecs, a finite ``memory_budget`` — belongs to the
out-of-core slice and is not here yet, so a budget raises
``NotImplementedError`` instead of silently running unbounded.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Optional

OUT_OF_CORE_SLICE = ("memory_budget (out-of-core execution) belongs to the "
                     "out-of-core slice of repro_torch, which is not ported "
                     "yet; run with memory_budget=None")


@dataclass
class BufferStats:
    pinned: int = 0              # bytes currently pinned
    peak: int = 0                # high-water mark of pinned bytes
    spill_count: int = 0         # spill files created
    bytes_spilled: int = 0       # post-codec bytes actually written
    bytes_spilled_raw: int = 0   # pre-codec (logical) spilled bytes
    spilled_ops: int = 0         # blocking operators that took the spill path
    varchar_spills: int = 0      # spilled ops whose keys include VARCHAR
    result_spills: int = 0       # final tables streamed to memmapped columns
    prefetch_hits: int = 0       # partitions served by the async prefetcher
    repartitions: int = 0        # oversized partitions split recursively
    # device tier (device_cache.py): budgeted device block cache counters
    device_bytes_peak: int = 0   # high-water of tracked device-resident bytes
    device_bytes_h2d: int = 0    # host→device bytes actually copied
    device_cache_hits: int = 0   # blocks served from the cross-query cache
    device_prefetch_hits: int = 0  # batches whose copy was issued ahead
    device_evictions: int = 0    # blocks evicted under budget pressure
    device_writebacks: int = 0   # dirty (intermediate) blocks copied to host
    # serving layer (serving.py): concurrent-query counters
    plan_cache_hits: int = 0     # queries that skipped lowering entirely
    plan_cache_misses: int = 0   # queries that paid a full lowering pass
    admission_waits: int = 0     # admissions that queued for budget room
    shared_scan_attaches: int = 0  # block requests served by another
                                   # query's in-flight build/upload
    # data skipping: kept at 0 until the imprint slice lands
    blocks_skipped: int = 0
    bytes_skipped_h2d: int = 0
    bytes_skipped_spill: int = 0
    # delta-store ingest (delta.py): merge-on-read appends
    delta_bytes_h2d: int = 0       # h2d bytes for delta-tail device blocks
    delta_rows: int = 0            # delta-tail rows consumed by scans
    compactions: int = 0           # delta tails folded into a new base

    @property
    def bytes_spilled_compressed(self) -> int:
        """Alias of ``bytes_spilled``, named for the raw/compressed pair."""
        return self.bytes_spilled


class BufferManager:
    """Byte accounting for one database (no spill tier in this package)."""

    def __init__(self, budget: Optional[int] = None):
        if budget is not None:
            raise NotImplementedError(OUT_OF_CORE_SLICE)
        self.budget = budget
        self._lock = threading.Lock()
        self.stats = BufferStats()

    def bump(self, **deltas: int) -> None:
        """Atomically add ``deltas`` to stats counters.  Operator code must
        use this (or a ``stats_base``/``stats_apply_delta`` window) instead
        of ``bm.stats.field += n`` — the bare form is an unlocked
        read-modify-write that loses updates under concurrency."""
        with self._lock:
            for name, delta in deltas.items():
                setattr(self.stats, name, getattr(self.stats, name) + delta)

    def cleanup(self) -> None:
        """Release everything (database shutdown)."""
        with self._lock:
            self.stats.pinned = 0
