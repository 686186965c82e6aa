"""Device-tier buffer manager: device memory as a budgeted cache over host
memory.

The paper's central memory-management trick (§3.1) is treating one tier of
the hierarchy as a cache over the next — memory-mapped columns let the OS
page data larger than RAM.  This module is its device analogue, one level
up: all device-resident column blocks live under a ``device_budget`` byte
budget, so the device tier can *stream* tables larger than the card's
memory instead of declining them.

``DeviceBufferManager`` owns every device-resident block (``torch.Tensor``
on the database's device):

* **pin/unpin accounting**: blocks in use by a running query are pinned;
  ``device_bytes_peak`` (the high-water mark of tracked resident bytes)
  never exceeds the budget because room is made *before* a copy is issued;
* **LRU eviction** of unpinned blocks when a new block needs room.  Clean
  blocks (base columns — the host copy is authoritative) are simply
  dropped; dirty blocks (query-produced intermediates, e.g. the partial-
  aggregate carry) are copied back to host first and transparently
  re-uploaded on next use;
* a **cross-query cache** keyed on ``(table, column, version, shard)``:
  repeated scans of the same column version skip the host→device copy
  entirely (``device_cache_hits``, and ``device_bytes_h2d`` stays flat);
* **async prefetch**: ``put`` stages a block in pinned host memory and
  copies it on a side stream, recording an event; ``ready`` makes the
  compute stream wait on that event right before a consumer reads the
  block.  The execution tier (``parallel.DistributedScanAgg``) issues batch
  N+1's copies before batch N's step, so copy and compute overlap.
  ``put`` evicts *unpinned* blocks only and raises ``DeviceBudgetError``
  when everything resident is pinned — the prefetcher stops issuing at
  that point, so double-buffering stays inside the budget.

``budget=None`` (the default) means unlimited *placement* but no
cross-query retention: queries drop their blocks on completion (no silent
device-memory growth).  Stats are shared with the host tier's
``BufferStats`` so one object reports both tiers.  On a CPU device (the
tests) a block is a private CPU tensor and there are no streams.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .buffers import BufferStats

# Cache keys are 4-tuples (table, column, version, shard).  Pseudo-column
# names starting with "#" never collide with real schema names (SQL
# identifiers), so valid masks and query intermediates share the key space.
VALID_PSEUDOCOL = "#valid"
CARRY_TABLE = "#carry"


class DeviceBudgetError(RuntimeError):
    """Raised when a block cannot be placed: every resident block is pinned
    and the budget leaves no room.  The prefetcher stops issuing on it; on
    any other path it propagates to the caller (the planner keeps inputs
    that cannot stream on the host tier before the device runs)."""


def _is_delta_key(key: tuple) -> bool:
    """True for epoch-tagged delta-tail block keys.

    The execution tier keys batches fully inside a table's immutable base
    as ``(ns, "b", base_version)`` and batches overlapping the delta tail
    as ``(ns, "d", base_version, delta_epoch)`` — see
    ``parallel.DistributedScanAgg._batch_version_key``."""
    v = key[2]
    return isinstance(v, tuple) and len(v) >= 3 and v[1] == "d"


@dataclass
class _DeviceBlock:
    array: torch.Tensor
    nbytes: int
    pins: int = 0
    dirty: bool = False          # query-produced: evict => copy back to host
    ready: object = None         # torch.cuda.Event of the block's h2d copy


class DeviceBufferManager:
    """Byte-budgeted ownership of all device-resident column blocks."""

    def __init__(self, budget: Optional[int] = None,
                 stats: Optional[BufferStats] = None, device="cuda"):
        if budget is not None and budget <= 0:
            raise ValueError(
                f"device budget must be positive, got {budget}")
        self.budget = budget
        self.device = torch.device(device)
        # side stream for host→device copies (created on first upload)
        self._copy_stream = None
        self.stats = stats if stats is not None else BufferStats()
        self._blocks: "OrderedDict[tuple, _DeviceBlock]" = OrderedDict()
        self._host: dict[tuple, np.ndarray] = {}   # written-back dirty blocks
        self._resident = 0
        self._lock = threading.RLock()
        # shared scans: one in-flight build/upload per key — concurrent
        # queries over the same (table, column, version, shard) attach to
        # the first query's transfer instead of each re-reading and
        # re-uploading the block (serving.SingleFlight; lazy import keeps
        # module load order flexible)
        from .serving import SingleFlight
        self._flight = SingleFlight()
        # per-table cumulative cache hits: the runtime statistic the
        # physical planner's admission policy biases residency with
        # (physplan.choose_device_tier hit_history).  Survives version
        # bumps — repeat-access evidence is about the workload, not one
        # table version — and resets on DROP TABLE
        # (invalidate_table(drop_history=True)) and cleanup().
        self._table_hits: dict[str, int] = {}

    # ---- introspection -----------------------------------------------------
    @property
    def resident_bytes(self) -> int:
        with self._lock:
            return self._resident

    @property
    def resident_blocks(self) -> int:
        with self._lock:
            return len(self._blocks)

    def __contains__(self, key: tuple) -> bool:
        with self._lock:
            return key in self._blocks

    def bump(self, **deltas: int) -> None:
        """Atomically add ``deltas`` to stats counters — the locked
        replacement for ``devman.stats.field += n`` in operator code."""
        with self._lock:
            for name, delta in deltas.items():
                setattr(self.stats, name, getattr(self.stats, name) + delta)

    # ---- placement ---------------------------------------------------------
    def _account(self, nbytes: int) -> None:  # requires-lock: _lock
        self._resident += nbytes
        self.stats.device_bytes_peak = max(self.stats.device_bytes_peak,
                                           self._resident)

    def _make_room(self, nbytes: int) -> None:  # requires-lock: _lock
        """Evict LRU unpinned blocks until ``nbytes`` fits the budget.
        Runs *before* the new block is accounted, so tracked resident bytes
        — and therefore ``device_bytes_peak`` — never exceed the budget."""
        if self.budget is None:
            return
        if nbytes > self.budget:
            raise DeviceBudgetError(
                f"block of {nbytes} bytes exceeds device budget "
                f"{self.budget}")
        while self._resident + nbytes > self.budget:
            victim = None
            for key, blk in self._blocks.items():     # LRU order
                if blk.pins == 0:
                    victim = key
                    break
            if victim is None:
                raise DeviceBudgetError(
                    f"cannot place {nbytes} bytes: "
                    f"{self._resident} resident bytes all pinned "
                    f"(budget {self.budget})")
            self._evict(victim)

    def _evict(self, key: tuple) -> None:  # requires-lock: _lock
        blk = self._blocks.pop(key)
        if blk.dirty:
            # query-produced intermediate: host has no authoritative copy,
            # write back before dropping the device reference
            self._host[key] = blk.array.cpu().numpy()
            self.stats.device_writebacks += 1
        self._resident -= blk.nbytes
        self.stats.device_evictions += 1

    def _upload(self, arr: np.ndarray):  # requires-lock: _lock
        """Start one host→device copy; returns ``(tensor, event)``.  The
        block is staged in pinned host memory and copied on the side
        stream; the event marks the copy's end (``ready`` waits on it).
        The destination is allocated on the compute stream, whose later
        work is ordered after the copy by that wait."""
        host = torch.from_numpy(arr)
        if self.device.type != "cuda":
            return host.clone(), None          # private copy, no streams
        with torch.cuda.device(self.device):
            if self._copy_stream is None:
                self._copy_stream = torch.cuda.Stream(self.device)
            dev = torch.empty(host.shape, dtype=host.dtype,
                              device=self.device)
            staged = host.pin_memory()
            ev = torch.cuda.Event()
            # the destination was allocated on the compute stream: the copy
            # stream must not write it before that allocation is ordered
            self._copy_stream.wait_stream(
                torch.cuda.current_stream(self.device))
            with torch.cuda.stream(self._copy_stream):
                dev.copy_(staged, non_blocking=True)
                ev.record(self._copy_stream)
            # a block dropped before any consumer waited on it (eviction,
            # an aborted query) must not hand its memory back to the
            # compute stream while the copy may still be writing it
            dev.record_stream(self._copy_stream)
        return dev, ev

    def put(self, key: tuple, host_array: np.ndarray,
            pin: bool = False, dirty: bool = False) -> torch.Tensor:
        """Upload one host block (asynchronous copy on the side stream);
        evicts LRU blocks first if the budget requires it.  Returns the
        device tensor immediately — the copy overlaps whatever the caller
        does next, and a consumer calls ``ready(key)`` before reading it
        (that is the prefetch mechanism).  ``dirty=True`` marks re-uploaded
        intermediates, whose only authoritative copy must follow them back
        out on eviction."""
        arr = np.ascontiguousarray(host_array)
        nbytes = int(arr.nbytes)
        with self._lock:
            if key in self._blocks:        # replace (e.g. recycled key)
                self.drop(key)
            self._make_room(nbytes)
            dev, ev = self._upload(arr)
            self._blocks[key] = _DeviceBlock(dev, nbytes,
                                             pins=1 if pin else 0,
                                             dirty=dirty, ready=ev)
            self._account(nbytes)
            self.stats.device_bytes_h2d += nbytes
            if _is_delta_key(key):
                # delta-tail uploads tracked separately: the epoch-keyed
                # survival claim is "repeat scans after an append move only
                # the tail's bytes", and this is the counter that proves it
                self.stats.delta_bytes_h2d += nbytes
            self._host.pop(key, None)
            return dev

    def adopt(self, key: tuple, device_array: torch.Tensor,
              nbytes: Optional[int] = None, pin: bool = False,
              dirty: bool = True) -> torch.Tensor:
        """Register a tensor already on device (a query-produced
        intermediate) — accounted against the budget but no host→device
        bytes.  Dirty blocks are copied back to host on eviction."""
        if nbytes is None:
            nbytes = device_array.element_size() * device_array.numel()
        with self._lock:
            if key in self._blocks:
                self.drop(key)
            self._make_room(int(nbytes))
            self._blocks[key] = _DeviceBlock(
                device_array, int(nbytes), pins=1 if pin else 0,
                dirty=dirty)
            self._account(int(nbytes))
            self._host.pop(key, None)
            return device_array

    # ---- lookup ------------------------------------------------------------
    def get(self, key: tuple, pin: bool = False):
        """Cache lookup; bumps LRU recency and ``device_cache_hits`` on a
        hit.  A dirty block that was evicted (written back to host) is
        transparently re-uploaded.  Returns None on a clean miss."""
        with self._lock:
            blk = self._blocks.get(key)
            if blk is not None:
                self._blocks.move_to_end(key)
                if pin:
                    blk.pins += 1
                self.stats.device_cache_hits += 1
                if not key[0].startswith("#"):     # real tables only
                    self._table_hits[key[0]] = \
                        self._table_hits.get(key[0], 0) + 1
                return blk.array
            host = self._host.get(key)
        if host is None:
            return None
        return self.put(key, host, pin=pin, dirty=True)   # re-upload

    def get_or_put(self, key: tuple, build, pin: bool = False):
        """Shared-scan lookup: cache hit, else single-flight build+upload.

        ``build`` produces the host block (a file read / memmap page-in);
        the first caller of a key runs it and uploads, every concurrent
        caller of the same key *attaches* — it blocks on the in-flight
        transfer and then takes its own pin from the cache, so a
        repeat-heavy concurrent mix does ONE read and ONE host→device copy
        per block instead of N (``shared_scan_attaches`` counts the saved
        ones).  An attacher that finds the block already evicted (tight
        budget) or the build failed loops and becomes the builder itself —
        one query's error never poisons another's.  The build/upload runs
        outside the manager lock."""
        attached = False
        while True:
            arr = self.get(key, pin=pin)
            if arr is not None:
                if attached:
                    with self._lock:
                        self.stats.shared_scan_attaches += 1
                return arr
            arr, waited = self._flight.do(
                key, lambda: self.put(key, build(), pin=pin))
            if not waited:
                return arr         # we built: put() already took our pin
            attached = True        # loop: take our own pin via get()

    def hit_history(self, table: str) -> int:
        """Cumulative cache hits on one table's blocks — the repeat-access
        evidence ``physplan.choose_device_tier`` biases admission with."""
        with self._lock:
            return self._table_hits.get(table, 0)

    def peek(self, key: tuple):
        """Lookup without recency bump or hit accounting (the prefetch
        consumer uses this to distinguish prefetch hits from cache hits)."""
        with self._lock:
            blk = self._blocks.get(key)
            return None if blk is None else blk.array

    def ready(self, key: tuple) -> None:
        """Order the current (compute) stream after ``key``'s host→device
        copy: call right before a consumer reads the block.  A block whose
        copy already finished costs nothing to wait on."""
        with self._lock:
            blk = self._blocks.get(key)
            ev = None if blk is None else blk.ready
        if ev is not None:
            torch.cuda.current_stream(self.device).wait_event(ev)

    # ---- pin accounting ----------------------------------------------------
    def pin(self, key: tuple) -> None:
        with self._lock:
            self._blocks[key].pins += 1

    def unpin(self, key: tuple) -> None:
        with self._lock:
            blk = self._blocks.get(key)
            if blk is not None and blk.pins > 0:
                blk.pins -= 1

    # ---- explicit lifecycle ------------------------------------------------
    def drop(self, key: tuple) -> None:
        """Remove a block without writeback or eviction accounting (query
        teardown of its own blocks; budget-pressure eviction is
        ``_make_room``'s job)."""
        with self._lock:
            blk = self._blocks.pop(key, None)
            if blk is not None:
                self._resident -= blk.nbytes
            self._host.pop(key, None)

    def take_host(self, key: tuple) -> Optional[np.ndarray]:
        """Fetch a block's value to host and drop it: device copy if
        resident (blocks until the value is ready), else the written-back
        host copy."""
        with self._lock:
            blk = self._blocks.pop(key, None)
            if blk is not None:
                self._resident -= blk.nbytes
                return blk.array.cpu().numpy()
            return self._host.pop(key, None)

    def invalidate_table(self, table: str,
                         drop_history: bool = False) -> None:
        """Drop every block of one table (all columns, versions, shards) —
        called when a table is dropped or rewritten in place.

        ``drop_history=True`` (DROP TABLE) also forgets the table's
        admission hit history: a future table reusing the name is a
        different table and must earn residency from scratch.  Appends and
        in-place rewrites keep the history — repeat-access evidence is
        about the workload, not one table version."""
        with self._lock:
            for key in [k for k in self._blocks if k[0] == table]:
                self.drop(key)
            for key in [k for k in self._host if k[0] == table]:
                self._host.pop(key, None)
            if drop_history:
                self._table_hits.pop(table, None)

    def invalidate_delta(self, table: str) -> None:
        """Drop only one table's delta-tail blocks (epoch-tagged keys).

        The base blocks stay: a delta append leaves them byte-identical and
        their ``(ns, "b", base_version)`` keys unchanged, so repeat scans
        re-upload nothing but the new tail.  Superseded-epoch tail blocks
        are unreachable either way (keys carry the epoch) — dropping them
        just frees their budget immediately."""
        def _match(k):
            return k[0] == table and _is_delta_key(k)
        with self._lock:
            for key in [k for k in self._blocks if _match(k)]:
                self.drop(key)
            for key in [k for k in self._host if _match(k)]:
                self._host.pop(key, None)

    def invalidate_namespace(self, ns) -> None:
        """Drop every block whose version component carries key namespace
        ``ns`` (a transaction snapshot's blocks, once its query ends)."""
        def _match(k):
            return isinstance(k[2], tuple) and len(k[2]) >= 2 \
                and k[2][0] == ns
        with self._lock:
            for key in [k for k in self._blocks if _match(k)]:
                self.drop(key)
            for key in [k for k in self._host if _match(k)]:
                self._host.pop(key, None)

    def cleanup(self) -> None:
        """Release everything (database shutdown)."""
        with self._lock:
            self._blocks.clear()
            self._host.clear()
            self._table_hits.clear()
            self._resident = 0


__all__ = ["DeviceBufferManager", "DeviceBudgetError", "DeviceBlockKeys",
           "VALID_PSEUDOCOL", "CARRY_TABLE"]


class DeviceBlockKeys:
    """Key builders for the shared 4-tuple key space.

    ``shard`` identifies the block's slice of the column and must encode
    its geometry (the execution tier passes ``(device, batch_rows,
    batch_index)``)
    — two slicings of the same column version are distinct blocks.
    ``version`` may be a plain table version or a namespace-carrying tuple
    — ``(ns, "b", base_version)`` for blocks inside a table's immutable
    base, ``(ns, "d", base_version, delta_epoch)`` for blocks overlapping
    the delta tail.  Transaction snapshots use a unique ``ns`` because
    their tables reuse the version number the next committed write will
    get; the base/delta split is what lets an append invalidate only the
    tail (``invalidate_delta``) while base blocks keep hitting."""

    @staticmethod
    def column(table: str, column: str, version, shard) -> tuple:
        return (table, column, version, shard)

    @staticmethod
    def valid(table: str, version, shard) -> tuple:
        return (table, VALID_PSEUDOCOL, version, shard)

    _seq = 0
    _seq_lock = threading.Lock()

    @classmethod
    def carry(cls) -> tuple:
        """Unique per-query intermediate key (never cached across queries)."""
        with cls._seq_lock:
            cls._seq += 1
            return (CARRY_TABLE, "partial", cls._seq, 0)
