"""Where a device-tier query's time goes on the card.

Runs TPC-H Q1, Q6 and Q3 (SF ``--sf``, seed ``--seed``) through the port's
entry points — ``startup(device="cuda", device_budget=B)``, the builder
API, ``Query.execute(distributed=True)`` — once to warm the block cache
and the step caches, then once under ``torch.profiler`` per cell: the
tables in generator order in every budget, then lineitem and orders in
date order (the clustered load order imprint data skipping prunes) at
1 GiB and 128 MiB.
For each profiled query it prints one JSON line: the host wall time, the
device-busy time (the union of the intervals of every kernel and copy the
card ran inside the profiled window), the idle share of that window, and
the device time of the top operations by name.

    python3 -m repro_torch.launch.profile_tier            # SF 1
    python3 -m repro_torch.launch.profile_tier --sf 0.01  # quick

Needs a CUDA device and fails without one: a device number is never
taken from a CPU run.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..core import startup
from ..data import load_tables, tpch, tpch_queries

QUERIES = ("q1", "q6", "q3")
SORT_KEYS = {"lineitem": "l_shipdate", "orders": "o_orderdate"}
CELLS = (("generated", 1 << 30), ("generated", 128 << 20),
         ("generated", 64 << 20), ("date-sorted", 1 << 30),
         ("date-sorted", 128 << 20))


def _union_us(intervals) -> float:
    """Total length of the union of ``(start, end)`` intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def profile_query(query, db) -> dict:
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        query(db).execute(distributed=True).to_pydict()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    dev = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev:
        raise RuntimeError("the profiler recorded no device activity")
    spans = [(e.time_range.start, e.time_range.end) for e in events]
    window_us = max(e for _, e in spans) - min(s for s, _ in spans)
    busy_us = _union_us((e.time_range.start, e.time_range.end) for e in dev)
    by_name: dict = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"wall_ms": wall_ms, "window_ms": window_us / 1e3,
            "device_busy_ms": busy_us / 1e3,
            "idle_share": 1.0 - busy_us / window_us,
            "device_ops": len(dev),
            "tier": db.last_stats.device_tier,
            "top_device_ms": {n: us / 1e3 for n, us in top}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sf", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--batch-rows", type=int, default=1 << 16)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_tier: no CUDA device", file=sys.stderr)
        return 2
    gen = tpch.generate(args.sf, args.seed)
    data = {"generated": {t: gen[t]
                          for t in ("customer", "orders", "lineitem")}}
    data["date-sorted"] = dict(data["generated"])
    for t, col in SORT_KEYS.items():
        cols, types, scales = gen[t]
        order = np.argsort(np.asarray(cols[col]), kind="stable")
        data["date-sorted"][t] = ({c: np.asarray(v)[order]
                                   for c, v in cols.items()}, types, scales)
    for layout, budget in CELLS:
        db = startup(device="cuda", device_budget=budget,
                     device_batch_rows=args.batch_rows)
        load_tables(db, data[layout])
        for name in QUERIES:
            query = tpch_queries.ALL_QUERIES[name]
            query(db).execute(distributed=True).to_pydict()      # warm
            if not db.last_stats.device_tier:
                # the planner kept the query on the host tier (Q3 at
                # 64 MiB): there is no device time to profile
                print(json.dumps({"query": name, "sf": args.sf,
                                  "layout": layout,
                                  "device_budget": budget, "tier": ""}),
                      flush=True)
                continue
            out = profile_query(query, db)
            print(json.dumps({"query": name, "sf": args.sf,
                              "layout": layout, "device_budget": budget,
                              "blocks_skipped": db.last_stats.blocks_skipped,
                              **out}), flush=True)
        db.shutdown()
    print(json.dumps({"device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
