#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Builds the port's hand-written kernels from ``src/repro_torch/csrc``,
holds each against its plain PyTorch version on the card, and runs TPC-H
Q1, Q6 and Q3 at scale factor 1 (6,000,000 lineitem, 1,500,000 orders and
150,000 customer rows, seed 7) through the port's entry points —
``startup(device="cuda", device_budget=B)`` (imprint data skipping on, the
default), the builder API, ``Query.execute(distributed=True)`` — in four
device-budget cells (phase ``engine``), then with lineitem and orders in
date order, skipping on and off, at 1 GiB and 128 MiB (phase
``skipping``).  A kernel's ``ms``, ``plain_ms`` and ``library_ms`` are the
card's time for calls queued ahead of it (``device_ms``); ``wrapper_ms``
adds the host's per-call cost.  Prints one JSON object per phase, then a
summary line of every kernel, the card's name and power limit (as
``nvidia-smi`` gives them) and a last line ``{"ok": true, "device":
{...}}``.  Exits non-zero, without
that last line, when any phase fails or when there is no CUDA device.

    python3 chip_smoke.py            # SF 1, as the check runs it
    python3 chip_smoke.py --sf 0.01  # a quick build-and-check run

It imports neither JAX nor the JAX reference package.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
GiB = 1 << 30
MiB = 1 << 20
BUDGETS = (None, 1 * GiB, 128 * MiB, 64 * MiB)
QUERIES = ("q1", "q6", "q3")
TABLES = ("customer", "orders", "lineitem")
# the tier each query must report per budget: Q3's working state (two
# build tables and the 1.5M-group carry, ~77 MB with two batches) does not
# fit 64 MiB, so the planner keeps it on the host tier there ("")
SCAN_TIER = {None: "resident", 1 * GiB: "resident", 128 * MiB: "streamed",
             64 * MiB: "streamed"}
EXPECTED_TIER = {"q1": SCAN_TIER, "q6": SCAN_TIER,
                 "q3": {None: "join-resident", 1 * GiB: "join-resident",
                        128 * MiB: "join-streamed", 64 * MiB: ""}}
KERNELS = ("hash_group", "scan_agg", "radix_build", "radix_probe", "sort",
           "imprint")
# the skipping phase: the clustered load order data skipping pays on
SKIP_BUDGETS = (1 * GiB, 128 * MiB)
SKIP_QUERIES = ("q6", "q1", "q3")
SORT_KEYS = {"lineitem": "l_shipdate", "orders": "o_orderdate"}
QUERY_TABLES = {"q1": ("lineitem",), "q6": ("lineitem",),
                "q3": ("customer", "orders", "lineitem")}
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory (data sheet)
FP64_FLOPS = 34e12               # H100 SXM float64 outside tensor cores
EPS64 = 2.0 ** -52
SLEEP_CYCLES = 100_000_000       # ~50 ms on the card: the host queues meanwhile


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def device_ms(fn, reps: int = 30, warmup: int = 3):
    """Time of one call of ``fn`` on the card.  The ``reps`` calls are
    queued behind a sleep kernel and timed by CUDA events around them, so
    the card runs them back to back and the host's per-call cost is not in
    the time.  Returns ``(ms, ahead)``: ``ahead`` is False when the sleep
    ended before the host had queued every call (``fn`` waits for the card,
    or fills the launch queue), and the time may then hold host gaps."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    ahead = not start.query()
    end.synchronize()
    return start.elapsed_time(end) / reps, ahead


def wrapper_ms(fn, reps: int = 30, warmup: int = 3) -> float:
    """Time of one call of ``fn`` made back to back, from CUDA events: the
    device time plus whatever of the host's per-call cost (argument checks,
    allocation, the launch itself) the device waits for."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, flops: float):
    """Least time the card could take: the larger of bytes over memory
    rate and float64 operations over the float64 rate, in ms."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP64_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def _launch_counters():
    """Every ported kernel's launch counter, by kernel name."""
    from repro_torch.kernels.hash_group import kernel as hk
    from repro_torch.kernels.imprint import kernel as ik
    from repro_torch.kernels.radix_join import kernel as rk
    from repro_torch.kernels.scan_agg import kernel as sk
    from repro_torch.kernels.sort import kernel as so
    return {"hash_group": hk.LAUNCHES, "scan_agg": sk.LAUNCHES,
            "radix_build": rk.BUILD_LAUNCHES,
            "radix_probe": rk.PROBE_LAUNCHES, "sort": so.LAUNCHES,
            "imprint": ik.LAUNCHES}


def phase_build():
    from repro_torch.kernels import cuda_build
    from repro_torch.kernels.hash_group import kernel as hk
    from repro_torch.kernels.imprint import kernel as ik
    from repro_torch.kernels.radix_join import kernel as rk
    from repro_torch.kernels.scan_agg import kernel as sk
    from repro_torch.kernels.sort import kernel as so
    libs = {"hash_group": hk._bind, "scan_agg": sk._bind,
            "radix_join": rk._bind, "sort": so._bind, "imprint": ik._bind}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(libs)) as pool:  # one nvcc each
        futs = [pool.submit(cuda_build.load, n, b) for n, b in libs.items()]
        for f in futs:
            f.result()
    return {"phase": "build", "seconds": time.perf_counter() - t0,
            "nvcc_seconds": {n: cuda_build.build_seconds(n) for n in libs}}


def phase_data(sf: float, seed: int):
    from repro_torch.core import Table
    from repro_torch.data import tpch
    t0 = time.perf_counter()
    gen = tpch.generate(sf, seed)
    t_gen = time.perf_counter() - t0
    tables = {name: Table.from_dict(name, *gen[name]) for name in TABLES}
    return tables, {"phase": "data", "sf": sf, "seed": seed,
                    "rows": {n: t.num_rows for n, t in tables.items()},
                    "generate_seconds": t_gen,
                    "encode_seconds": time.perf_counter() - t0 - t_gen}


def _load(db, tables) -> None:
    for name, table in tables.items():
        db.create_table(name, table)


def _main_path_shapes(tables, batch_rows):
    """The kernels' shapes on the main path, as the engine's planner
    derives them: Q1's (G, V), Q6's (C, P), and Q3's group domain D with
    the lane counts of its probe partials and of its group build table."""
    from repro_torch.core import startup
    from repro_torch.core.parallel import scan_agg_route
    from repro_torch.core.physplan import partial_layout, plan_physical
    from repro_torch.data import tpch_queries as Q
    db = startup(device="cuda", device_batch_rows=batch_rows)
    _load(db, tables)
    s1 = plan_physical(Q.q1(db).plan, db, distributed=True).scan_agg
    s6 = plan_physical(Q.q6(db).plan, db, distributed=True).scan_agg
    j3 = plan_physical(Q.q3(db).plan, db, distributed=True).join_agg
    route = scan_agg_route(s6, db.table("lineitem"))
    if route is None or scan_agg_route(s1, db.table("lineitem")) is not None:
        raise AssertionError("Q6 must take the scan_agg route, Q1 hash_group")
    if j3 is None:
        raise AssertionError("Q3 must match the device join tier")
    gb = j3.builds[j3.group_build]
    db.shutdown()
    return ((s1.n_groups, partial_layout(s1).n_sum),
            (len(route.columns), len(route.pairs)),
            (j3.n_groups, partial_layout(j3.probe_spec()).n_sum,
             1 + len(gb.payload)))


def check_hash_group(rng, case, n, G, V):
    """hash_group against its plain version at one shape; vals[0] is a
    ones column, so column 0 holds exact counts."""
    import numpy as np
    import torch
    from repro_torch.kernels.hash_group.kernel import hash_group
    from repro_torch.kernels.hash_group.ref import hash_group_ref
    dev = torch.device("cuda")
    if case == "all_masked":
        gid_np = np.full(n, G, dtype=np.int32)          # all in trash
    else:
        gid_np = rng.integers(0, G + 1, n).astype(np.int32)   # G: trash
    vals_np = rng.uniform(-1000.0, 1000.0, (V, n))
    vals_np[0] = 1.0
    gid = torch.as_tensor(gid_np, device=dev)
    vals = torch.as_tensor(vals_np, device=dev)
    got = hash_group(gid, vals, G)
    want = hash_group_ref(gid, vals, G)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    scale = float(hash_group_ref(gid, vals.abs(), G).max())
    limit = n * EPS64 * max(scale, 1.0)
    counts_exact = bool(torch.equal(got[:, 0], want[:, 0]))
    ok = err <= limit and counts_exact and bool(torch.isfinite(got).all())
    ms, a_ms = device_ms(lambda: hash_group(gid, vals, G))
    w_ms = wrapper_ms(lambda: hash_group(gid, vals, G))
    plain_ms, a_plain = device_ms(lambda: hash_group_ref(gid, vals, G),
                                  reps=5)
    idx = gid.to(torch.int64)
    vt = vals.t()

    def library():
        return torch.zeros((G + 1, V), dtype=torch.float64,
                           device=dev).index_add_(0, idx, vt)

    library_ms, a_lib = device_ms(library)
    b_ms, b_by = bound(n * 4 + V * n * 8 + G * V * 8, n * V)
    return {"kernel": "hash_group", "case": case, "n": n, "G": G, "V": V,
            "max_abs_err": err, "limit": limit, "counts_exact": counts_exact,
            "ok": ok, "ms": ms, "wrapper_ms": w_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": b_ms, "bound_by": b_by,
            "queued_ahead": {"ms": a_ms, "plain_ms": a_plain,
                             "library_ms": a_lib}}


def check_scan_agg(rng, case, n, C, P):
    """scan_agg against its plain version at one shape: column 0 filters
    to about half of the rows, the other columns are unfiltered."""
    import numpy as np
    import torch
    from repro_torch.kernels.scan_agg.kernel import scan_agg
    from repro_torch.kernels.scan_agg.ref import scan_agg_ref
    dev = torch.device("cuda")
    cols_np = rng.uniform(0.0, 100.0, (C, n))
    lo_np = np.full(C, -np.inf)
    hi_np = np.full(C, np.inf)
    lo_np[0], hi_np[0] = 25.0, 75.0
    valid_np = np.zeros(n, dtype=bool) if case == "all_masked" \
        else np.ones(n, dtype=bool)
    pairs_np = np.array([(p % C, (p + 1) % C if p % 2 == 0 else -1)
                         for p in range(P)], dtype=np.int32).reshape(-1, 2)
    cols = torch.as_tensor(cols_np, device=dev)
    lo = torch.as_tensor(lo_np, device=dev)
    hi = torch.as_tensor(hi_np, device=dev)
    valid = torch.as_tensor(valid_np, device=dev)
    pairs = torch.as_tensor(pairs_np, device=dev)
    got = scan_agg(cols, lo, hi, valid, pairs)
    want = scan_agg_ref(cols, lo, hi, valid, pairs)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    scale = float(scan_agg_ref(cols.abs(), torch.full_like(lo, -np.inf),
                               torch.full_like(hi, np.inf), valid, pairs)
                  .max())
    limit = n * EPS64 * max(scale, 1.0)
    count_exact = bool(got[-1] == want[-1])
    ok = err <= limit and count_exact and bool(torch.isfinite(got).all())
    ms, a_ms = device_ms(lambda: scan_agg(cols, lo, hi, valid, pairs))
    w_ms = wrapper_ms(lambda: scan_agg(cols, lo, hi, valid, pairs))
    plain_ms, a_plain = device_ms(
        lambda: scan_agg_ref(cols, lo, hi, valid, pairs), reps=5)
    b_ms, b_by = bound(C * n * 8 + n + C * 16 + P * 8 + (P + 1) * 8,
                       n * (2 * C + 2 * P + 1))
    return {"kernel": "scan_agg", "case": case, "n": n, "C": C, "P": P,
            "max_abs_err": err, "limit": limit, "count_exact": count_exact,
            "ok": ok, "ms": ms, "wrapper_ms": w_ms, "plain_ms": plain_ms,
            "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
            "queued_ahead": {"ms": a_ms, "plain_ms": a_plain}}


def _sum_check(got, want, scale_ref, n: int, exact_cols):
    """max |got - want|, the order-of-summation limit n·2⁻⁵²·Σ|x|, and
    whether the columns ``exact_cols`` (counts, payloads) agree exactly."""
    import torch
    err = float((got - want).abs().max()) if got.numel() else 0.0
    scale = float(scale_ref.max()) if scale_ref.numel() else 0.0
    limit = n * EPS64 * max(scale, 1.0)
    exact = all(bool(torch.equal(got[:, c], want[:, c])) for c in exact_cols)
    return err, limit, exact


def check_radix_build(rng, case, n, D, V):
    """radix_build against its plain version at one shape.  Lane 0 is a
    lane of ones (presence counts, exact).  ``probe``: a lineitem-like
    batch (codes sorted in runs, half of the rows masked to the trash code
    D) with a count lane and a value lane; ``build``: unique keys with
    integer payload lanes (exact); edge cases: every code outside the
    domain, duplicate keys (presence > 1), a ragged n, one code for every
    row (runs across every tile)."""
    import numpy as np
    import torch
    from repro_torch.kernels.radix_join.kernel import radix_build
    from repro_torch.kernels.radix_join.ref import radix_build_ref
    dev = torch.device("cuda")
    vals_np = np.ones((V, n))
    if case in ("probe", "ragged"):
        code_np = np.sort(rng.integers(0, D, n))
        code_np[rng.random(n) < 0.5] = D                # masked: trash
        vals_np[V - 1] = rng.uniform(-1000.0, 1000.0, n)
    elif case == "all_out":
        code_np = np.where(rng.random(n) < 0.5, -1, D)
    elif case == "one_code":
        code_np = np.zeros(n, dtype=np.int64)
        vals_np[V - 1] = rng.uniform(-1000.0, 1000.0, n)
    else:                                               # build, duplicates
        code_np = rng.permutation(D)[:n]                # n <= D: unique
        if case == "duplicates":
            code_np[: n // 4] = code_np[n // 4: n // 2]
        vals_np[1:] = rng.integers(0, 20000, (V - 1, n))
    code = torch.as_tensor(code_np.astype(np.int32), device=dev)
    vals = torch.as_tensor(vals_np, device=dev)
    got = radix_build(code, vals, D)
    want = radix_build_ref(code, vals, D)
    torch.cuda.synchronize()
    exact_cols = range(V) if case in ("build", "duplicates", "all_out") \
        else [c for c in range(V - 1)]
    err, limit, exact = _sum_check(got, want,
                                   radix_build_ref(code, vals.abs(), D), n,
                                   exact_cols)
    presence_max = float(got[:, 0].max())
    ok = err <= limit and exact and bool(torch.isfinite(got).all())
    if case in ("build", "duplicates", "all_out", "one_code"):
        # the uniqueness witness the join tier reads: presence > 1 exactly
        # where a code repeats
        ok = ok and (presence_max > 1.0) == (case in ("duplicates",
                                                      "one_code"))
    ms, a_ms = device_ms(lambda: radix_build(code, vals, D))
    w_ms = wrapper_ms(lambda: radix_build(code, vals, D))
    plain_ms, a_plain = device_ms(lambda: radix_build_ref(code, vals, D))
    idx = torch.where((code >= 0) & (code < D), code, D).to(torch.int64)
    vt = vals.t()

    def library():
        return torch.zeros((D + 1, V), dtype=torch.float64,
                           device=dev).index_put_((idx,), vt,
                                                  accumulate=True)

    library_ms, a_lib = device_ms(library)
    b_ms, b_by = bound(n * 4 + V * n * 8 + D * V * 8, n * V)
    return {"kernel": "radix_build", "case": case, "n": n, "D": D, "V": V,
            "max_abs_err": err, "limit": limit, "exact": exact,
            "presence_max": presence_max, "ok": ok, "ms": ms,
            "wrapper_ms": w_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": b_ms, "bound_by": b_by,
            "queued_ahead": {"ms": a_ms, "plain_ms": a_plain,
                             "library_ms": a_lib}}


def check_radix_probe(rng, case, n, D, V):
    """radix_probe against its plain version: a gather, exact.  ``probe``
    gathers in-domain codes (the library call ``btab[code]`` needs them);
    ``all_out`` gathers codes outside [0, D) only (zeros)."""
    import numpy as np
    import torch
    from repro_torch.kernels.radix_join.kernel import radix_probe
    from repro_torch.kernels.radix_join.ref import radix_probe_ref
    dev = torch.device("cuda")
    btab = torch.as_tensor(rng.integers(0, 3, (D, V)).astype(np.float64),
                           device=dev)
    if case == "all_out":
        code_np = np.where(rng.random(n) < 0.5, -1, D)
    else:
        code_np = np.sort(rng.integers(0, D, n))
    code = torch.as_tensor(code_np.astype(np.int32), device=dev)
    got = radix_probe(code, btab)
    want = radix_probe_ref(code, btab)
    torch.cuda.synchronize()
    exact = bool(torch.equal(got, want))
    if case == "all_out":
        exact = exact and not bool(got.any())
    err = float((got - want).abs().max())
    ms, a_ms = device_ms(lambda: radix_probe(code, btab))
    w_ms = wrapper_ms(lambda: radix_probe(code, btab))
    plain_ms, a_plain = device_ms(lambda: radix_probe_ref(code, btab))
    library_ms = a_lib = None
    if case != "all_out":
        idx = code.to(torch.int64)
        library_ms, a_lib = device_ms(lambda: btab[idx])
    b_ms, b_by = bound(n * 4 + 2 * n * V * 8, 0)
    return {"kernel": "radix_probe", "case": case, "n": n, "D": D, "V": V,
            "max_abs_err": err, "exact": exact, "ok": exact, "ms": ms,
            "wrapper_ms": w_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": b_ms, "bound_by": b_by,
            "queued_ahead": {"ms": a_ms, "plain_ms": a_plain,
                             "library_ms": a_lib}}


def check_sort(rng, case, n, n_keys=1):
    """The sort kernel against its plain version: the permutation must
    equal ``torch.sort(stable=True)``'s exactly.  With ``n_keys`` > 1 the
    check is ``ops.lexsort``'s chain of kernel sorts against the same
    chain of ``torch.sort`` calls (the Q1 case: two group-key digits)."""
    import numpy as np
    import torch
    from repro_torch.kernels.sort.kernel import sort_pairs
    from repro_torch.kernels.sort.ops import lexsort
    from repro_torch.kernels.sort.ref import sort_pairs_ref
    dev = torch.device("cuda")
    if case == "equal":
        keys_np = np.zeros((n_keys, n))
    elif case == "inf":
        keys_np = rng.integers(0, 50, (n_keys, n)).astype(np.float64)
        keys_np[rng.random((n_keys, n)) < 0.2] = np.inf
    elif case == "q1":
        keys_np = rng.integers(0, 3, (n_keys, n)).astype(np.float64)
    else:
        keys_np = rng.uniform(-1e6, 1e6, (n_keys, n))
        keys_np[:, : n // 8] = np.round(keys_np[:, : n // 8] / 1e5)  # ties
    keys = [torch.as_tensor(k, device=dev) for k in keys_np]

    def plain_chain():
        perm = torch.arange(n, device=dev)
        for k in reversed(keys):
            perm = perm[sort_pairs_ref(k[perm])[1]]
        return perm

    if n_keys == 1:
        got_k, got = sort_pairs(keys[0])
        want_k, want = sort_pairs_ref(keys[0])
        keys_equal = bool(torch.equal(got_k, want_k))

        def call():
            return sort_pairs(keys[0])

        def plain():
            return sort_pairs_ref(keys[0])

        def library():
            return torch.sort(keys[0], stable=True)
    else:
        got, want, keys_equal = lexsort(keys), plain_chain(), True

        def call():
            return lexsort(keys)

        plain = library = plain_chain
    torch.cuda.synchronize()
    exact = bool(torch.equal(got, want)) and keys_equal
    ms, a_ms = device_ms(call)
    w_ms = wrapper_ms(call)
    plain_ms, a_plain = device_ms(plain)
    library_ms, a_lib = device_ms(library)
    N = 1 << max(1, (n - 1).bit_length())
    stages = N.bit_length() - 1
    b_ms, b_by = bound(n_keys * n * 24,
                       n_keys * (N // 2) * stages * (stages + 1) // 2)
    return {"kernel": "sort", "case": case, "n": n, "n_keys": n_keys,
            "max_abs_err": 0.0 if exact else float("inf"), "exact": exact,
            "ok": exact, "ms": ms, "wrapper_ms": w_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": b_ms, "bound_by": b_by,
            "queued_ahead": {"ms": a_ms, "plain_ms": a_plain,
                             "library_ms": a_lib}}


def check_imprint(case, col_np, div=1.0, base=None):
    """imprint against its plain version on the same column, exactly: a
    build is two launches (block bounds, then bounds and bitmaps over the
    column's range); an extension (``base`` = the old ``(lo, hi)``) is one
    launch binned against that range.  ``ms`` is one launch of the second
    kind, ``build_ms`` the whole build as the engine runs it (both
    launches, the range read and the fetch of the zone maps)."""
    import torch
    from repro_torch.kernels.imprint.kernel import n_blocks, zone_maps
    from repro_torch.kernels.imprint.ops import build_zone_maps, zone_range
    from repro_torch.kernels.imprint.ref import BINS, zone_maps_ref
    vals = torch.as_tensor(col_np, device=torch.device("cuda"))
    if base is None:
        got0, want0 = zone_maps(vals, div), zone_maps_ref(vals, div)
        lo, hi, inv = zone_range(*got0)
    else:
        got0 = want0 = ()
        lo, hi = base
        inv = BINS / (hi - lo) if hi > lo else 0.0
    got = zone_maps(vals, div, (lo, inv))
    want = zone_maps_ref(vals, div, (lo, inv))
    torch.cuda.synchronize()
    pairs = list(zip(got0, want0)) + list(zip(got, want))
    exact = all(bool(torch.equal(g, w)) for g, w in pairs)
    err = 0.0
    for g, w in pairs[:-1]:                    # the float64 bounds
        fin = torch.isfinite(w)
        if fin.any():
            err = max(err, float((g[fin] - w[fin]).abs().max()))
    n = vals.shape[0]
    nb = n_blocks(n)
    ms, a_ms = device_ms(lambda: zone_maps(vals, div, (lo, inv)))
    w_ms = wrapper_ms(lambda: zone_maps(vals, div, (lo, inv)))
    build_ms = wrapper_ms(lambda: build_zone_maps(vals, div), reps=10)
    plain_ms, a_plain = device_ms(
        lambda: zone_maps_ref(vals, div, (lo, inv)), reps=5)
    # one read of the column in its stored type, 18 B written a block
    b_ms, b_by = bound(n * vals.element_size() + nb * 18, 4 * n)
    return {"kernel": "imprint", "case": case, "n": n, "blocks": nb,
            "dtype": str(vals.dtype), "div": div, "lo": lo, "hi": hi,
            "max_abs_err": err, "exact": exact, "ok": exact, "ms": ms,
            "wrapper_ms": w_ms, "build_ms": build_ms, "plain_ms": plain_ms,
            "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
            "queued_ahead": {"ms": a_ms, "plain_ms": a_plain}}


def _imprint_cases(tables, rng):
    """The main path's column (SF 1 ``l_shipdate``, int32) and the edge
    cases: a ragged last block, an all-NULL block, a constant column,
    int64 with NULL sentinels, DECIMAL with scale 2 (``o_totalprice``),
    float64 with NaN, an all-NULL column, and a tail extension with values
    outside the old range."""
    import numpy as np
    n = 10 * 2048 + 777
    i64_null = np.iinfo(np.int64).min
    shipdate = np.asarray(tables["lineitem"].column("l_shipdate").data)
    price = tables["orders"].column("o_totalprice")
    ragged = rng.uniform(-100.0, 100.0, n)
    null_block = ragged.copy()
    null_block[2048:4096] = np.nan
    ints = rng.integers(-10**12, 10**12, n).astype(np.int64)
    ints[rng.random(n) < 0.2] = i64_null
    ints[:2048] = i64_null
    floats = rng.normal(0.0, 1e6, n)
    floats[rng.random(n) < 0.3] = np.nan
    tail = rng.uniform(-50.0, 150.0, 3 * 2048 + 5)
    return [
        check_imprint("l_shipdate", shipdate),
        check_imprint("ragged", ragged),
        check_imprint("null_block", null_block),
        check_imprint("constant", np.full(n, 42.5)),
        check_imprint("int64_sentinel", ints),
        check_imprint("decimal", np.asarray(price.data),
                      div=float(10 ** price.scale)),
        check_imprint("float_nan", floats),
        check_imprint("all_null", np.full(n, np.iinfo(np.int32).min,
                                          dtype=np.int32)),
        check_imprint("extension", tail, base=(0.0, 100.0)),
    ]


def phase_kernels(tables, batch_rows: int, seed: int):
    import numpy as np
    (G1, V1), (C6, P6), (D3, Vp3, Vb3) = _main_path_shapes(tables,
                                                           batch_rows)
    rng = np.random.default_rng(seed)
    ragged = batch_rows - 993          # not a multiple of any tile
    n_sort = 16384                     # Q3's ~10^4 groups, padded
    n_unique = min(batch_rows, D3)     # a build batch of unique keys
    checks = [
        check_hash_group(rng, "q1", batch_rows, G1, V1),
        check_hash_group(rng, "g4096", batch_rows, 4096, V1),
        check_hash_group(rng, "ragged", ragged, G1, V1),
        check_hash_group(rng, "all_masked", batch_rows, G1, V1),
        check_scan_agg(rng, "q6", batch_rows, C6, P6),
        check_scan_agg(rng, "ragged", ragged, C6, P6),
        check_scan_agg(rng, "all_masked", batch_rows, C6, P6),
        check_radix_build(rng, "probe", batch_rows, D3, Vp3),
        check_radix_build(rng, "build", n_unique, D3, Vb3),
        check_radix_build(rng, "all_out", batch_rows, D3, Vp3),
        check_radix_build(rng, "duplicates", n_unique, D3, Vb3),
        check_radix_build(rng, "ragged", ragged, D3, Vp3),
        check_radix_build(rng, "one_code", batch_rows, D3, Vp3),
        check_radix_probe(rng, "probe", batch_rows, D3, Vb3),
        check_radix_probe(rng, "all_out", batch_rows, D3, Vb3),
        check_radix_probe(rng, "ragged", ragged, D3, Vb3),
        check_sort(rng, "q3", n_sort),
        check_sort(rng, "q1", 4, n_keys=2),
        check_sort(rng, "ragged", n_sort - 993),
        check_sort(rng, "equal", n_sort),
        check_sort(rng, "inf", n_sort),
        check_sort(rng, "large", 100_003),
    ] + _imprint_cases(tables, rng)
    bad = [c for c in checks if not c["ok"]]
    if bad:
        emit({"phase": "kernels", "ok": False, "checks": checks})
        raise AssertionError(f"kernel checks failed: {bad}")
    return checks, {"phase": "kernels", "ok": True, "checks": checks}


def _results_equal(a: dict, b: dict) -> bool:
    import numpy as np
    if list(a) != list(b):
        return False
    for c in a:
        x, y = np.asarray(a[c]), np.asarray(b[c])
        if x.dtype == object:
            if list(map(str, x)) != list(map(str, y)):
                return False
        elif not np.array_equal(x, y, equal_nan=True):
            return False
    return True


def _close(dev: dict, host: dict, rtol: float) -> bool:
    """Floats within ``rtol``; keys, dates, counts and strings exact."""
    import numpy as np
    if list(dev) != list(host):
        return False
    for c in dev:
        x, y = np.asarray(dev[c]), np.asarray(host[c])
        if x.shape != y.shape:
            return False
        if x.dtype == object or x.dtype.kind in "iub":
            if list(map(str, x)) != list(map(str, y)):
                return False
        elif not np.allclose(x.astype(float), y.astype(float), rtol=rtol,
                             atol=0.0):
            return False
    return True


def _stream_plan(db, q: str, batch_rows: int):
    """For each table the query's device core streams: the live batches and
    the gathered (boundary) batches its plan-time skip-set implies,
    computed here from the skip-set, independently of the engine's
    streams, and whether the table has a skip-set.  Imprints are cached by
    then, so planning launches nothing."""
    import math
    from repro_torch.core.physplan import plan_physical
    from repro_torch.data import tpch_queries as Q
    phys = plan_physical(Q.ALL_QUERIES[q](db).plan, db, distributed=True)
    m = batch_rows
    out = {}
    for t in QUERY_TABLES[q]:
        n = db.table(t).num_rows
        ss = phys.skip_set_for_table(t)
        live, gathered = [], []
        for b in range(-(-n // m)):
            s, e = b * m, min(n, b * m + m)
            if ss is None:
                live.append(b)
                continue
            if not ss.batch_qualifies(s, e):
                continue
            live.append(b)
            ub = math.gcd(ss.block, m)
            slots = sum(ss.batch_qualifies(s + k * ub, min(s + k * ub + ub, e))
                        for k in range(m // ub))
            if slots < m // ub:
                gathered.append(b)
        out[t] = (live, gathered, ss is not None)
    return out


def _expected_launches(q: str, streams: dict, on_device: bool,
                       new_imprints: int) -> dict:
    """Launches of one run, kernel by kernel: one step kernel per live
    batch of each stream (Q1 and Q3 also sort by two ORDER BY keys, and Q3
    probes orders with every orders and lineitem batch and gathers the
    payload once), and two imprint launches per imprint the run built."""
    n = {t: len(v[0]) for t, v in streams.items()}
    want = {k: 0 for k in KERNELS}
    if on_device:
        want.update({
            "q1": lambda: {"hash_group": n["lineitem"], "sort": 2},
            "q6": lambda: {"scan_agg": n["lineitem"]},
            "q3": lambda: {"radix_build": n["customer"] + n["orders"]
                           + n["lineitem"],
                           "radix_probe": n["orders"] + n["lineitem"] + 1,
                           "sort": 2},
        }[q]())
    want["imprint"] = 2 * new_imprints
    return want


def _n_imprints(db) -> int:
    return sum(v is not None for v in db.index_manager.imprints.values())


def phase_engine(tables, batch_rows: int, full_scale: bool):
    """Q1, Q6 and Q3 through the entry points in every budget cell, cold
    and warm, data skipping on (the default) over tables in generator
    order.  Each run is held to the unbudgeted cold run (bit-identical),
    to the host tier (rtol=1e-9, keys exact; bit-identical where the
    planner kept the query on the host), to the budget, to the launches of
    every kernel (one step kernel per live batch, two imprint launches per
    imprint the run built), and — at SF 1 (``full_scale``), where the
    cells were sized — to its expected tier; at another scale the launches
    are held to the tier the planner picked."""
    import numpy as np
    import torch
    from repro_torch.core import startup
    from repro_torch.data import tpch_queries as Q
    counters = _launch_counters()
    nb = {n: -(-t.num_rows // batch_rows) for n, t in tables.items()}
    n_rows = {"q1": 6, "q6": 1, "q3": 10}
    cells = {}
    results = {}
    host = {}
    totals = {k: 0 for k in KERNELS}
    failures = []
    for budget in BUDGETS:
        db = startup(device="cuda", device_budget=budget,
                     device_batch_rows=batch_rows)
        _load(db, tables)
        cell = {}
        for q in QUERIES:
            query = Q.ALL_QUERIES[q]
            if q not in host:
                t0 = time.perf_counter()
                host[q] = query(db).execute().to_pydict()
                cell[f"{q}_host_ms"] = (time.perf_counter() - t0) * 1e3
            for run in ("cold", "warm"):
                n_imp = _n_imprints(db)
                for c in counters.values():
                    c.reset()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = query(db).execute(distributed=True).to_pydict()
                ms = (time.perf_counter() - t0) * 1e3
                launches = {k: c.count for k, c in counters.items()}
                st = db.last_stats
                tier_want = EXPECTED_TIER[q][budget] if full_scale \
                    else st.device_tier
                streams = _stream_plan(db, q, batch_rows)
                for k in KERNELS:
                    totals[k] += launches[k]
                ctx = f"{budget}/{q}/{run}"
                cell[f"{q}_{run}_ms"] = ms
                cell[f"{q}_{run}_h2d_bytes"] = st.device_bytes_h2d
                cell[f"{q}_{run}_launches"] = launches
                cell[f"{q}_{run}_tier"] = st.device_tier
                cell[f"{q}_{run}_blocks_skipped"] = st.blocks_skipped
                if st.device_tier != tier_want:
                    failures.append(f"{ctx}: tier {st.device_tier!r}, want "
                                    f"{tier_want!r}")
                expect = _expected_launches(q, streams, bool(tier_want),
                                            _n_imprints(db) - n_imp)
                if launches != expect:
                    failures.append(f"{ctx}: launches {launches}, want "
                                    f"{expect}")
                results[(q, run, budget)] = res
                # a device run repeats the unbudgeted cold run's bits; a
                # run the planner kept on the host repeats the host tier's
                ref, what = (results[(q, "cold", None)], "unbudgeted cold") \
                    if st.device_tier else (host[q], "host-tier")
                if not _results_equal(ref, res):
                    failures.append(f"{ctx}: not bit-identical to the "
                                    f"{what} run")
                for c, v in res.items():
                    a = np.asarray(v)
                    if a.dtype != object and not np.isfinite(
                            a.astype(float)).all():
                        failures.append(f"{ctx}: non-finite {c}")
                if len(np.asarray(res[list(res)[-1]])) != n_rows[q]:
                    failures.append(f"{ctx}: {len(res[list(res)[-1]])} "
                                    f"rows, want {n_rows[q]}")
            if not _close(results[(q, "cold", budget)], host[q], 1e-9):
                failures.append(f"{budget}/{q}: device differs from host "
                                f"tier beyond rtol=1e-9")
        cell["device_bytes_peak"] = db.buffer_manager.stats.device_bytes_peak
        cell["device_evictions"] = db.buffer_manager.stats.device_evictions
        cell["device_budget"] = budget
        if budget is not None and cell["device_bytes_peak"] > budget:
            failures.append(f"{budget}: device_bytes_peak over budget")
        cells["unbudgeted" if budget is None else str(budget)] = cell
        db.shutdown()
    out = {"phase": "engine", "ok": not failures, "batches": nb,
           "cells": cells, "launches": totals, "failures": failures}
    if failures:
        emit(out)
        raise AssertionError("; ".join(failures))
    return totals, out


def _date_sorted(tables):
    """lineitem and orders stably sorted by their date columns: the
    clustered load order the zone maps prune on (customer as generated)."""
    import numpy as np
    out = dict(tables)
    for name, col in SORT_KEYS.items():
        t = tables[name]
        out[name] = t.take(np.argsort(np.asarray(t.column(col).data),
                                      kind="stable"))
    return out


class _Instrument:
    """Records, during one run, every block key the device block cache is
    asked for (``DeviceBufferManager.get_or_put``) and the time spent
    building imprints (``indexes.build_imprint``, which ends in the host
    fetch of the zone maps)."""

    def __init__(self):
        from repro_torch.core import indexes
        from repro_torch.core.device_cache import DeviceBufferManager
        self.keys = []
        self.imprint_ms = 0.0
        self._restore = []
        real_put = DeviceBufferManager.get_or_put
        real_build = indexes.build_imprint

        def get_or_put(dm, key, *a, **kw):
            self.keys.append(key)
            return real_put(dm, key, *a, **kw)

        def build_imprint(*a, **kw):
            t0 = time.perf_counter()
            try:
                return real_build(*a, **kw)
            finally:
                self.imprint_ms += (time.perf_counter() - t0) * 1e3

        for obj, name, fn, real in (
                (DeviceBufferManager, "get_or_put", get_or_put, real_put),
                (indexes, "build_imprint", build_imprint, real_build)):
            setattr(obj, name, fn)
            self._restore.append((obj, name, real))

    def reset(self):
        self.keys = []
        self.imprint_ms = 0.0

    def batches(self, table: str):
        """(uploaded batch indices, gathered batch indices) of ``table``:
        the shard component of a block key is (device, batch_rows, b, ...)
        and a gathered batch's carries a "g" after the batch index."""
        up = {k[3][2] for k in self.keys if k[0] == table}
        g = {k[3][2] for k in self.keys if k[0] == table and len(k[3]) > 3}
        return up, g

    def close(self):
        for obj, name, real in self._restore:
            setattr(obj, name, real)


def phase_skipping(tables, batch_rows: int, full_scale: bool):
    """Q6, Q1 and Q3 over lineitem and orders in date order, at 1 GiB and
    128 MiB, with data skipping on and forced off, cold and warm.  Held to:
    bit-identical results between on and off (and across budgets and
    repeats), rtol=1e-9 against the host tier; with skipping on,
    ``blocks_skipped > 0`` and ``bytes_skipped_h2d > 0`` for Q6 and Q3; no
    block of a skipped batch asked of the block cache; one step-kernel
    launch per live batch and two imprint launches per imprint built;
    exactly the gathered batches the skip-set implies, and — at SF 1
    (``full_scale``) — at least one in every stream with a skip-set."""
    import torch
    from repro_torch.core import startup
    from repro_torch.data import tpch_queries as Q
    data = _date_sorted(tables)
    counters = _launch_counters()
    inst = _Instrument()
    totals = {k: 0 for k in KERNELS}
    results, cells, failures = {}, {}, []
    gathered_streams = {}
    try:
        for budget in SKIP_BUDGETS:
            for skipping in (True, False):
                db = startup(device="cuda", device_budget=budget,
                             device_batch_rows=batch_rows,
                             data_skipping=skipping)
                _load(db, data)
                cell = {}
                for q in SKIP_QUERIES:
                    for run in ("cold", "warm"):
                        ctx = f"{budget}/{'on' if skipping else 'off'}/" \
                              f"{q}/{run}"
                        n_imp = _n_imprints(db)
                        inst.reset()
                        for c in counters.values():
                            c.reset()
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        res = Q.ALL_QUERIES[q](db).execute(
                            distributed=True).to_pydict()
                        ms = (time.perf_counter() - t0) * 1e3
                        launches = {k: c.count for k, c in counters.items()}
                        for k in KERNELS:
                            totals[k] += launches[k]
                        st = db.last_stats
                        streams = _stream_plan(db, q, batch_rows)
                        built = _n_imprints(db) - n_imp
                        cell[f"{q}_{run}"] = {
                            "ms": ms, "imprint_build_ms": inst.imprint_ms,
                            "imprints_built": built,
                            "tier": st.device_tier,
                            "h2d_bytes": st.device_bytes_h2d,
                            "blocks_skipped": st.blocks_skipped,
                            "bytes_skipped_h2d": st.bytes_skipped_h2d,
                            "launches": launches,
                            "live_batches": {t: len(v[0])
                                             for t, v in streams.items()},
                            "gathered_batches": {t: len(v[1]) for t, v
                                                 in streams.items()}}
                        if not st.device_tier:
                            failures.append(f"{ctx}: ran on the host tier")
                        expect = _expected_launches(q, streams, True, built)
                        if launches != expect:
                            failures.append(f"{ctx}: launches {launches}, "
                                            f"want {expect}")
                        for t, (live, gath, has_ss) in streams.items():
                            up, g = inst.batches(t)
                            if not up <= set(live):
                                failures.append(
                                    f"{ctx}: skipped batches of {t} asked "
                                    f"of the cache: {sorted(up - set(live))}")
                            if g != set(gath):
                                failures.append(
                                    f"{ctx}: gathered batches of {t} "
                                    f"{sorted(g)}, want {sorted(gath)}")
                            if skipping and has_ss:
                                gathered_streams.setdefault(
                                    (q, t), set()).update(g)
                        if skipping and q in ("q6", "q3") and not (
                                st.blocks_skipped > 0
                                and st.bytes_skipped_h2d > 0):
                            failures.append(f"{ctx}: nothing skipped")
                        if not skipping and (st.blocks_skipped
                                             or st.bytes_skipped_h2d):
                            failures.append(f"{ctx}: skipped while off")
                        results[(budget, skipping, q, run)] = res
                cells[f"{budget}/{'on' if skipping else 'off'}"] = cell
                if not skipping and budget == SKIP_BUDGETS[0]:
                    host = {}
                    for q in SKIP_QUERIES:
                        t0 = time.perf_counter()
                        host[q] = Q.ALL_QUERIES[q](db).execute().to_pydict()
                        cell[f"{q}_host_ms"] = (time.perf_counter() - t0) * 1e3
                db.shutdown()
    finally:
        inst.close()
    for q in SKIP_QUERIES:
        first = results[(SKIP_BUDGETS[0], True, q, "cold")]
        for key, res in results.items():
            if key[2] == q and not _results_equal(first, res):
                failures.append(f"{key}: not bit-identical to skipping-on "
                                f"cold at {SKIP_BUDGETS[0]}")
        if not _close(first, host[q], 1e-9):
            failures.append(f"{q}: device differs from host tier beyond "
                            f"rtol=1e-9")
    for (q, t), g in gathered_streams.items():
        if full_scale and not g:
            failures.append(f"{q}/{t}: no gathered batch ran")
    for k in KERNELS:
        if totals[k] == 0:
            failures.append(f"{k} was never launched in the skipping phase")
    out = {"phase": "skipping", "ok": not failures, "cells": cells,
           "launches": totals,
           "gathered_batches": {f"{q}/{t}": sorted(g)
                                for (q, t), g in gathered_streams.items()},
           "failures": failures}
    if failures:
        emit(out)
        raise AssertionError("; ".join(failures))
    return totals, out


def nvidia_smi_line() -> str:
    proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60)
    if proc.returncode != 0 or not proc.stdout.strip():
        raise RuntimeError(f"nvidia-smi failed: {proc.stderr}")
    return proc.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sf", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--batch-rows", type=int, default=1 << 16)
    args = ap.parse_args(argv)
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository (no "
              "src/repro_torch next to this script)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    state = {}

    def run(name, fn):
        try:
            return fn()
        except Exception:
            traceback.print_exc()
            emit({"phase": name, "ok": False})
            raise

    try:
        emit(run("build", phase_build))
        tables, line = run("data", lambda: phase_data(args.sf, args.seed))
        emit(line)
        checks, line = run("kernels", lambda: phase_kernels(
            tables, args.batch_rows, args.seed))
        emit(line)
        totals, line = run("engine", lambda: phase_engine(
            tables, args.batch_rows, args.sf == 1.0))
        emit(line)
        skip_totals, line = run("skipping", lambda: phase_skipping(
            tables, args.batch_rows, args.sf == 1.0))
        emit(line)
        state["smi"] = run("nvidia-smi", nvidia_smi_line)
    except Exception:
        return 1

    main_case = {"hash_group": "q1", "scan_agg": "q6", "radix_build": "probe",
                 "radix_probe": "probe", "sort": "q3", "imprint": "l_shipdate"}
    meta = {
        "hash_group": ("src/repro_torch/csrc/hash_group.cu",
                       "src/repro/kernels/hash_group/hash_group.py:54"),
        "scan_agg": ("src/repro_torch/csrc/scan_agg.cu",
                     "src/repro/kernels/scan_agg/scan_agg.py:66"),
        "radix_build": ("src/repro_torch/csrc/radix_join.cu",
                        "src/repro/kernels/radix_join/radix_join.py:79"),
        "radix_probe": ("src/repro_torch/csrc/radix_join.cu",
                        "src/repro/kernels/radix_join/radix_join.py:103"),
        "sort": ("src/repro_torch/csrc/sort.cu",
                 "src/repro/kernels/sort/sort.py:70"),
        "imprint": ("src/repro_torch/csrc/imprint.cu",
                    "src/repro/kernels/imprint/imprint.py:57"),
    }
    summary = []
    for name in KERNELS:
        c = next(c for c in checks
                 if c["kernel"] == name and c["case"] == main_case[name])
        if totals[name] == 0:
            print(f"chip_smoke: {name} was never launched on the main path",
                  file=sys.stderr)
            return 1
        summary.append({
            "name": name, "route": "cuda", "source": meta[name][0],
            "replaces": meta[name][1],
            "launches": totals[name] + skip_totals[name],
            "max_abs_err": c["max_abs_err"], "ms": c["ms"],
            "wrapper_ms": c["wrapper_ms"], "plain_ms": c["plain_ms"],
            "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
            "library_ms": c["library_ms"]})
    emit({"kernels": summary})
    print(state["smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
