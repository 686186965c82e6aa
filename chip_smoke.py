#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Builds the port's hand-written kernels from ``src/repro_torch/csrc``,
holds each against its plain PyTorch version on the card, and runs TPC-H
Q1, Q6 and Q3 at scale factor 1 (6,000,000 lineitem, 1,500,000 orders and
150,000 customer rows, seed 7) through the port's entry points —
``startup(device="cuda", device_budget=B)``, the builder API,
``Query.execute(distributed=True)`` — in four device-budget cells.  A kernel's ``ms``, ``plain_ms`` and ``library_ms`` are the card's
time for calls queued ahead of it (``device_ms``); ``wrapper_ms`` adds the
host's per-call cost.  Prints one JSON object per phase, then a summary line of every
kernel, the card's name and power limit (as ``nvidia-smi`` gives them) and
a last line ``{"ok": true, "device": {...}}``.  Exits non-zero, without
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
KERNELS = ("hash_group", "scan_agg", "radix_build", "radix_probe", "sort")
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
    from repro_torch.kernels.radix_join import kernel as rk
    from repro_torch.kernels.scan_agg import kernel as sk
    from repro_torch.kernels.sort import kernel as so
    return {"hash_group": hk.LAUNCHES, "scan_agg": sk.LAUNCHES,
            "radix_build": rk.BUILD_LAUNCHES,
            "radix_probe": rk.PROBE_LAUNCHES, "sort": so.LAUNCHES}


def phase_build():
    from repro_torch.kernels import cuda_build
    from repro_torch.kernels.hash_group import kernel as hk
    from repro_torch.kernels.radix_join import kernel as rk
    from repro_torch.kernels.scan_agg import kernel as sk
    from repro_torch.kernels.sort import kernel as so
    libs = {"hash_group": hk._bind, "scan_agg": sk._bind,
            "radix_join": rk._bind, "sort": so._bind}
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
    ]
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


def phase_engine(tables, batch_rows: int, full_scale: bool):
    """Q1, Q6 and Q3 through the entry points in every budget cell, cold
    and warm.  Each run is held to the unbudgeted cold run (bit-identical),
    to the host tier (rtol=1e-9, keys exact; bit-identical where the
    planner kept the query on the host), to the budget, to the
    launches of every kernel, and — at SF 1 (``full_scale``), where the
    cells were sized — to its expected tier; at another scale the launches
    are held to the tier the planner picked."""
    import numpy as np
    import torch
    from repro_torch.core import startup
    from repro_torch.data import tpch_queries as Q
    counters = _launch_counters()
    nb = {n: -(-t.num_rows // batch_rows) for n, t in tables.items()}
    # launches per device run, kernel by kernel (every other kernel: 0).
    # Q1 and Q3 sort by two ORDER BY keys: two sort launches each.  Q3
    # builds customer then orders (probing customer), then probes orders
    # with every lineitem batch and gathers the payload once.
    want = {
        "q1": {"hash_group": nb["lineitem"], "sort": 2},
        "q6": {"scan_agg": nb["lineitem"]},
        "q3": {"radix_build": nb["customer"] + nb["orders"]
               + nb["lineitem"],
               "radix_probe": nb["orders"] + nb["lineitem"] + 1,
               "sort": 2},
    }
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
                for c in counters.values():
                    c.reset()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = query(db).execute(distributed=True).to_pydict()
                ms = (time.perf_counter() - t0) * 1e3
                st = db.last_stats
                tier_want = EXPECTED_TIER[q][budget] if full_scale \
                    else st.device_tier
                launches = {k: c.count for k, c in counters.items()}
                for k in KERNELS:
                    totals[k] += launches[k]
                ctx = f"{budget}/{q}/{run}"
                cell[f"{q}_{run}_ms"] = ms
                cell[f"{q}_{run}_h2d_bytes"] = st.device_bytes_h2d
                cell[f"{q}_{run}_launches"] = launches
                cell[f"{q}_{run}_tier"] = st.device_tier
                if st.device_tier != tier_want:
                    failures.append(f"{ctx}: tier {st.device_tier!r}, want "
                                    f"{tier_want!r}")
                expect = {k: want[q].get(k, 0) if tier_want else 0
                          for k in KERNELS}
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
        state["smi"] = run("nvidia-smi", nvidia_smi_line)
    except Exception:
        return 1

    main_case = {"hash_group": "q1", "scan_agg": "q6", "radix_build": "probe",
                 "radix_probe": "probe", "sort": "q3"}
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
            "replaces": meta[name][1], "launches": totals[name],
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
