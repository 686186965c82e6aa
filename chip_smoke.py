#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Builds the port's hand-written kernels from ``src/repro_torch/csrc``,
holds each against its plain PyTorch version on the card, and runs TPC-H
Q1 and Q6 at scale factor 1 (6,000,000 lineitem rows, seed 7) through the
port's entry points — ``startup(device="cuda", device_budget=B)``, the
builder API, ``Query.execute(distributed=True)`` — in three device-budget
cells.  A kernel's ``ms``, ``plain_ms`` and ``library_ms`` are the card's
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
BUDGETS = (None, 1 * GiB, 64 * MiB)
EXPECTED_TIER = {None: "resident", 1 * GiB: "resident", 64 * MiB: "streamed"}
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


def phase_build():
    from repro_torch.kernels import cuda_build
    from repro_torch.kernels.hash_group import kernel as hk
    from repro_torch.kernels.scan_agg import kernel as sk
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=2) as pool:   # one nvcc each
        futs = [pool.submit(cuda_build.load, "hash_group", hk._bind),
                pool.submit(cuda_build.load, "scan_agg", sk._bind)]
        for f in futs:
            f.result()
    return {"phase": "build", "seconds": time.perf_counter() - t0,
            "nvcc_seconds": {n: cuda_build.build_seconds(n)
                             for n in ("hash_group", "scan_agg")}}


def phase_data(sf: float, seed: int):
    from repro_torch.core import Table
    from repro_torch.data import tpch
    t0 = time.perf_counter()
    arrays, types, scales = tpch.generate(sf, seed)["lineitem"]
    gen = time.perf_counter() - t0
    table = Table.from_dict("lineitem", arrays, types, scales)
    return table, {"phase": "data", "sf": sf, "seed": seed,
                   "lineitem_rows": table.num_rows,
                   "generate_seconds": gen,
                   "encode_seconds": time.perf_counter() - t0 - gen}


def _main_path_shapes(table, batch_rows):
    """Q1's (G, V) and Q6's (C, P) as the engine's planner derives them."""
    from repro_torch.core import startup
    from repro_torch.core.parallel import scan_agg_route
    from repro_torch.core.physplan import partial_layout, plan_physical
    from repro_torch.data import tpch_queries as Q
    db = startup(device="cuda", device_batch_rows=batch_rows)
    db.create_table("lineitem", table)
    s1 = plan_physical(Q.q1(db).plan, db, distributed=True).scan_agg
    s6 = plan_physical(Q.q6(db).plan, db, distributed=True).scan_agg
    route = scan_agg_route(s6, db.table("lineitem"))
    if route is None or scan_agg_route(s1, db.table("lineitem")) is not None:
        raise AssertionError("Q6 must take the scan_agg route, Q1 hash_group")
    db.shutdown()
    return ((s1.n_groups, partial_layout(s1).n_sum),
            (len(route.columns), len(route.pairs)))


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


def phase_kernels(table, batch_rows: int, seed: int):
    import numpy as np
    (G1, V1), (C6, P6) = _main_path_shapes(table, batch_rows)
    rng = np.random.default_rng(seed)
    ragged = batch_rows - 993          # not a multiple of any tile
    checks = [
        check_hash_group(rng, "q1", batch_rows, G1, V1),
        check_hash_group(rng, "g4096", batch_rows, 4096, V1),
        check_hash_group(rng, "ragged", ragged, G1, V1),
        check_hash_group(rng, "all_masked", batch_rows, G1, V1),
        check_scan_agg(rng, "q6", batch_rows, C6, P6),
        check_scan_agg(rng, "ragged", ragged, C6, P6),
        check_scan_agg(rng, "all_masked", batch_rows, C6, P6),
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
    import numpy as np
    if list(dev) != list(host):
        return False
    for c in dev:
        x, y = np.asarray(dev[c]), np.asarray(host[c])
        if x.dtype == object:
            if list(map(str, x)) != list(map(str, y)):
                return False
        elif x.shape != y.shape or not np.allclose(
                x.astype(float), y.astype(float), rtol=rtol, atol=0.0):
            return False
    return True


def phase_engine(table, batch_rows: int):
    """Q1 and Q6 through the entry points in every budget cell."""
    import numpy as np
    import torch
    from repro_torch.core import startup
    from repro_torch.data import tpch_queries as Q
    from repro_torch.kernels.hash_group import kernel as hk
    from repro_torch.kernels.scan_agg import kernel as sk
    route_of = {"q1": hk, "q6": sk}
    other = {"q1": sk, "q6": hk}
    n_batches = -(-table.num_rows // batch_rows)
    cells = {}
    results = {}
    host = {}
    totals = {"hash_group": 0, "scan_agg": 0}
    failures = []
    for budget in BUDGETS:
        db = startup(device="cuda", device_budget=budget,
                     device_batch_rows=batch_rows)
        db.create_table("lineitem", table)
        cell = {}
        for q in ("q1", "q6"):
            query = Q.ALL_QUERIES[q]
            for run in ("cold", "warm"):
                hk.LAUNCHES.reset()
                sk.LAUNCHES.reset()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = query(db).execute(distributed=True).to_pydict()
                ms = (time.perf_counter() - t0) * 1e3
                st = db.last_stats
                launches = route_of[q].LAUNCHES.count
                stray = other[q].LAUNCHES.count
                totals["hash_group"] += hk.LAUNCHES.count
                totals["scan_agg"] += sk.LAUNCHES.count
                cell[f"{q}_{run}_ms"] = ms
                cell[f"{q}_{run}_h2d_bytes"] = st.device_bytes_h2d
                cell[f"{q}_{run}_launches"] = launches
                cell[f"{q}_{run}_tier"] = st.device_tier
                if st.device_tier != EXPECTED_TIER[budget]:
                    failures.append(f"{budget}/{q}/{run}: tier "
                                    f"{st.device_tier!r}")
                if launches != n_batches or stray != 0:
                    failures.append(f"{budget}/{q}/{run}: launches "
                                    f"{launches} (+{stray} other), want "
                                    f"{n_batches}")
                key = (q, run, budget)
                results[key] = res
                ref = results[(q, "cold", None)]
                if not _results_equal(ref, res):
                    failures.append(f"{budget}/{q}/{run}: not bit-identical "
                                    f"to the unbudgeted cold run")
                for c, v in res.items():
                    a = np.asarray(v)
                    if a.dtype != object and not np.isfinite(
                            a.astype(float)).all():
                        failures.append(f"{budget}/{q}: non-finite {c}")
            if q not in host:
                t0 = time.perf_counter()
                host[q] = query(db).execute().to_pydict()
                cell[f"{q}_host_ms"] = (time.perf_counter() - t0) * 1e3
                if not _close(results[(q, "cold", budget)], host[q], 1e-9):
                    failures.append(f"{q}: device differs from host tier "
                                    f"beyond rtol=1e-9")
        cell["device_bytes_peak"] = db.buffer_manager.stats.device_bytes_peak
        cell["device_evictions"] = db.buffer_manager.stats.device_evictions
        cell["device_budget"] = budget
        if budget is not None and cell["device_bytes_peak"] > budget:
            failures.append(f"{budget}: device_bytes_peak over budget")
        cells["unbudgeted" if budget is None else str(budget)] = cell
        db.shutdown()
    if len(results[("q1", "cold", None)]["l_returnflag"]) != 6 \
            or len(results[("q6", "cold", None)]["revenue"]) != 1:
        failures.append("unexpected result shapes")
    out = {"phase": "engine", "ok": not failures, "rows": table.num_rows,
           "batches": n_batches, "cells": cells, "launches": totals,
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
        table, line = run("data", lambda: phase_data(args.sf, args.seed))
        emit(line)
        checks, line = run("kernels", lambda: phase_kernels(
            table, args.batch_rows, args.seed))
        emit(line)
        totals, line = run("engine", lambda: phase_engine(
            table, args.batch_rows))
        emit(line)
        state["smi"] = run("nvidia-smi", nvidia_smi_line)
    except Exception:
        return 1

    main_case = {"hash_group": "q1", "scan_agg": "q6"}
    meta = {
        "hash_group": ("src/repro_torch/csrc/hash_group.cu",
                       "src/repro/kernels/hash_group/hash_group.py:26"),
        "scan_agg": ("src/repro_torch/csrc/scan_agg.cu",
                     "src/repro/kernels/scan_agg/scan_agg.py:37"),
    }
    summary = []
    for name in ("hash_group", "scan_agg"):
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
            "wrapper_ms": c["wrapper_ms"], "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
            "bound_by": c["bound_by"], "library_ms": c["library_ms"]})
    emit({"kernels": summary})
    print(state["smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
