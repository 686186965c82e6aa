"""The port's engine (repro_torch) against the reference engine (repro) on
the CPU, at TPC-H sf 0.01 with ``device_batch_rows=4096``.

Both packages load the same ``tpch.generate`` arrays.  The port runs with
``device="cpu"``, where its batch step is the same torch program it runs
on the card and each kernel wrapper takes its plain version.  Contracts:

* device tier vs the reference's device tier: ``rtol=1e-9``; group keys,
  strings and counts exact;
* host tier vs the reference's host tier: bit-identical;
* the port's budget matrix (unbudgeted / generous / tight) bit-identical,
  ``device_bytes_peak <= budget``, tight = streamed with evictions; a
  repeat is served from the cache with no new host→device bytes; a tiny
  budget keeps the query on the planner's host tier;
* the route: Q6 takes the ``scan_agg`` kernel, Q1 ``hash_group``;
* a failing kernel makes the query raise — no fallback to the host.
"""

import numpy as np
import pytest
import torch

import repro.core as R
import repro.data.tpch_queries as RQ
import repro_torch.core as T
import repro_torch.data.tpch_queries as TQ
from repro.data import tpch
from repro_torch.core import parallel as tparallel
from repro_torch.data import load_tables
from repro_torch.kernels.hash_group import kernel as hk
from repro_torch.kernels.scan_agg import kernel as sk

BATCH = 4096
GENEROUS = 64 << 20
TIGHT = 512 << 10          # > 2 batch working sets, < the table: streams
TINY = 8 << 10             # < one batch working set: host tier
QUERIES = ("q1", "q6", "q1_minmax")


@pytest.fixture(scope="module")
def lineitem():
    return tpch.generate(0.01)["lineitem"]


def _q1_minmax(pkg, db):
    """The Q1 shape with min/max of tests/test_device_cache.py."""
    return (db.scan("lineitem")
            .filter(pkg.Col("l_shipdate") <= pkg.DateLit("1998-09-02"))
            .group_by("l_returnflag", "l_linestatus")
            .agg(sum_qty=("sum", pkg.Col("l_quantity")),
                 sum_base_price=("sum", pkg.Col("l_extendedprice")),
                 avg_qty=("avg", pkg.Col("l_quantity")),
                 min_qty=("min", pkg.Col("l_quantity")),
                 max_disc=("max", pkg.Col("l_discount")),
                 count_order=("count", None)))


def _query(pkg, db, name):
    if name == "q1_minmax":
        return _q1_minmax(pkg, db)
    return (RQ if pkg is R else TQ).ALL_QUERIES[name](db)


def _port_db(lineitem, budget=None):
    db = T.startup(device="cpu", device_budget=budget,
                   device_batch_rows=BATCH)
    load_tables(db, {"lineitem": lineitem})
    return db


def _ref_db(lineitem):
    li, types, scales = lineitem
    db = R.startup(device_batch_rows=BATCH, data_skipping=False)
    db.create_table("lineitem", li, types, scales)
    return db


@pytest.fixture(scope="module")
def reference(lineitem):
    """The reference engine's device-tier and host-tier results."""
    db = _ref_db(lineitem)
    out = {}
    for q in QUERIES:
        dev = _query(R, db, q).execute(distributed=True).to_pydict()
        assert db.last_stats.device_tier == "resident"
        out[q] = (dev, _query(R, db, q).execute().to_pydict())
    return out


def _run(db, q, **kw):
    return _query(T, db, q).execute(**kw).to_pydict()


def _assert_bits(a: dict, b: dict, ctx: str):
    assert list(a) == list(b), ctx
    for c in a:
        av, bv = np.asarray(a[c]), np.asarray(b[c])
        if av.dtype == object:
            assert list(map(str, av)) == list(map(str, bv)), (ctx, c)
        else:
            np.testing.assert_array_equal(av, bv, err_msg=f"{ctx} col={c}")


def _assert_close(dev: dict, ref: dict, ctx: str):
    """Floats at rtol=1e-9; keys, strings and counts exact."""
    assert list(dev) == list(ref), ctx
    for c in dev:
        a, b = np.asarray(dev[c]), np.asarray(ref[c])
        assert a.shape == b.shape, (ctx, c)
        if a.dtype == object or a.dtype.kind in "iub":
            assert list(map(str, a)) == list(map(str, b)), (ctx, c)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-9, atol=0,
                                       err_msg=f"{ctx} col={c}")


# ---------------------------------------------------------------------------
# against the reference engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("q", QUERIES)
def test_device_tier_matches_reference_device_tier(lineitem, reference, q):
    db = _port_db(lineitem)
    dev = _run(db, q, distributed=True)
    assert db.last_stats.device_tier == "resident"
    _assert_close(dev, reference[q][0], f"{q} device vs reference device")
    # and the port's own host tier, as the chip smoke run checks it
    _assert_close(dev, _run(db, q), f"{q} device vs port host")


@pytest.mark.parametrize("q", QUERIES)
def test_host_tier_bit_identical_to_reference_host_tier(lineitem, reference,
                                                        q):
    db = _port_db(lineitem)
    _assert_bits(_run(db, q), reference[q][1], f"{q} host vs reference host")
    assert db.last_stats.device_tier == ""


# ---------------------------------------------------------------------------
# the port's budget matrix
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("q", QUERIES)
def test_budget_matrix_bit_identical(lineitem, q):
    cells, stats, tiers = {}, {}, {}
    for budget in (None, GENEROUS, TIGHT):
        db = _port_db(lineitem, budget)
        cells[budget] = _run(db, q, distributed=True)
        stats[budget] = db.buffer_manager.stats
        tiers[budget] = db.last_stats.device_tier
    for budget in (GENEROUS, TIGHT):
        _assert_bits(cells[None], cells[budget], f"{q} budget={budget}")
        assert stats[budget].device_bytes_peak <= budget
    assert tiers == {None: "resident", GENEROUS: "resident",
                     TIGHT: "streamed"}
    assert stats[TIGHT].device_evictions > 0
    assert stats[GENEROUS].device_evictions == 0


def test_streamed_prefetch_overlaps(lineitem):
    db = _port_db(lineitem, TIGHT)
    _run(db, "q1", distributed=True)
    assert db.last_stats.device_prefetch_hits > 0


def test_repeated_query_hits_cache_no_new_h2d(lineitem):
    db = _port_db(lineitem, GENEROUS)
    first = _run(db, "q1", distributed=True)
    assert db.last_stats.device_bytes_h2d > 0
    assert db.last_stats.device_cache_hits == 0
    second = _run(db, "q1", distributed=True)
    assert db.last_stats.device_cache_hits > 0
    assert db.last_stats.device_bytes_h2d == 0
    _assert_bits(first, second, "repeat")


def test_unbudgeted_does_not_retain_blocks(lineitem):
    db = _port_db(lineitem)
    _run(db, "q6", distributed=True)
    assert db.device_manager.resident_blocks == 0
    assert db.last_stats.device_tier == "resident"


def test_tiny_budget_stays_on_host_tier(lineitem, reference):
    db = _port_db(lineitem, TINY)
    calls = hk.CALLS.count
    res = _run(db, "q1", distributed=True)
    assert db.last_stats.device_tier == ""          # the planner's decision
    assert db.buffer_manager.stats.device_bytes_h2d == 0
    assert hk.CALLS.count == calls
    _assert_bits(res, reference["q1"][1], "tiny budget vs reference host")


def test_append_gets_fresh_blocks(lineitem):
    li = lineitem[0]
    db = _port_db(lineitem, GENEROUS)
    base = _run(db, "q1", distributed=True)
    db.append("lineitem", {c: np.asarray(v[:1]) for c, v in li.items()})
    bumped = _run(db, "q1", distributed=True)
    assert db.last_stats.device_bytes_h2d > 0
    assert sum(bumped["count_order"]) == sum(base["count_order"]) + 1


# ---------------------------------------------------------------------------
# kernel routes and failures
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("q,route,other", [("q6", sk, hk), ("q1", hk, sk)])
def test_route_shown_by_wrapper_counters(lineitem, q, route, other):
    db = _port_db(lineitem)
    n_batches = -(-db.table("lineitem").num_rows // BATCH)
    before, before_other = route.CALLS.count, other.CALLS.count
    _run(db, q, distributed=True)
    assert route.CALLS.count - before == n_batches
    assert other.CALLS.count == before_other


@pytest.mark.parametrize("q,name", [("q1", "hash_group"),
                                    ("q6", "scan_agg")])
def test_failing_kernel_raises_without_host_fallback(lineitem, monkeypatch,
                                                     q, name):
    def broken(*args, **kw):
        raise RuntimeError(f"{name} failed to launch")

    monkeypatch.setattr(tparallel, name, broken)
    tparallel._STEP_CACHE.clear()          # steps bind the kernel at build
    db = _port_db(lineitem)
    with pytest.raises(RuntimeError, match=name):
        _run(db, q, distributed=True)
    assert db.last_stats.device_tier == ""
    assert db.last_stats.instructions == 0   # no host program ran either
    monkeypatch.undo()
    tparallel._STEP_CACHE.clear()


def test_scan_agg_route_bounds_are_exact(lineitem):
    """Strict bounds become inclusive float64 bounds that select exactly
    the rows the reference's comparison selects."""
    db = _port_db(lineitem)
    from repro_torch.core.physplan import plan_physical
    spec = plan_physical(TQ.q6(db).plan, db, distributed=True).scan_agg
    route = tparallel.scan_agg_route(spec, db.table("lineitem"))
    assert route is not None and len(route.pairs) == 1
    li = lineitem[0]
    ship = li["l_shipdate"].astype(np.float64)
    (lo, hi) = route.bounds[route.columns.index("l_shipdate")]
    want = (li["l_shipdate"] >= 8766) & (li["l_shipdate"] < 9131)
    np.testing.assert_array_equal((ship >= lo) & (ship <= hi), want)
    qty = li["l_quantity"].astype(np.float64)
    (lo, hi) = route.bounds[route.columns.index("l_quantity")]
    np.testing.assert_array_equal((qty >= lo) & (qty <= hi), qty < 24)


# ---------------------------------------------------------------------------
# the entry point's contract
# ---------------------------------------------------------------------------


def test_startup_runs_on_cuda_unless_asked_for_cpu():
    if torch.cuda.is_available():
        assert T.startup().device.type == "cuda"
    else:
        with pytest.raises(T.DatabaseError, match="device='cpu'"):
            T.startup()
    assert T.startup(device="cpu").device.type == "cpu"


@pytest.mark.parametrize("kw", [{"path": "db"}, {"memory_budget": 1 << 20}])
def test_unported_options_raise(kw):
    with pytest.raises(NotImplementedError, match="slice"):
        T.startup(device="cpu", **kw)


def test_snapshot_query_sees_own_writes(lineitem):
    li = lineitem[0]
    db = _port_db(lineitem, GENEROUS)
    con = db.connect()
    base = _run(db, "q6", distributed=True)
    con.begin()
    con.append("lineitem", {c: np.asarray(v[:0]) for c, v in li.items()})
    res = con.query(TQ.q6(db), distributed=True).to_pydict()
    con.rollback()
    _assert_bits(base, res, "snapshot")
