"""Imprints (zone maps), order indexes and their lifecycle in the port
(repro_torch) against the reference (repro), on the CPU: the cases of
tests/test_indexes.py that need no SQL text, plus the candidate-superset
properties of tests/test_property.py, on the same seeded numpy data.  The
port builds its imprints through the imprint kernel's wrapper, which runs
the plain version on a CPU database; the imprints must equal the
reference's bit for bit."""

import numpy as np
import pytest
from hypothesis import assume, given, settings, strategies as st

import repro.core as R
import repro_torch.core as T
from repro_torch.core.indexes import IMPRINT_BLOCK, build_imprint
from repro_torch.kernels.imprint import kernel as ik


def _tables(rng):
    n = 50_000
    return {
        "x": np.sort(rng.uniform(0, 1000, n)),       # clustered -> skippable
        "r": rng.uniform(0, 1000, n),                # random -> few skips
        "k": rng.integers(0, 50, n).astype(np.int64),
    }


@pytest.fixture
def data(rng):
    return _tables(rng)


def _mk(pkg, tables):
    db = pkg.startup(device="cpu") if pkg is T else pkg.startup()
    for name, cols in tables.items():
        db.create_table(name, cols)
    return db


@pytest.fixture
def idb(data):
    return _mk(T, {"t": data})


@pytest.fixture
def rdb(data):
    db = _mk(R, {"t": data})
    yield db
    db.shutdown()


def _assert_same_imprint(a, b):
    np.testing.assert_array_equal(a.mins, b.mins)
    np.testing.assert_array_equal(a.maxs, b.maxs)
    np.testing.assert_array_equal(a.bitmaps, b.bitmaps)
    assert a.bitmaps.dtype == b.bitmaps.dtype == np.uint16
    assert (a.lo, a.hi, a.n_rows, a.block) == (b.lo, b.hi, b.n_rows,
                                               b.block)


@pytest.mark.parametrize("col", ["x", "r", "k"])
def test_imprint_equals_reference(idb, rdb, col):
    _assert_same_imprint(idb.index_manager.get_imprint("t", col),
                         rdb.index_manager.get_imprint("t", col))


def test_imprint_mask_equals_naive(idb, rdb):
    im = idb.index_manager.imprint_mask("t", "x", 100.0, 200.0, False, False)
    assert im is not None
    mask, skipped = im
    x = np.asarray(idb.table("t").columns["x"].data)
    np.testing.assert_array_equal(mask, (x >= 100.0) & (x <= 200.0))
    assert skipped == rdb.index_manager.imprint_mask(
        "t", "x", 100.0, 200.0, False, False)[1]


def test_imprint_skips_blocks_on_clustered_data(idb):
    _mask, skipped = idb.index_manager.imprint_mask(
        "t", "x", 100.0, 120.0, False, False)
    n_blocks = -(-idb.table("t").num_rows // IMPRINT_BLOCK)
    assert skipped > 0.5 * n_blocks     # most blocks pruned


def test_imprint_strict_bounds(idb):
    x = np.asarray(idb.table("t").columns["x"].data)
    lo = float(np.quantile(x, 0.3))
    mask, _ = idb.index_manager.imprint_mask("t", "x", lo, np.inf,
                                             True, False)
    np.testing.assert_array_equal(mask, x > lo)


def test_imprint_used_by_executor(idb, rdb):
    def q(pkg, db):
        return db.scan("t").filter((pkg.Col("x") >= 100.0)
                                   & (pkg.Col("x") <= 200.0)) \
            .agg(n=("count", None))

    got = q(T, idb).execute().to_pydict()
    x = np.asarray(idb.table("t").columns["x"].data)
    assert got["n"][0] == ((x >= 100) & (x <= 200)).sum()
    assert idb.last_stats.index_hits >= 1
    assert idb.last_stats.imprint_blocks_skipped > 0
    q(R, rdb).execute()
    assert idb.last_stats.imprint_blocks_skipped \
        == rdb.last_stats.imprint_blocks_skipped


def test_imprint_nulls_excluded():
    v = np.arange(5000, dtype=np.float64)
    v[::7] = np.nan
    db = _mk(T, {"n": {"v": v}})
    mask, _ = db.index_manager.imprint_mask("n", "v", 10, 100, False, False)
    np.testing.assert_array_equal(mask, (v >= 10) & (v <= 100) & ~np.isnan(v))


def test_order_index_point_lookup(idb):
    rows = idb.index_manager.point_lookup("t", "k", 7)
    k = np.asarray(idb.table("t").columns["k"].data)
    assert sorted(rows.tolist()) == sorted(np.nonzero(k == 7)[0].tolist())


def test_auto_order_index_on_join(idb, rdb, rng):
    probe = {"k": rng.integers(0, 50, 5000).astype(np.int64),
             "v": rng.uniform(0, 1, 5000)}
    got = {}
    for pkg, db in ((T, idb), (R, rdb)):
        db.create_table("probe", probe)
        got[pkg] = db.scan("probe").join(db.scan("t"), on="k") \
            .agg(n=("count", None)).execute().to_pydict()
    assert idb.last_stats.index_hits >= 1
    assert idb.last_stats.index_hits == rdb.last_stats.index_hits
    assert list(got[T]["n"]) == list(got[R]["n"])
    assert (idb.index_manager.get_order_index("t", "k") is not None
            or idb.index_manager.get_order_index("probe", "k") is not None)


def test_index_invalidated_on_append(idb):
    idb.index_manager.create_order_index("t", "k")
    assert idb.index_manager.get_order_index("t", "k") is not None
    idb.append("t", {"x": np.array([1.0]), "r": np.array([2.0]),
                     "k": np.array([3], dtype=np.int64)})
    assert idb.index_manager.get_order_index("t", "k") is None


def test_imprint_pallas_matches_host(rng):
    """test_indexes.py's data through the reference's Pallas kernel in
    interpret mode: the port's imprint (here its plain version) has the
    same bitmaps, and the Pallas bounds enclose the port's exact ones."""
    import torch
    from repro.kernels.imprint import ops as ref_iops
    from repro_torch.kernels.imprint import ops as iops
    vals = rng.uniform(-50, 50, 10_000)
    nulls = rng.random(10_000) < 0.05
    got = iops.build_zone_maps(torch.as_tensor(np.where(nulls, np.nan,
                                                        vals)))
    m_pal = ref_iops.build_zone_maps_pallas(vals, nulls, 2048, 16,
                                            interpret=True)
    assert (got[2] == m_pal[2]).all()
    assert (m_pal[0] <= got[0]).all() and (m_pal[1] >= got[1]).all()


def test_small_columns_not_indexed():
    db = _mk(T, {"small": {"v": np.arange(10, dtype=np.float64)}})
    assert db.index_manager.get_imprint("small", "v") is None


def test_create_order_index_then_merge_join(idb):
    """CREATE ORDER INDEX through the API; the merge-join tactic then hits
    the persisted index."""
    idb.create_order_index("t", "k")
    assert idb.index_manager.get_order_index("t", "k") is not None
    idb.create_table("p2", {"k": np.arange(50, dtype=np.int64).repeat(100)})
    idb.scan("p2").join(idb.scan("t"), on="k") \
        .agg(n=("count", None)).execute()
    assert idb.last_stats.index_hits >= 1


def test_db_create_order_index_api(idb):
    perm = idb.create_order_index("t", "x")
    x = np.asarray(idb.table("t").columns["x"].data)
    assert (x[perm[:-1]] <= x[perm[1:]]).all()


def test_shutdown_clears_indexes(idb):
    idb.index_manager.get_imprint("t", "x")
    idb.create_order_index("t", "k")
    idb.shutdown()
    assert not idb.index_manager.imprints
    assert not idb.index_manager.order_indexes


# ---------------------------------------------------------------------------
# the imprint lifecycle: extension on append, build through the kernel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tail", [1, 700, 5000])
def test_imprint_extended_on_append_like_reference(data, tail, rng):
    """An append extends the imprint (old complete blocks kept, the tail
    binned against the old range, values outside it included) exactly as
    the reference's ``_extend_imprint`` does."""
    idb, rdb = _mk(T, {"t": data}), _mk(R, {"t": data})
    for db in (idb, rdb):
        for c in ("x", "r", "k"):
            db.index_manager.get_imprint("t", c)
    extra = {"x": rng.uniform(-500, 1500, tail),
             "r": rng.uniform(0, 1000, tail),
             "k": rng.integers(-100, 100, tail).astype(np.int64)}
    calls = ik.CALLS.count
    for db in (idb, rdb):
        db.append("t", extra)
    assert ik.CALLS.count - calls == 3      # one launch per extended column
    for c in ("x", "r", "k"):
        key = ("t", c, idb.table("t").version)
        assert key in idb.index_manager.imprints
        _assert_same_imprint(
            idb.index_manager.imprints[key],
            rdb.index_manager.imprints[("t", c, rdb.table("t").version)])
    rdb.shutdown()


def test_build_imprint_calls_the_kernel_wrapper_twice(data):
    """Bounds, then bounds and bitmaps over the range: two calls of the
    wrapper (two launches on a CUDA device)."""
    col = _mk(T, {"t": data}).table("t").column("x")
    calls = ik.CALLS.count
    imp = build_imprint(col, "cpu")
    assert ik.CALLS.count - calls == 2
    assert imp.n_rows == len(data["x"])


def test_decimal_and_sentinel_imprints_equal_reference():
    """DECIMAL (scaled int64, divided by 10**scale), INT64 with NULL
    sentinels and DATE, built by both engines."""
    rng = np.random.default_rng(3)
    n = 3 * IMPRINT_BLOCK + 17
    cols = {"d": rng.integers(-10**7, 10**7, n).astype(np.int64),
            "i": [None if i % 5 == 0 else int(v) for i, v in
                  enumerate(rng.integers(-1000, 1000, n))],
            "t": np.sort(rng.integers(8000, 9000, n)).astype(np.int32)}
    dbs = {}
    for pkg in (T, R):
        db = pkg.startup(device="cpu") if pkg is T else pkg.startup()
        db.create_table("z", cols, types={"d": pkg.DBType.DECIMAL,
                                          "t": pkg.DBType.DATE},
                        scales={"d": 2})
        dbs[pkg] = db
    for c in cols:
        _assert_same_imprint(dbs[T].index_manager.get_imprint("z", c),
                             dbs[R].index_manager.get_imprint("z", c))
    dbs[R].shutdown()


# ---------------------------------------------------------------------------
# candidate_blocks: superset soundness (tests/test_property.py)
# ---------------------------------------------------------------------------

_IMPRINT_ROWS = 3 * 2048        # 3 full IMPRINT_BLOCKs (>= AUTO_ORDER_MIN)
_PROPS = settings(max_examples=40, deadline=None, database=None)


def _mkdb(x):
    db = T.startup(device="cpu")
    db.create_table("t", {"x": x})
    return db


@st.composite
def imprint_case(draw):
    """(values, lo, hi, lo_strict, hi_strict) over clustered, uniform,
    constant and NaN-sprinkled shapes; bounds arbitrary or snapped onto
    drawn data values."""
    shape = draw(st.sampled_from(["clustered", "uniform", "constant",
                                  "nans"]))
    base = draw(st.lists(st.floats(-1e4, 1e4, allow_nan=False),
                         min_size=2, max_size=50))
    reps = -(-_IMPRINT_ROWS // len(base))
    vals = np.asarray((base * reps)[:_IMPRINT_ROWS], dtype=np.float64)
    if shape == "clustered":
        vals = np.sort(vals)
    elif shape == "constant":
        vals = np.full(_IMPRINT_ROWS, base[0])
    elif shape == "nans":
        for i in draw(st.lists(st.integers(0, _IMPRINT_ROWS - 1),
                               max_size=30)):
            vals[i] = np.nan
    bound = st.one_of(st.floats(-1e4, 1e4, allow_nan=False),
                      st.sampled_from(base))
    lo, hi = sorted((draw(bound), draw(bound)))
    return vals, lo, hi, draw(st.booleans()), draw(st.booleans())


@_PROPS
@given(imprint_case())
def test_candidate_blocks_is_superset(case):
    vals, lo, hi, lo_s, hi_s = case
    db = _mkdb(vals)
    info = db.index_manager.candidate_info("t", "x", lo, hi, lo_s, hi_s)
    assert info is not None
    cand, block, n_rows = info
    assert block == IMPRINT_BLOCK and n_rows == len(vals)
    ok = (vals > lo) if lo_s else (vals >= lo)
    ok &= (vals < hi) if hi_s else (vals <= hi)
    ok &= ~np.isnan(vals)
    for b in range(len(cand)):
        if ok[b * block:(b + 1) * block].any():
            assert cand[b], f"block {b} holds qualifying rows but was skipped"


@_PROPS
@given(imprint_case())
def test_candidate_blocks_matches_bin_edges(case):
    vals, _, _, lo_s, hi_s = case
    db = _mkdb(vals)
    im = db.index_manager.get_imprint("t", "x")
    assert im is not None
    if not np.isfinite(im.lo) or not np.isfinite(im.hi) or im.hi <= im.lo:
        return
    edges = im.lo + np.arange(17) * (im.hi - im.lo) / 16
    for lo, hi in ((edges[3], edges[5]), (edges[0], edges[0]),
                   (edges[15], edges[16])):
        cand = im.candidate_blocks(lo, hi, lo_s, hi_s)
        ok = (vals > lo) if lo_s else (vals >= lo)
        ok &= (vals < hi) if hi_s else (vals <= hi)
        ok &= ~np.isnan(vals)
        for b in range(len(cand)):
            if ok[b * im.block:(b + 1) * im.block].any():
                assert cand[b], (lo, hi, b)


@_PROPS
@given(st.lists(st.one_of(st.none(), st.integers(-1000, 1000)),
                min_size=4, max_size=60))
def test_candidate_blocks_int_nulls_sound(ks):
    assume(any(k is not None for k in ks))
    reps = -(-_IMPRINT_ROWS // len(ks))
    col = (ks * reps)[:_IMPRINT_ROWS]
    db = _mkdb(col)
    info = db.index_manager.candidate_info("t", "x", -500.0, 500.0,
                                           False, False)
    assert info is not None
    cand, block, _ = info
    ok = np.asarray([v is not None and -500 <= v <= 500 for v in col])
    for b in range(len(cand)):
        if ok[b * block:(b + 1) * block].any():
            assert cand[b]
