"""The port's device join and sort tier (repro_torch) against the reference
(repro) on the CPU: TPC-H Q3 at sf 0.01 with ``device_batch_rows=8192``.

Both packages load the same ``tpch.generate`` arrays.  The port runs with
``device="cpu"``, where its batch steps are the same torch programs it
runs on the card and each kernel wrapper (``radix_build``,
``radix_probe``, ``sort``) takes its plain version.  Contracts:

* device tier vs the reference's device tier: ``rtol=1e-9``, keys exact;
* host tier vs the reference's host tier: bit-identical;
* the port's budget matrix {unlimited, 64 MiB, 4 MiB, 2 MiB} x skipping
  {on, forced-off}: bit-identical, ``device_bytes_peak <= budget``, 2 MiB
  streams;
* on orders and lineitem sorted by their date columns (the clustered load
  order data skipping pays on), skipping on and off bit-identical, with
  ``blocks_skipped`` and ``bytes_skipped_h2d`` equal to the reference's and
  one kernel launch per live batch; a gathered boundary batch moves fewer
  bytes, bit-identically;
* EXPLAIN shows ``device-join`` and the fused ``device-sort``;
* fences: the host join is never entered and partials are never
  finalized on the host on the device path;
* soundness gates: duplicate build keys go to the host join (the one
  non-device outcome), NULL probe keys never match, payload-only grouping
  stays on the host;
* the scan-agg tier's fused device sort matches the host;
* a failing kernel makes Q3 raise — no host rerun.
"""

import numpy as np
import pytest

import repro.core as R
import repro_torch.core as T
from repro.data import tpch
from repro.data.tpch_queries import q3 as ref_q3
from repro_torch.core import parallel as tparallel
from repro_torch.core.physplan import plan_physical
from repro_torch.data import load_tables
from repro_torch.data.tpch_queries import q3
from repro_torch.kernels.radix_join import kernel as rk
from repro_torch.kernels.sort import kernel as so

BATCH_ROWS = 8192          # small enough that the 2 MiB cell streams
DEVICE_BUDGETS = (None, 64 << 20, 4 << 20, 2 << 20)
Q3_TABLES = ("customer", "orders", "lineitem")


@pytest.fixture(scope="module")
def q3_data():
    gen = tpch.generate(0.01, 7)
    return {t: gen[t] for t in Q3_TABLES}


def _port_db(data, budget=None, batch_rows=BATCH_ROWS, skipping=True):
    db = T.startup(device="cpu", device_budget=budget,
                   device_batch_rows=batch_rows, data_skipping=skipping)
    load_tables(db, data)
    return db


def _assert_bits(a: dict, b: dict, ctx: str):
    assert list(a) == list(b), ctx
    for c in a:
        av, bv = np.asarray(a[c]), np.asarray(b[c])
        if av.dtype == object or bv.dtype == object:
            assert list(map(str, av)) == list(map(str, bv)), (ctx, c)
        else:
            np.testing.assert_array_equal(av, bv, err_msg=f"{ctx} col={c}")


def _assert_close(got: dict, want: dict, ctx: str):
    """Floats at rtol=1e-9; keys, dates, counts and strings exact."""
    assert list(got) == list(want), ctx
    for c in got:
        a, b = np.asarray(got[c]), np.asarray(want[c])
        assert a.shape == b.shape, (ctx, c)
        if a.dtype == object or a.dtype.kind in "iub" \
                or b.dtype == object or b.dtype.kind in "iub":
            assert list(map(str, a)) == list(map(str, b)), (ctx, c)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-9, atol=0,
                                       err_msg=f"{ctx} col={c}")


@pytest.fixture(scope="module")
def reference(q3_data):
    """The reference engine's Q3 on its device tier and its host tier."""
    db = R.startup(device_batch_rows=BATCH_ROWS, data_skipping=False)
    for name, (cols, types, scales) in q3_data.items():
        db.create_table(name, cols, types=types, scales=scales)
    try:
        dev = ref_q3(db).execute(distributed=True).to_pydict()
        assert db.last_stats.device_tier == "join-resident"
        host = ref_q3(db).execute().to_pydict()
    finally:
        db.shutdown()
    return dev, host


# ---------------------------------------------------------------------------
# against the reference engine
# ---------------------------------------------------------------------------


def test_q3_device_tier_matches_reference_device_tier(q3_data, reference):
    db = _port_db(q3_data)
    got = q3(db).execute(distributed=True).to_pydict()
    assert db.last_stats.device_tier == "join-resident"
    assert db.last_stats.device_sorted
    _assert_close(got, reference[0], "port device vs reference device")


def test_q3_host_tier_bit_identical_to_reference_host_tier(q3_data,
                                                          reference):
    db = _port_db(q3_data)
    got = q3(db).execute().to_pydict()
    assert db.last_stats.device_tier == ""
    _assert_bits(got, reference[1], "port host vs reference host")


# ---------------------------------------------------------------------------
# the port's budget matrix
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def device_cells(q3_data):
    """Q3 in every (device budget, skipping) cell, one cold database per
    cell."""
    out = {}
    for budget in DEVICE_BUDGETS:
        for skipping in (True, False):
            db = _port_db(q3_data, budget, skipping=skipping)
            res = q3(db).execute(distributed=True).to_pydict()
            s = db.last_stats
            out[budget, skipping] = (res, s.device_tier, s.device_sorted,
                                     s.device_bytes_peak, s.device_evictions)
    return out


def test_q3_matrix_runs_on_device(device_cells):
    for cell, (_res, tier, srt, peak, _ev) in device_cells.items():
        assert tier.startswith("join-") and srt, (cell, tier)
        if cell[0] is not None:
            assert peak <= cell[0], (cell, peak)
    for skipping in (True, False):
        assert device_cells[2 << 20, skipping][1] == "join-streamed"
        assert device_cells[64 << 20, skipping][1] == "join-resident"


def test_q3_matrix_bit_identical(device_cells):
    ref = device_cells[None, True][0]
    for cell, (res, *_s) in device_cells.items():
        _assert_bits(res, ref, f"cell={cell}")


def test_q3_matrix_matches_host(device_cells, q3_data):
    host = q3(_port_db(q3_data)).execute().to_pydict()
    for cell, (res, *_s) in device_cells.items():
        _assert_close(res, host, f"cell={cell} vs host")


# ---------------------------------------------------------------------------
# data skipping on clustered tables
# ---------------------------------------------------------------------------


def _sorted_by(data: dict, table: str, column: str) -> tuple:
    """``table``'s arrays stably sorted by ``column``."""
    cols, types, scales = data[table]
    order = np.argsort(np.asarray(cols[column]), kind="stable")
    return ({c: np.asarray(v)[order] for c, v in cols.items()}, types,
            scales)


@pytest.fixture(scope="module")
def q3_sorted(q3_data):
    """Q3's tables with orders and lineitem in date order, and the
    reference's device-tier Q3 over them with skipping on."""
    data = dict(q3_data)
    data["orders"] = _sorted_by(q3_data, "orders", "o_orderdate")
    data["lineitem"] = _sorted_by(q3_data, "lineitem", "l_shipdate")
    db = R.startup(device_batch_rows=BATCH_ROWS)
    for name, (cols, types, scales) in data.items():
        db.create_table(name, cols, types=types, scales=scales)
    try:
        dev = ref_q3(db).execute(distributed=True).to_pydict()
        s = db.last_stats
        assert s.device_tier == "join-resident"
        ref = (dev, s.blocks_skipped, s.bytes_skipped_h2d)
    finally:
        db.shutdown()
    return data, ref


def _live_batches(phys, db, table: str) -> int:
    """Batches of ``table`` that hold a candidate block, from the plan's
    skip-set (every batch when the table has none)."""
    n = db.table(table).num_rows
    nb = -(-n // BATCH_ROWS)
    ss = phys.skip_set_for_table(table)
    if ss is None:
        return nb
    return sum(ss.batch_qualifies(b * BATCH_ROWS,
                                  min(n, (b + 1) * BATCH_ROWS))
               for b in range(nb))


@pytest.mark.parametrize("budget", [None, 2 << 20])
def test_q3_sorted_skipping_bit_identical(q3_sorted, budget):
    data, (ref, ref_blocks, ref_h2d) = q3_sorted
    on = _port_db(data, budget)
    off = _port_db(data, budget, skipping=False)
    phys = plan_physical(q3(on).plan, on, distributed=True)
    live = {t: _live_batches(phys, on, t) for t in Q3_TABLES}
    before = (rk.BUILD_CALLS.count, rk.PROBE_CALLS.count)
    r_on = q3(on).execute(distributed=True).to_pydict()
    calls = (rk.BUILD_CALLS.count - before[0],
             rk.PROBE_CALLS.count - before[1])
    s_on = on.last_stats
    r_off = q3(off).execute(distributed=True).to_pydict()
    s_off = off.last_stats
    assert s_on.device_tier == s_off.device_tier
    assert s_on.device_tier == ("join-resident" if budget is None
                                else "join-streamed")
    _assert_bits(r_on, r_off, f"skipping on/off budget={budget}")
    _assert_close(r_on, ref, "vs reference device, skipping on")
    assert s_on.blocks_skipped == ref_blocks > 0
    assert s_on.bytes_skipped_h2d == ref_h2d > 0
    assert s_off.blocks_skipped == s_off.bytes_skipped_h2d == 0
    assert s_on.device_bytes_h2d < s_off.device_bytes_h2d
    assert live["lineitem"] < -(-on.table("lineitem").num_rows
                                // BATCH_ROWS)
    assert calls == (sum(live.values()),
                     live["orders"] + live["lineitem"] + 1)


def test_intra_batch_gather_reduces_h2d_bit_identically():
    """Block-clustered alternating data, one 32768-row batch: every other
    imprint block qualifies, so the batch is live but half its blocks are
    dead — the gathered layout uploads only candidate slots.  h2d bytes
    drop, ``bytes_skipped_h2d`` accounts the savings (the reference's
    number), and the result is bit-identical to the ungathered run and
    matches the host."""
    from repro_torch.core.indexes import IMPRINT_BLOCK
    n = 16 * IMPRINT_BLOCK
    blk_vals = np.where(np.arange(16) % 2 == 0, 100, 900)
    rng = np.random.default_rng(5)
    data = {"ship": np.repeat(blk_vals, IMPRINT_BLOCK).astype(np.int32),
            "qty": rng.integers(1, 51, n).astype(np.float64),
            "flag": np.asarray(["A", "N", "R"],
                               dtype=object)[rng.integers(0, 3, n)]}

    def mk(pkg, **kw):
        if pkg is T:
            kw.setdefault("device", "cpu")
        db = pkg.startup(**kw)
        db.create_table("li", data, types={"ship": pkg.DBType.DATE})
        return db

    def q(pkg, db):
        return (db.scan("li").filter(pkg.Col("ship") <= pkg.Lit(500))
                .group_by("flag")
                .agg(total=("sum", pkg.Col("qty")), n=("count", None))
                .order_by("flag"))

    on = mk(T, device_budget=64 << 20, device_batch_rows=n)
    off = mk(T, device_budget=64 << 20, device_batch_rows=n,
             data_skipping=False)
    ref = mk(R, device_budget=64 << 20, device_batch_rows=n)
    r_on = q(T, on).execute(distributed=True).to_pydict()
    r_off = q(T, off).execute(distributed=True).to_pydict()
    r_ref = q(R, ref).execute(distributed=True).to_pydict()
    s_on, s_off = on.last_stats, off.last_stats
    assert s_on.device_tier == "resident"
    # one live batch, so ALL savings here are intra-batch gather
    assert s_on.bytes_skipped_h2d > 0
    assert s_on.bytes_skipped_h2d == ref.last_stats.bytes_skipped_h2d
    assert s_on.device_bytes_h2d < s_off.device_bytes_h2d
    assert s_off.bytes_skipped_h2d == 0
    _assert_bits(r_on, r_off, "gather on/off")
    _assert_close(r_on, r_ref, "gather vs reference device")
    _assert_close(r_on, q(T, mk(T)).execute().to_pydict(), "vs host")
    ref.shutdown()


def test_q3_explain_annotates_device_join_and_sort(q3_data):
    db = _port_db(q3_data, 64 << 20)
    txt = q3(db).explain(physical=True, distributed=True)
    assert ":: device-join" in txt
    assert ":: device-sort" in txt
    assert "mode=resident" in txt
    tight = _port_db(q3_data, 2 << 20)
    assert "mode=streamed" in q3(tight).explain(physical=True,
                                                distributed=True)


def test_q3_tiny_budget_stays_on_host_tier(q3_data, reference):
    """A budget below the join's working state (build tables + carry +
    two batches) keeps Q3 on the host tier at plan time — the SF 1 run's
    64 MiB cell — and EXPLAIN names the join-agg core."""
    db = _port_db(q3_data, 1 << 20)
    calls = (rk.BUILD_CALLS.count, rk.PROBE_CALLS.count)
    got = q3(db).execute(distributed=True).to_pydict()
    assert db.last_stats.device_tier == ""
    assert (rk.BUILD_CALLS.count, rk.PROBE_CALLS.count) == calls
    assert db.buffer_manager.stats.device_bytes_h2d == 0
    assert "join-agg core kept on host" in q3(db).explain(
        physical=True, distributed=True)
    _assert_bits(got, reference[1], "tiny budget vs reference host")


def test_q3_launch_counts_per_stream(q3_data):
    """One radix_build per build and probe batch, one radix_probe per
    batch that gates on a built table plus the payload gather, one sort
    per ORDER BY key (calls: on the CPU the wrappers run their plain
    versions)."""
    db = _port_db(q3_data)
    nb = {t: -(-db.table(t).num_rows // BATCH_ROWS) for t in Q3_TABLES}
    before = (rk.BUILD_CALLS.count, rk.PROBE_CALLS.count, so.CALLS.count)
    q3(db).execute(distributed=True).to_pydict()
    after = (rk.BUILD_CALLS.count, rk.PROBE_CALLS.count, so.CALLS.count)
    assert after[0] - before[0] == sum(nb.values())
    assert after[1] - before[1] == nb["orders"] + nb["lineitem"] + 1
    assert after[2] - before[2] == 2


# ---------------------------------------------------------------------------
# fences: the device path never touches the host join or host finalize
# ---------------------------------------------------------------------------


def _fence(*_a, **_kw):
    raise AssertionError("host code entered on the device path")


def test_fence_host_join_never_entered(monkeypatch, q3_data, reference):
    from repro_torch.core import executor as ex
    monkeypatch.setattr(ex, "_hash_join", _fence)
    db = _port_db(q3_data, 64 << 20)
    got = q3(db).execute(distributed=True).to_pydict()
    assert db.last_stats.device_tier.startswith("join-")
    _assert_close(got, reference[1], "host-join fence")


def test_fence_partials_never_finalized_on_host(monkeypatch, q3_data,
                                                reference):
    monkeypatch.setattr(tparallel, "finalize_partials", _fence)
    db = _port_db(q3_data, 64 << 20)
    got = q3(db).execute(distributed=True).to_pydict()
    assert db.last_stats.device_tier.startswith("join-")
    _assert_close(got, reference[1], "host-finalize fence")


# ---------------------------------------------------------------------------
# soundness gates: duplicate build keys, NULL probe keys, coarse grouping
# ---------------------------------------------------------------------------


def _star(db, dim_rows, group=("fk", "grp")):
    """Small star schema: a fact table probing one dimension build,
    grouped at build-key granularity (the Q3 shape)."""
    rng = np.random.default_rng(11)
    n = 20_000
    db.create_table("dim", dim_rows)
    db.create_table("fact", {
        "fk": rng.integers(0, 180, n).astype(np.int64),
        "v": rng.standard_normal(n),
    })
    return (db.scan("fact")
            .join(db.scan("dim"), left_on="fk", right_on="k")
            .group_by(*group)
            .agg(s=("sum", T.Col("v")), n=("count", None))
            .order_by(*group))


def _star_dbs():
    return (T.startup(device="cpu", device_budget=64 << 20,
                      device_batch_rows=BATCH_ROWS),
            T.startup(device="cpu"))


def test_duplicate_build_keys_fall_back_to_host_join():
    """The uniqueness witness: a duplicated build key would double-count
    in the dense build table, so the device join refuses at runtime and
    the host join gives the (duplicated-row) truth — the one outcome of a
    device-tier plan that runs on the host."""
    dim = {"k": np.concatenate([np.arange(200), [7]]).astype(np.int64),
           "grp": np.concatenate([np.arange(200) % 5, [3]]).astype(np.int64)}
    dev, host = _star_dbs()
    qd, qh = _star(dev, dim), _star(host, dim)
    calls = rk.BUILD_CALLS.count
    got = qd.execute(distributed=True).to_pydict()
    assert rk.BUILD_CALLS.count > calls           # the device build ran
    assert dev.last_stats.device_tier == ""       # witness fired
    assert "duplicate join keys" in dev.last_stats.plan_repr
    _assert_bits(got, qh.execute().to_pydict(), "dup keys")


def test_null_probe_keys_never_match():
    """NULL fact keys are sentinel-coded; the probe mask rejects them (an
    inner join drops NULL keys) — differential vs the host join."""
    dim = {"k": np.arange(200).astype(np.int64),
           "grp": (np.arange(200) % 5).astype(np.int64)}
    dev, host = _star_dbs()
    qd, qh = _star(dev, dim), _star(host, dim)
    for db in (dev, host):
        db.append("fact", {"fk": [None] * 64, "v": np.ones(64)})
    got = qd.execute(distributed=True).to_pydict()
    assert dev.last_stats.device_tier.startswith("join-")
    _assert_close(got, qh.execute().to_pydict(), "null keys")


def test_payload_only_grouping_stays_on_host():
    """The device tier groups at build-key granularity: GROUP BY a
    dimension attribute alone (coarser — needs a re-merge) is not claimed
    by the device join, and the host result is authoritative."""
    dim = {"k": np.arange(200).astype(np.int64),
           "grp": (np.arange(200) % 5).astype(np.int64)}
    dev, host = _star_dbs()
    qd = _star(dev, dim, group=("grp",))
    qh = _star(host, dim, group=("grp",))
    calls = rk.BUILD_CALLS.count
    got = qd.execute(distributed=True).to_pydict()
    assert dev.last_stats.device_tier == ""
    assert rk.BUILD_CALLS.count == calls          # planner's decision
    assert len(np.asarray(got["grp"])) == 5
    _assert_bits(got, qh.execute().to_pydict(), "payload-only grouping")


# ---------------------------------------------------------------------------
# fused device sort on the scan-agg tier
# ---------------------------------------------------------------------------


def test_scan_agg_device_sort_matches_host():
    """ORDER BY over a grouped scan-agg fuses onto the device assembly
    (``device_sorted``, sort kernel calls) and reproduces the host suffix
    sort exactly — DESC on an aggregate and a LIMIT."""
    rng = np.random.default_rng(3)
    n = 40_000
    data = {"g": (np.arange(n) % 97).astype(np.int64),
            "v": rng.standard_normal(n)}
    dev, host = _star_dbs()
    for db in (dev, host):
        db.create_table("t", data)

    def q(d):
        return (d.scan("t").group_by("g")
                .agg(s=("sum", T.Col("v")), n=("count", None))
                .order_by(("s", True), "g", limit=20))

    calls = so.CALLS.count
    got = q(dev).execute(distributed=True).to_pydict()
    s = dev.last_stats
    assert s.device_tier == "resident" and s.device_sorted
    assert so.CALLS.count - calls == 2
    want = q(host).execute().to_pydict()
    _assert_close(got, want, "scan-agg device sort")
    np.testing.assert_array_equal(np.asarray(got["g"]),
                                  np.asarray(want["g"]))


# ---------------------------------------------------------------------------
# failures
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["radix_probe", "radix_build"])
def test_failing_kernel_raises_without_host_fallback(monkeypatch, q3_data,
                                                     name):
    def broken(*args, **kw):
        raise RuntimeError(f"{name} failed to launch")

    monkeypatch.setattr(tparallel, name, broken)
    tparallel._STEP_CACHE.clear()          # steps bind the kernel at build
    db = _port_db(q3_data)
    with pytest.raises(RuntimeError, match=name):
        q3(db).execute(distributed=True)
    assert db.last_stats.device_tier == ""
    assert db.last_stats.instructions == 0   # no host program ran either
    monkeypatch.undo()
    tparallel._STEP_CACHE.clear()
