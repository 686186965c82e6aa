"""Imprint-driven data skipping in the port (repro_torch) against the
reference (repro) on the CPU: the differential skip-harness of
tests/test_skipping.py, on the same seeded data, with the port on
``device="cpu"`` (its imprint kernel's plain version builds the zone maps,
its batch steps run the same torch programs they run on the card).

Contracts (those of the reference harness that need no SQL text, DELETE or
``memory_budget``; the volcano consumer waits for its slice):

* **Bit-identity**: skipping on vs forced-off, host tier and device tier,
  at selectivities {~0%, 1%, 50%, 100%}; and each held bit-identical to the
  reference's host tier.
* **Counters**: ``blocks_skipped`` equal to the reference's;
  ``bytes_skipped_h2d`` equal to the reference's formula at one shard —
  whole skipped batches times ``batch_rows * row_bytes``, plus
  ``(L - q) * ublock * row_bytes`` per gathered batch.
* **Fences**: non-qualifying batches are never uploaded
  (``DeviceBufferManager.get_or_put``) and, with every block pruned, the
  filter predicate never reaches expression evaluation on the host path.
* **Staleness**: append, plan-cache key, drop/recreate, and a transaction
  snapshot query through a builder ``Query`` on ``con.query``.
* **NULL soundness**: integer NULL sentinels never satisfy open bounds.
* **The reference's NaN crash**: an equality filter over a float column
  holding both infinities answers as with ``data_skipping=False``.
"""

import math

import numpy as np
import pytest

import repro.core as R
import repro_torch.core as T
from repro_torch.core.device_cache import DeviceBufferManager
from repro_torch.core.indexes import IMPRINT_BLOCK
from repro_torch.core.physplan import (derive_skip_sets, plan_physical,
                                       scan_agg_geometry)

N_BLOCKS = 6
N = N_BLOCKS * IMPRINT_BLOCK
SELECTIVITIES = ("empty", "one_pct", "half", "all")
DEV_BATCH = 4096
DEV_BUDGET = 64 << 20


def _dataset():
    """Lineitem-like, SORTED by the filter column (the reference harness's
    data: zone maps prune only clustered data)."""
    rng = np.random.default_rng(5)
    ship = np.sort(rng.integers(8000, 9200, N)).astype(np.int32)
    flags = np.asarray(["A", "N", "R"], dtype=object)
    status = np.asarray(["F", "O"], dtype=object)
    return {
        "ship": ship,
        "qty": rng.integers(1, 51, N).astype(np.float64),
        "price": np.round(rng.uniform(900, 105000, N), 2),
        "disc": np.round(rng.uniform(0.0, 0.10, N), 2),
        "tax": np.round(rng.uniform(0.0, 0.08, N), 2),
        "flag": flags[rng.integers(0, 3, N)],
        "status": status[rng.integers(0, 2, N)],
    }


_DATA = _dataset()
_CUT = {
    "empty": int(_DATA["ship"].min()) - 1,
    "one_pct": int(np.quantile(_DATA["ship"], 0.01)),
    "half": int(np.quantile(_DATA["ship"], 0.50)),
    "all": int(_DATA["ship"].max()) + 1,
}


def _mk(pkg, data=_DATA, **kw):
    if pkg is T:
        kw.setdefault("device", "cpu")
    db = pkg.startup(**kw)
    db.create_table("li", data, types={"ship": pkg.DBType.DATE})
    return db


def _q1(pkg, db, cut):
    return (db.scan("li").filter(pkg.Col("ship") <= pkg.Lit(cut))
            .group_by("flag", "status")
            .agg(sq=("sum", "qty"), sp=("sum", "price"),
                 ad=("avg", "disc"), n=("count", None))
            .order_by("flag", "status"))


def _q6(pkg, db, cut):
    return (db.scan("li")
            .filter((pkg.Col("ship") <= pkg.Lit(cut))
                    & (pkg.Col("disc") <= pkg.Lit(0.07))
                    & (pkg.Col("qty") < pkg.Lit(24.0)))
            .agg(rev=("sum", pkg.Col("price") * pkg.Col("disc")),
                 n=("count", None)))


def _qdev(pkg, db, cut):
    return (db.scan("li").filter(pkg.Col("ship") <= pkg.Lit(cut))
            .group_by("flag", "status")
            .agg(sq=("sum", "qty"), n=("count", None))
            .order_by("flag", "status"))


QUERIES = {"q1": _q1, "q6": _q6}


def _assert_bits(a: dict, b: dict, ctx: str):
    assert list(a) == list(b), ctx
    for c in a:
        av, bv = np.asarray(a[c]), np.asarray(b[c])
        if av.dtype == object or bv.dtype == object:
            assert list(map(str, av)) == list(map(str, bv)), (ctx, c)
        else:
            np.testing.assert_array_equal(av, bv, err_msg=f"{ctx} col={c}")


def _count(db, cut):
    return int(np.asarray(
        db.scan("li").filter(T.Col("ship") <= T.Lit(cut))
        .agg(n=("count", None)).execute().to_pydict()["n"])[0])


# ---------------------------------------------------------------------------
# differential harness: host path
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def hostdbs():
    out = {(pkg, on): _mk(pkg, data_skipping=on)
           for pkg in (R, T) for on in (True, False)}
    yield out
    for db in out.values():
        db.shutdown()


# the reference's budget axis holds memory_budget cells, which wait for the
# out-of-core slice; the unbudgeted cell is the one that applies
@pytest.mark.parametrize("sel", SELECTIVITIES)
@pytest.mark.parametrize("budget", [None])
@pytest.mark.parametrize("qname", list(QUERIES))
def test_skip_harness_bit_identical(hostdbs, qname, budget, sel):
    cut = _CUT[sel]
    on, off = hostdbs[T, True], hostdbs[T, False]
    ref = hostdbs[R, True]
    r_on = QUERIES[qname](T, on, cut).execute().to_pydict()
    r_off = QUERIES[qname](T, off, cut).execute().to_pydict()
    r_ref = QUERIES[qname](R, ref, cut).execute().to_pydict()
    ctx = f"{qname} sel={sel} budget={budget}"
    _assert_bits(r_on, r_off, ctx)
    _assert_bits(r_on, r_ref, ctx + " vs reference")
    assert off.last_stats.blocks_skipped == 0
    assert on.last_stats.blocks_skipped == ref.last_stats.blocks_skipped
    assert on.last_stats.bytes_skipped_spill \
        == ref.last_stats.bytes_skipped_spill
    if sel == "all":
        assert on.last_stats.blocks_skipped == 0
    else:
        assert on.last_stats.blocks_skipped > 0, (qname, sel)
        assert on.last_stats.bytes_skipped_spill > 0


def test_skip_counts_track_selectivity(hostdbs):
    db = hostdbs[T, True]
    skipped = {}
    for sel in SELECTIVITIES:
        _q1(T, db, _CUT[sel]).execute()
        skipped[sel] = db.last_stats.blocks_skipped
    assert skipped["empty"] == N_BLOCKS
    assert skipped["empty"] >= skipped["one_pct"] >= skipped["half"] \
        >= skipped["all"] == 0


def test_explain_annotates_skip_sets(hostdbs):
    on, off = hostdbs[T, True], hostdbs[T, False]
    txt = _q1(T, on, _CUT["one_pct"]).explain(physical=True)
    ref = _q1(R, hostdbs[R, True], _CUT["one_pct"]).explain(physical=True)
    note = next(w for w in txt.split("(")[1:] if w.startswith("skip: "))
    assert "(skip: " in txt and "/6 blocks)" in txt
    assert "(" + note in ref
    assert "(skip: " not in _q1(T, off, _CUT["one_pct"]).explain(
        physical=True)
    phys = plan_physical(_q1(T, on, _CUT["empty"]).plan, on)
    assert any(ss.n_skipped == N_BLOCKS and ss.n_blocks == N_BLOCKS
               for ss in phys.skip_sets.values())


def test_explain_annotates_skip_sets_on_device_core():
    db = _mk(T, device_budget=DEV_BUDGET, device_batch_rows=DEV_BATCH)
    txt = _qdev(T, db, _CUT["one_pct"]).explain(physical=True,
                                                  distributed=True)
    assert ":: device-" in txt and "(fused) (skip: " in txt


def test_host_fence_skipped_blocks_never_evaluated(monkeypatch):
    from repro_torch.core.expression import BinOp
    db = _mk(T)
    q = (db.scan("li").filter(T.Col("ship") <= T.Lit(_CUT["empty"]))
         .agg(n=("count", None), s=("sum", "price")))

    def _fence(self, ctx):
        raise AssertionError("predicate evaluated — imprint skip missed")

    monkeypatch.setattr(BinOp, "eval", _fence)
    got = q.execute().to_pydict()
    assert int(np.asarray(got["n"])[0]) == 0
    assert db.last_stats.blocks_skipped == N_BLOCKS


# ---------------------------------------------------------------------------
# device tier: batches of non-qualifying blocks are never uploaded
# ---------------------------------------------------------------------------


def _expected_h2d_skipped(db, q, skip_set):
    """bytes_skipped_h2d by the reference's formula at one shard, computed
    here from the skip-set, independently of the engine's stream: whole
    skipped batches times batch_rows * row_bytes, plus (L - q) * ublock *
    row_bytes for each live batch with q < L candidate slots.  Also
    returns the number of such (gathered) batches."""
    spec = plan_physical(q.plan, db, distributed=True).scan_agg
    geom = scan_agg_geometry(spec, db.table("li"), DEV_BATCH)
    m, n = geom.batch_rows, db.table("li").num_rows
    ublock = math.gcd(skip_set.block, m)
    L = m // ublock
    out, gathered = 0, 0
    for b in range(geom.n_batches):
        s, e = b * m, min(n, b * m + m)
        if not skip_set.batch_qualifies(s, e):
            out += m * geom.row_bytes
            continue
        qq = sum(skip_set.batch_qualifies(s + k * ublock,
                                          min(s + k * ublock + ublock, e))
                 for k in range(L))
        if qq < L:
            out += (L - qq) * ublock * geom.row_bytes
            gathered += 1
    return out, gathered


@pytest.fixture(scope="module")
def refdev():
    """The reference's device tier, skipping on, per selectivity."""
    db = _mk(R, device_budget=DEV_BUDGET, device_batch_rows=DEV_BATCH)
    out = {}
    for sel in SELECTIVITIES:
        res = _qdev(R, db, _CUT[sel]).execute(distributed=True).to_pydict()
        s = db.last_stats
        out[sel] = (res, s.blocks_skipped, s.bytes_skipped_h2d)
    db.shutdown()
    return out


@pytest.mark.parametrize("sel", SELECTIVITIES)
def test_device_bit_identical(sel, refdev):
    """Cold device runs, skipping on vs forced-off: bit-identical, and the
    h2d counters account every batch exactly once (uploaded or skipped)."""
    on = _mk(T, device_budget=DEV_BUDGET, device_batch_rows=DEV_BATCH)
    off = _mk(T, device_budget=DEV_BUDGET, device_batch_rows=DEV_BATCH,
              data_skipping=False)
    r_on = _qdev(T, on, _CUT[sel]).execute(distributed=True).to_pydict()
    s_on = on.last_stats
    r_off = _qdev(T, off, _CUT[sel]).execute(distributed=True).to_pydict()
    s_off = off.last_stats
    assert s_on.device_tier == s_off.device_tier == "resident"
    _assert_bits(r_on, r_off, f"device sel={sel}")
    _assert_bits(r_on, _qdev(T, off, _CUT[sel]).execute().to_pydict(),
                 f"device vs host sel={sel}")
    ref, ref_blocks, ref_h2d = refdev[sel]
    np.testing.assert_allclose(np.asarray(r_on["sq"]),
                               np.asarray(ref["sq"]), rtol=1e-9, atol=0)
    assert list(r_on["n"]) == list(ref["n"])
    assert s_off.bytes_skipped_h2d == 0 and s_off.blocks_skipped == 0
    assert s_on.blocks_skipped == ref_blocks
    assert s_on.bytes_skipped_h2d == ref_h2d
    ss = plan_physical(_qdev(T, on, _CUT[sel]).plan, on,
                       distributed=True).core_skip_set()
    want, gathered = _expected_h2d_skipped(on, _qdev(T, on, _CUT[sel]), ss)
    assert s_on.bytes_skipped_h2d == want
    if sel == "one_pct":                  # batch 0: one of its 2 slots
        assert gathered == 1
    if sel == "all":
        assert s_on.bytes_skipped_h2d == 0
        assert s_on.blocks_skipped == 0
    else:
        assert s_on.bytes_skipped_h2d > 0, sel
        assert s_on.device_bytes_h2d < s_off.device_bytes_h2d
    if sel == "empty":
        assert s_on.blocks_skipped == N_BLOCKS
        assert s_on.device_bytes_h2d == 0


def _spy_uploads(monkeypatch, sink):
    real = DeviceBufferManager.get_or_put

    def spy(self, key, *a, **kw):
        if key[0] == "li":
            sink.append(key)
        return real(self, key, *a, **kw)

    monkeypatch.setattr(DeviceBufferManager, "get_or_put", spy)


def test_device_fence_skipped_batches_never_uploaded(monkeypatch):
    db = _mk(T, device_budget=DEV_BUDGET, device_batch_rows=DEV_BATCH)
    uploads = []
    _spy_uploads(monkeypatch, uploads)
    got = (db.scan("li").filter(T.Col("ship") <= T.Lit(_CUT["empty"]))
           .group_by("flag", "status").agg(n=("count", None))
           .execute(distributed=True).to_pydict())
    assert db.last_stats.device_tier == "resident"
    assert list(got["n"]) == [] or all(v == 0 for v in got["n"])
    assert uploads == []
    assert db.last_stats.blocks_skipped == N_BLOCKS


def test_device_partial_skip_uploads_only_live_batches(monkeypatch):
    """1% selectivity with 4096-row batches: only the first batch
    qualifies; the batch index sits in the shard component of the key."""
    db = _mk(T, device_budget=DEV_BUDGET, device_batch_rows=DEV_BATCH)
    uploads = []
    _spy_uploads(monkeypatch, uploads)
    (db.scan("li").filter(T.Col("ship") <= T.Lit(_CUT["one_pct"]))
     .group_by("flag", "status").agg(n=("count", None))
     .execute(distributed=True))
    assert {k[3][2] for k in uploads} == {0}, uploads


def test_device_launches_once_per_live_batch():
    """The step (one hash_group launch) runs for live batches only."""
    from repro_torch.kernels.hash_group import kernel as hk
    db = _mk(T, device_budget=DEV_BUDGET, device_batch_rows=DEV_BATCH)
    for sel, live in (("empty", 0), ("one_pct", 1), ("all", 3)):
        before = hk.CALLS.count
        _qdev(T, db, _CUT[sel]).execute(distributed=True)
        assert hk.CALLS.count - before == live, sel


# ---------------------------------------------------------------------------
# staleness: version-keyed skip-sets under append / DROP / txn
# ---------------------------------------------------------------------------


class TestStaleness:
    def test_append_invalidates_skip_sets(self):
        """Appended qualifying rows land in a tail block the old bitmap
        never covered: a stale skip-set would silently drop them."""
        db = _mk(T)
        cut = _CUT["one_pct"]
        before = _count(db, cut)
        assert db.last_stats.blocks_skipped > 0
        assert len(db.plan_cache) == 1
        extra = 64
        db.append("li", {
            "ship": np.full(extra, _CUT["empty"], dtype=np.int32),
            "qty": np.ones(extra), "price": np.ones(extra),
            "disc": np.zeros(extra), "tax": np.zeros(extra),
            "flag": ["A"] * extra, "status": ["F"] * extra,
        })
        assert _count(db, cut) == before + extra
        assert db.last_stats.plan_cache_hit is False

    def test_plan_cache_key_differs_on_version_and_flag(self):
        from repro_torch.core.serving import PlanCache
        on, off = _mk(T), _mk(T, data_skipping=False)
        q = _q1(T, on, _CUT["half"]).plan
        k_on = PlanCache.key(on, q, do_optimize=True, distributed=False)
        k_off = PlanCache.key(off, q, do_optimize=True, distributed=False)
        assert k_on != k_off
        assert k_on[-1] is True and k_off[-1] is False
        on.append("li", {k: v[:1] for k, v in _DATA.items()})
        k_on2 = PlanCache.key(on, q, do_optimize=True, distributed=False)
        assert k_on2 != k_on          # version component moved

    def test_drop_and_recreate_no_stale_skip_set(self):
        db = _mk(T)
        _count(db, _CUT["empty"])
        db.drop_table("li")
        shifted = dict(_DATA)
        shifted["ship"] = (_DATA["ship"] - 5000).astype(np.int32)
        db.create_table("li", shifted, types={"ship": T.DBType.DATE})
        assert _count(db, _CUT["all"]) == N

    def test_txn_snapshot_does_not_see_committed_skip_set(self):
        """A transaction's snapshot database derives skip-sets from its OWN
        IndexManager over snapshot tables: rows committed after ``begin``
        stay invisible to it."""
        db = _mk(T)
        cut = _CUT["one_pct"]
        before = _count(db, cut)        # parent imprints + plan cache warm
        con = db.connect()
        con.begin()

        def q():
            return (db.scan("li").filter(T.Col("ship") <= T.Lit(cut))
                    .agg(n=("count", None)))

        n0 = con.query(q())
        db.append("li", {k: (v[:32] if k != "ship" else
                             np.full(32, cut - 1, dtype=np.int32))
                         for k, v in _DATA.items()})
        n1 = con.query(q())
        con.rollback()
        assert int(np.asarray(n0.to_pydict()["n"])[0]) == before
        assert int(np.asarray(n1.to_pydict()["n"])[0]) == before
        assert _count(db, cut) == before + 32    # committed view sees them


# ---------------------------------------------------------------------------
# NULL-sentinel soundness and the skip-set's own guards
# ---------------------------------------------------------------------------


def test_int_null_sentinel_never_satisfies_open_bounds():
    db = T.startup(device="cpu")
    vals = [None, 5, None, 10, 1, None] * 400     # > AUTO_ORDER_MIN_ROWS
    db.create_table("t", {"x": vals})
    im = db.index_manager.imprint_mask("t", "x", float("-inf"), 7.0,
                                       False, True)
    assert im is not None
    mask, _ = im
    exact = np.asarray([v is not None and v < 7 for v in vals])
    np.testing.assert_array_equal(mask, exact)
    got = (db.scan("t").filter(T.Col("x") < T.Lit(7))
           .agg(n=("count", None)).execute().to_pydict())
    assert int(np.asarray(got["n"])[0]) == int(exact.sum())


def test_skip_set_revalidation_guards_row_count():
    db = _mk(T, device_budget=DEV_BUDGET, device_batch_rows=DEV_BATCH)
    phys = plan_physical(_q1(T, db, _CUT["one_pct"]).plan, db,
                         distributed=True)
    sets = list(phys.skip_sets.values())
    assert sets and all(ss.valid_for(db.table("li")) for ss in sets)
    db.append("li", {k: v[:1] for k, v in _DATA.items()})
    assert all(not ss.valid_for(db.table("li")) for ss in sets)


def test_derive_skip_sets_respects_flag_and_string_filters():
    from repro_torch.core.optimizer import optimize
    on, off = _mk(T), _mk(T, data_skipping=False)
    num = optimize(_q1(T, on, _CUT["half"]).plan, on.catalog)
    assert derive_skip_sets(num, on)
    assert derive_skip_sets(num, off) == {}
    s = optimize(on.scan("li").filter(T.Col("flag") == T.Lit("A"))
                 .agg(n=("count", None)).plan, on.catalog)
    assert derive_skip_sets(s, on) == {}


def test_skip_set_matches_reference(hostdbs):
    """The derived candidate bitmap is the reference's, block for block."""
    from repro.core.optimizer import optimize as ref_optimize
    from repro.core.physplan import derive_skip_sets as ref_derive
    from repro_torch.core.optimizer import optimize
    for sel in SELECTIVITIES:
        t_plan = optimize(_q6(T, hostdbs[T, True], _CUT[sel]).plan,
                          hostdbs[T, True].catalog)
        r_plan = ref_optimize(_q6(R, hostdbs[R, True], _CUT[sel]).plan,
                              hostdbs[R, True].catalog)
        (t_ss,) = derive_skip_sets(t_plan, hostdbs[T, True]).values()
        (r_ss,) = ref_derive(r_plan, hostdbs[R, True]).values()
        np.testing.assert_array_equal(t_ss.cand, r_ss.cand)
        assert t_ss.columns == r_ss.columns


# ---------------------------------------------------------------------------
# the reference's NaN crash: +-inf in a float column, equality filter
# ---------------------------------------------------------------------------


def _inf_column():
    x = np.linspace(0.0, 1.0, 3 * IMPRINT_BLOCK)
    x[10] = -np.inf
    x[-10] = np.inf
    x[[5, 2 * IMPRINT_BLOCK + 5]] = 0.5
    return {"x": x, "v": np.arange(len(x), dtype=np.float64)}


def test_inf_range_equality_answers_as_without_skipping():
    """A float column holding -inf and +inf gives its imprint the histogram
    range (-inf, inf); an equality bound's bin position is then inf/inf.
    The reference raises there; the port answers as with
    ``data_skipping=False``, on the host and on the device tier."""
    data = _inf_column()
    ref = R.startup()
    ref.create_table("t", data)
    with pytest.raises(ValueError, match="NaN"):
        (ref.scan("t").filter(R.Col("x") == R.Lit(0.5))
         .agg(n=("count", None)).execute())
    ref.shutdown()
    want = int((data["x"] == 0.5).sum())
    for kw in ({}, {"device_budget": DEV_BUDGET,
                    "device_batch_rows": DEV_BATCH}):
        on = T.startup(device="cpu", **kw)
        off = T.startup(device="cpu", data_skipping=False, **kw)
        for db in (on, off):
            db.create_table("t", data)
        dist = bool(kw)
        q = lambda d: (d.scan("t").filter(T.Col("x") == T.Lit(0.5))
                       .agg(n=("count", None), s=("sum", "v")))
        r_on = q(on).execute(distributed=dist).to_pydict()
        r_off = q(off).execute(distributed=dist).to_pydict()
        _assert_bits(r_on, r_off, f"inf range, distributed={dist}")
        assert on.last_stats.device_tier == ("resident" if dist else "")
        assert int(np.asarray(r_on["n"])[0]) == want >= 2
        imp = on.index_manager.get_imprint("t", "x")
        assert imp.lo == -np.inf and imp.hi == np.inf
        assert imp.candidate_blocks(0.5, 0.5, False, False).all()


# ---------------------------------------------------------------------------
# the gathered layout: exactly the candidate slots of a boundary batch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("live_blocks", [(0, 2, 4, 6, 8, 10, 12, 14),
                                         (1, 5, 6), (15,), (3,)])
def test_gathered_batch_uploads_exactly_its_candidate_slots(live_blocks):
    """One 32,768-row batch of 16 imprint blocks, of which ``live_blocks``
    hold qualifying rows: the batch uploads exactly those q slots (q need
    not be a power of two), ``bytes_skipped_h2d`` counts the other 16 - q,
    and the result is bit-identical to the full upload and to the host."""
    n = 16 * IMPRINT_BLOCK
    rng = np.random.default_rng(9)
    blk = np.full(16, 900)
    blk[list(live_blocks)] = 100
    data = {"ship": np.repeat(blk, IMPRINT_BLOCK).astype(np.int32),
            "qty": rng.integers(1, 51, n).astype(np.float64),
            "flag": np.asarray(["A", "N", "R"],
                               dtype=object)[rng.integers(0, 3, n)]}

    def q(db):
        return (db.scan("li").filter(T.Col("ship") <= T.Lit(500))
                .group_by("flag")
                .agg(total=("sum", T.Col("qty")), n=("count", None))
                .order_by("flag"))

    on = _mk(T, data, device_budget=DEV_BUDGET, device_batch_rows=n)
    off = _mk(T, data, device_budget=DEV_BUDGET, device_batch_rows=n,
              data_skipping=False)
    r_on = q(on).execute(distributed=True).to_pydict()
    r_off = q(off).execute(distributed=True).to_pydict()
    s_on, s_off = on.last_stats, off.last_stats
    spec = plan_physical(q(on).plan, on, distributed=True).scan_agg
    row_bytes = scan_agg_geometry(spec, on.table("li"), n).row_bytes
    k = len(live_blocks)
    assert s_on.device_tier == "resident"
    assert s_on.blocks_skipped == 0                  # the batch is live
    assert s_on.bytes_skipped_h2d == (16 - k) * IMPRINT_BLOCK * row_bytes
    # the compact upload: k slots of every column block plus the (16,)
    # int32 slot map, against 16 slots without skipping
    assert s_on.device_bytes_h2d == k * IMPRINT_BLOCK * row_bytes + 16 * 4
    assert s_off.device_bytes_h2d == 16 * IMPRINT_BLOCK * row_bytes
    _assert_bits(r_on, r_off, f"gathered {live_blocks}")
    _assert_bits(r_on, q(off).execute().to_pydict(), "vs host")
