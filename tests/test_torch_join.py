"""The port's device join and sort tier (repro_torch) against the reference
(repro) on the CPU: TPC-H Q3 at sf 0.01 with ``device_batch_rows=8192``.

Both packages load the same ``tpch.generate`` arrays.  The port runs with
``device="cpu"``, where its batch steps are the same torch programs it
runs on the card and each kernel wrapper (``radix_build``,
``radix_probe``, ``sort``) takes its plain version.  Contracts:

* device tier vs the reference's device tier: ``rtol=1e-9``, keys exact;
* host tier vs the reference's host tier: bit-identical;
* the port's budget matrix {unlimited, 64 MiB, 4 MiB, 2 MiB}:
  bit-identical, ``device_bytes_peak <= budget``, 2 MiB streams;
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


def _port_db(data, budget=None, batch_rows=BATCH_ROWS):
    db = T.startup(device="cpu", device_budget=budget,
                   device_batch_rows=batch_rows)
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
    """Q3 in every device-budget cell, one cold database per cell."""
    out = {}
    for budget in DEVICE_BUDGETS:
        db = _port_db(q3_data, budget)
        res = q3(db).execute(distributed=True).to_pydict()
        s = db.last_stats
        out[budget] = (res, s.device_tier, s.device_sorted,
                       s.device_bytes_peak, s.device_evictions)
    return out


def test_q3_matrix_runs_on_device(device_cells):
    for budget, (_res, tier, srt, peak, _ev) in device_cells.items():
        assert tier.startswith("join-") and srt, (budget, tier)
        if budget is not None:
            assert peak <= budget, (budget, peak)
    assert device_cells[2 << 20][1] == "join-streamed"
    assert device_cells[64 << 20][1] == "join-resident"


def test_q3_matrix_bit_identical(device_cells):
    ref = device_cells[None][0]
    for budget in DEVICE_BUDGETS[1:]:
        _assert_bits(device_cells[budget][0], ref, f"budget={budget}")


def test_q3_matrix_matches_host(device_cells, q3_data):
    host = q3(_port_db(q3_data)).execute().to_pydict()
    for budget, (res, *_s) in device_cells.items():
        _assert_close(res, host, f"budget={budget} vs host")


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
