"""The port's kernels (repro_torch.kernels) against the reference kernels
(repro.kernels) on the CPU: scan_agg, hash_group, radix_join (build and
probe), sort and imprint.

On a CPU tensor each wrapper runs its plain PyTorch version, so these tests
hold the port's arithmetic to the reference shims on the same numpy inputs:

* against the Pallas kernels in interpret mode (float32), with the
  tolerances of ``tests/test_kernels.py`` and exact counts;
* against the reference shims' host mirrors (``use_pallas=False``, float64
  sums of float32-cast inputs) at ``rtol=1e-12`` with exact counts.  Inputs
  are float32-representable, so both sides see the same values; values are
  positive, so no sum cancels;
* radix_join also against the reference's unpartitioned oracle
  (``ref.radix_join_ref``), and sort with float32-representable keys, so
  the reference network and the port must give the same permutation;
* imprint bit for bit against the float64 numpy loop the reference engine
  builds its imprints with (``build_zone_maps``, and ``_extend_imprint``'s
  bins), and against the float32 Pallas kernel in interpret mode: equal
  bitmaps, Pallas bounds enclosing the port's.

The CUDA kernels themselves run only on the card: ``chip_smoke.py`` holds
each against its plain version there.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import indexes as ref_indexes
from repro.core.types import DBType as RDBType
from repro.kernels.hash_group import ops as ref_hops
from repro.kernels.imprint import ops as ref_iops
from repro.kernels.radix_join import ops as ref_rops
from repro.kernels.radix_join.ref import radix_join_ref
from repro.kernels.scan_agg import ops as ref_sops
from repro.kernels.sort import ops as ref_soops
from repro_torch.kernels.hash_group import kernel as hk
from repro_torch.kernels.hash_group import ops as hops
from repro_torch.kernels.hash_group.ref import hash_group_ref
from repro_torch.kernels.imprint import kernel as ik
from repro_torch.kernels.imprint import ops as iops
from repro_torch.kernels.radix_join import kernel as rk
from repro_torch.kernels.radix_join import ops as rops
from repro_torch.kernels.radix_join.ref import radix_build_ref
from repro_torch.kernels.scan_agg import kernel as sk
from repro_torch.kernels.scan_agg import ops as sops
from repro_torch.kernels.scan_agg.ref import scan_agg_ref
from repro_torch.kernels.sort import kernel as so
from repro_torch.kernels.sort import ops as soops

# test_kernels.py's sweeps
SCAN_SWEEP = [(1, 100, 1024), (3, 9000, 2048), (6, 40000, 8192)]
# (n, G, V, case): test_kernels.py's sweep, then the 4096-group cap, a
# ragged n and a batch whose every row is masked
HG_SWEEP = [(100, 3, 1, "sweep"), (4096, 37, 4, "sweep"),
            (10000, 256, 2, "sweep"), (5000, 4096, 2, "g4096"),
            (4099, 13, 15, "ragged"), (4096, 12, 15, "all_masked")]


def _f32(a):
    return np.asarray(a, dtype=np.float32).astype(np.float64)


def _scan_inputs(rng, C, n, positive):
    lo, hi = (0.0, 10.0) if positive else (-10.0, 10.0)
    cols = _f32(rng.uniform(lo, hi, (C, n)))
    ranges = np.full((C, 2), (-np.inf, np.inf))
    ranges[0] = (2.0, 8.0) if positive else (-5.0, 5.0)
    pairs = tuple((i, (i + 1) % C if C > 1 else -1) for i in range(C))
    return cols, ranges, pairs


def _hg_inputs(rng, n, G, V, case, positive):
    gid = rng.integers(0, G, n)
    lo, hi = (0.5, 1.5) if positive else (-3.0, 3.0)
    vals = _f32(rng.uniform(lo, hi, (V, n)))
    mask = np.zeros(n, dtype=bool) if case == "all_masked" \
        else rng.random(n) < 0.7
    return gid, vals, mask


# ---------------------------------------------------------------------------
# scan_agg
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("C,n,block", SCAN_SWEEP)
def test_scan_agg_matches_pallas_interpret(rng, C, n, block):
    cols, ranges, pairs = _scan_inputs(rng, C, n, positive=False)
    ref = ref_sops.fused_filter_agg(cols, ranges, pairs, block_rows=block,
                                    interpret=True)
    got = sops.fused_filter_agg(cols, ranges, pairs, device="cpu")
    np.testing.assert_allclose(got[:-1], ref[:-1], rtol=2e-4)
    assert got[-1] == ref[-1]


@pytest.mark.parametrize("C,n,block", SCAN_SWEEP)
def test_scan_agg_matches_host_mirror_f64(rng, C, n, block):
    cols, ranges, pairs = _scan_inputs(rng, C, n, positive=True)
    ref = ref_sops.fused_filter_agg(cols, ranges, pairs, use_pallas=False)
    got = sops.fused_filter_agg(cols, ranges, pairs, device="cpu")
    np.testing.assert_allclose(got[:-1], ref[:-1], rtol=1e-12, atol=0)
    assert got[-1] == ref[-1]


def test_scan_agg_no_filters_counts_all(rng):
    cols = _f32(rng.uniform(0, 1, (2, 5000)))
    ranges = np.full((2, 2), (-np.inf, np.inf))
    got = sops.fused_filter_agg(cols, ranges, ((0, -1),), device="cpu")
    ref = ref_sops.fused_filter_agg(cols, ranges, ((0, -1),),
                                    use_pallas=False)
    assert got[-1] == 5000 == ref[-1]


def test_scan_agg_invalid_rows_are_never_selected(rng):
    cols = torch.as_tensor(rng.uniform(0, 1, (2, 300)))
    lo = torch.full((2,), -np.inf, dtype=torch.float64)
    hi = torch.full((2,), np.inf, dtype=torch.float64)
    valid = torch.zeros(300, dtype=torch.bool)
    valid[:100] = True
    pairs = torch.tensor([[0, 1], [1, -1]], dtype=torch.int32)
    out = sk.scan_agg(cols, lo, hi, valid, pairs)
    assert float(out[-1]) == 100.0
    np.testing.assert_allclose(float(out[1]), float(cols[1, :100].sum()),
                               rtol=1e-12)
    assert torch.equal(out, scan_agg_ref(cols, lo, hi, valid, pairs))


# ---------------------------------------------------------------------------
# hash_group
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,G,V,case", HG_SWEEP)
def test_hash_group_matches_pallas_interpret(rng, n, G, V, case):
    gid, vals, mask = _hg_inputs(rng, n, G, V, case, positive=False)
    ref = ref_hops.grouped_aggregate(gid, vals, G, mask=mask, interpret=True)
    got = hops.grouped_aggregate(gid, vals, G, mask=mask, device="cpu")
    np.testing.assert_allclose(got[:, :V], ref[:, :V], atol=1e-3)
    np.testing.assert_array_equal(got[:, V], ref[:, V])


@pytest.mark.parametrize("n,G,V,case", HG_SWEEP)
def test_hash_group_matches_host_mirror_f64(rng, n, G, V, case):
    gid, vals, mask = _hg_inputs(rng, n, G, V, case, positive=True)
    ref = ref_hops.grouped_aggregate(gid, vals, G, mask=mask,
                                     use_pallas=False)
    got = hops.grouped_aggregate(gid, vals, G, mask=mask, device="cpu")
    np.testing.assert_allclose(got[:, :V], ref[:, :V], rtol=1e-12, atol=0)
    np.testing.assert_array_equal(got[:, V], ref[:, V])
    if case == "all_masked":
        assert not got.any()


def test_hash_group_drops_trash_rows(rng):
    gid = torch.as_tensor(rng.integers(0, 6, 1000).astype(np.int32))
    vals = torch.ones((1, 1000), dtype=torch.float64)
    out = hk.hash_group(gid, vals, 4)          # ids 4, 5: outside the domain
    want = np.bincount(gid.numpy(), minlength=6)[:4]
    np.testing.assert_array_equal(out[:, 0].numpy(), want)
    assert torch.equal(out, hash_group_ref(gid, vals, 4))


def test_hash_group_tile_depends_on_shapes_only():
    assert hk.tile_rows(65536, 12, 15) == hk.MIN_TILE
    for n, G, V in ((65536, 4096, 15), (4099, 13, 15), (1, 1, 1),
                    (10 ** 7, 4096, 64)):
        t = hk.tile_rows(n, G, V)
        assert hk.MIN_TILE <= t <= hk.MAX_TILE and t % 256 == 0
        assert t == hk.tile_rows(n, G, V)
    # large domains take larger tiles so the partials stay bounded
    assert hk.tile_rows(65536, 4096, 15) > hk.tile_rows(65536, 12, 15)


# ---------------------------------------------------------------------------
# radix_join
# ---------------------------------------------------------------------------

# test_kernels.py's sweep: (build rows, probe rows, payload lanes, n_bits)
RJ_SWEEP = [(50, 200, 1, 2), (1000, 8000, 3, 4), (4096, 20000, 2, 5)]


def _rj_inputs(rng, nb, np_, V):
    bk = rng.choice(3 * nb, size=nb, replace=False).astype(np.int64)
    bv = rng.normal(size=(V, nb))
    pk = rng.integers(-10, 3 * nb + 10, np_).astype(np.int64)  # + misses
    return bk, bv, pk


@pytest.mark.parametrize("nb,np_,V,n_bits", RJ_SWEEP)
def test_radix_join_matches_unpartitioned_oracle(rng, nb, np_, V, n_bits):
    """The port's dense build + probe against ``radix_join_ref`` (the
    function the port holds to): match bits and payload exact, on
    float32-representable payloads."""
    bk, bv, pk = _rj_inputs(rng, nb, np_, V)
    bv = _f32(bv)          # exact whether or not the oracle runs in x64
    pk = np.clip(pk, 0, None)               # the oracle's domain is [0, D)
    m, g = rops.radix_join(bk, bv, pk, device="cpu")
    mr, gr = radix_join_ref(jnp.asarray(bk), jnp.asarray(bv),
                            jnp.asarray(pk), 3 * nb)
    np.testing.assert_array_equal(m, np.asarray(mr))
    np.testing.assert_array_equal(g, np.asarray(gr))


@pytest.mark.parametrize("nb,np_,V,n_bits", RJ_SWEEP)
def test_radix_join_matches_pallas_interpret(rng, nb, np_, V, n_bits):
    bk, bv, pk = _rj_inputs(rng, nb, np_, V)
    mp, gp = ref_rops.radix_join(bk, bv, pk, n_bits=n_bits, interpret=True)
    m, g = rops.radix_join(bk, bv, pk, device="cpu")
    np.testing.assert_array_equal(m, mp)
    np.testing.assert_allclose(g, gp, atol=1e-5)


@pytest.mark.parametrize("nb,np_,V,n_bits", RJ_SWEEP)
def test_radix_join_matches_host_mirror(rng, nb, np_, V, n_bits):
    bk, bv, pk = _rj_inputs(rng, nb, np_, V)
    bv = _f32(bv)                # the mirror casts the payload to float32
    mn, gn = ref_rops.radix_join(bk, bv, pk, n_bits=n_bits,
                                 use_pallas=False)
    m, g = rops.radix_join(bk, bv, pk, device="cpu")
    np.testing.assert_array_equal(m, mn)
    np.testing.assert_array_equal(g, gn)


def test_radix_join_negative_domain():
    """Key domains are rebased by the shim: negative key values join
    correctly (the engine's DATE/offset domains)."""
    bk = (np.arange(64) - 32).astype(np.int64)
    bv = np.arange(64, dtype=np.float64)[None, :]
    pk = np.asarray([-32, -1, 0, 31, 99, -40], dtype=np.int64)
    m, g = rops.radix_join(bk, bv, pk, device="cpu")
    mr, gr = ref_rops.radix_join(bk, bv, pk, n_bits=2, interpret=True)
    np.testing.assert_array_equal(m, [True, True, True, True, False, False])
    np.testing.assert_array_equal(m, mr)
    np.testing.assert_array_equal(g[:, 0], [0, 31, 32, 63, 0, 0])
    np.testing.assert_allclose(g, gr, atol=1e-5)


def test_radix_build_counts_duplicates_and_drops_trash(rng):
    """Lane 0 of ones counts each code's rows (> 1: a duplicate build key,
    the join tier's witness); codes outside [0, D) contribute nothing."""
    code = torch.as_tensor(rng.integers(-3, 40, 5000).astype(np.int32))
    vals = torch.ones((2, 5000), dtype=torch.float64)
    vals[1] = torch.as_tensor(rng.integers(0, 9, 5000).astype(np.float64))
    out = rk.radix_build(code, vals, 32)
    c = code.numpy()
    ok = (c >= 0) & (c < 32)
    np.testing.assert_array_equal(out[:, 0].numpy(),
                                  np.bincount(c[ok], minlength=32))
    np.testing.assert_array_equal(
        out[:, 1].numpy(),
        np.bincount(c[ok], weights=vals[1].numpy()[ok], minlength=32))
    assert float(out[:, 0].max()) > 1.0
    assert not rk.radix_build(torch.full((9,), 32, dtype=torch.int32),
                              torch.ones((1, 9), dtype=torch.float64),
                              32).any()


def test_radix_probe_gathers_rows_and_zeros_misses(rng):
    btab = torch.as_tensor(rng.normal(size=(50, 3)))
    code = torch.as_tensor(np.asarray([0, 49, -1, 50, 7, 1 << 30],
                                      dtype=np.int32))
    out = rk.radix_probe(code, btab)
    want = np.zeros((6, 3))
    want[[0, 1, 4]] = btab.numpy()[[0, 49, 7]]
    np.testing.assert_array_equal(out.numpy(), want)


def test_radix_build_matches_its_plain_version(rng):
    code = torch.as_tensor(rng.integers(0, 100, 3000).astype(np.int32))
    vals = torch.as_tensor(rng.normal(size=(3, 3000)))
    assert torch.equal(rk.radix_build(code, vals, 100),
                       radix_build_ref(code, vals, 100))


# ---------------------------------------------------------------------------
# sort
# ---------------------------------------------------------------------------


def _sort_keys(rng, n):
    """float32-representable keys with NaNs and heavy ties
    (test_kernels.py's sweep)."""
    keys = rng.normal(size=n).astype(np.float32)
    keys[rng.random(n) < 0.1] = np.nan
    keys[rng.random(n) < 0.3] = 1.25
    return keys


@pytest.mark.parametrize("n", [1, 2, 100, 1024, 5000])
def test_sort_matches_pallas_interpret(rng, n):
    keys = _sort_keys(rng, n)
    sk, si = ref_soops.sort_block(keys, interpret=True)
    got_k, got_i = soops.sort_block(keys, device="cpu")
    np.testing.assert_array_equal(got_i, si)
    np.testing.assert_array_equal(got_k, sk.astype(np.float64))


@pytest.mark.parametrize("n", [2, 100, 1024, 5000])
def test_sort_matches_host_mirror(rng, n):
    keys = _sort_keys(rng, n)
    sk, si = ref_soops.sort_block(keys, use_pallas=False)
    got_k, got_i = soops.sort_block(keys, device="cpu")
    np.testing.assert_array_equal(got_i, si)
    np.testing.assert_array_equal(got_k, sk.astype(np.float64))


@pytest.mark.parametrize("limit", [None, 10])
@pytest.mark.parametrize("n_keys", [1, 2, 3])
def test_lexsort_matches_np_lexsort(rng, limit, n_keys):
    """The engine's device lexsort (primary-first keys, a chain of stable
    sorts) against np.lexsort and the reference shim: the same
    permutation, the same top-N slice."""
    n = 4000
    keys = [np.round(rng.normal(size=n), 1)] + [
        rng.integers(0, 50, n).astype(np.float64)
        for _ in range(n_keys - 1)]
    keys[-1][rng.random(n) < 0.1] = np.inf           # NULLs sort last
    got = soops.lexsort([torch.as_tensor(k) for k in keys], limit).numpy()
    want = np.lexsort(tuple(reversed(keys)))
    want = want if limit is None else want[:limit]
    np.testing.assert_array_equal(got, want)
    ref = ref_soops.lexsort_indices(tuple(keys), limit=limit,
                                    use_device=False)
    np.testing.assert_array_equal(got, ref)


def test_lexsort_of_no_rows_launches_nothing():
    calls = so.CALLS.count
    perm = soops.lexsort([torch.zeros(0, dtype=torch.float64)], 10)
    assert perm.shape == (0,) and so.CALLS.count == calls


def test_sort_padding_sorts_after_real_inf():
    """The network pads to a power of two with +inf keys and indices
    >= n; a real +inf key (a NULL sort key) still sorts before them and
    ties keep their input order."""
    assert so.padded_size(1) == 2 and so.padded_size(5) == 8
    assert so.padded_size(16384) == 16384
    keys = torch.tensor([np.inf, 1.0, np.inf, 0.0, 1.0],
                        dtype=torch.float64)
    sk, perm = so.sort_pairs(keys)
    assert perm.tolist() == [3, 1, 4, 0, 2]
    assert sk.tolist() == [0.0, 1.0, 1.0, np.inf, np.inf]


# ---------------------------------------------------------------------------
# the wrappers' contracts
# ---------------------------------------------------------------------------


def _call_hash_group(rng):
    hops.grouped_aggregate(rng.integers(0, 3, 50), np.ones((1, 50)), 3,
                           device="cpu")


def _call_radix_build(rng):
    rk.radix_build(torch.zeros(4, dtype=torch.int32),
                   torch.ones((1, 4), dtype=torch.float64), 2)


def _call_radix_probe(rng):
    rk.radix_probe(torch.zeros(4, dtype=torch.int32),
                   torch.ones((2, 1), dtype=torch.float64))


def _call_sort(rng):
    soops.sort_block(rng.normal(size=9), device="cpu")


def _call_imprint(rng):
    ik.zone_maps(torch.as_tensor(rng.normal(size=9)))


@pytest.mark.parametrize("call,calls,launches", [
    (_call_hash_group, hk.CALLS, hk.LAUNCHES),
    (_call_radix_build, rk.BUILD_CALLS, rk.BUILD_LAUNCHES),
    (_call_radix_probe, rk.PROBE_CALLS, rk.PROBE_LAUNCHES),
    (_call_sort, so.CALLS, so.LAUNCHES),
    (_call_imprint, ik.CALLS, ik.LAUNCHES)])
def test_wrappers_count_calls_not_launches_on_cpu(rng, call, calls,
                                                  launches):
    before_calls, before_launch = calls.count, launches.count
    call(rng)
    assert calls.count == before_calls + 1
    assert launches.count == before_launch        # plain version: no launch


@pytest.mark.parametrize("bad", ["gid_dtype", "vals_dtype", "shape",
                                 "device", "mixed_devices"])
def test_hash_group_rejects_bad_arguments(bad):
    gid = torch.zeros(8, dtype=torch.int32)
    vals = torch.ones((2, 8), dtype=torch.float64)
    if bad == "gid_dtype":
        gid, err = gid.to(torch.int64), TypeError
    elif bad == "vals_dtype":
        vals, err = vals.to(torch.float32), TypeError
    elif bad == "shape":
        vals, err = torch.ones((2, 9), dtype=torch.float64), TypeError
    elif bad == "device":
        # a tensor on neither CPU nor CUDA never reaches the plain version
        gid, vals, err = gid.to("meta"), vals.to("meta"), ValueError
    else:
        vals, err = vals.to("meta"), ValueError
    with pytest.raises(err):
        hk.hash_group(gid, vals, 4)


@pytest.mark.parametrize("bad", ["cols_dtype", "valid_dtype", "pairs_dtype",
                                 "too_many_pairs", "device"])
def test_scan_agg_rejects_bad_arguments(bad):
    cols = torch.ones((2, 8), dtype=torch.float64)
    lo = torch.zeros(2, dtype=torch.float64)
    hi = torch.ones(2, dtype=torch.float64)
    valid = torch.ones(8, dtype=torch.bool)
    pairs = torch.tensor([[0, 1]], dtype=torch.int32)
    err = TypeError
    if bad == "cols_dtype":
        cols = cols.to(torch.float32)
    elif bad == "valid_dtype":
        valid = valid.to(torch.uint8)
    elif bad == "pairs_dtype":
        pairs = pairs.to(torch.int64)
    elif bad == "too_many_pairs":
        pairs = torch.zeros((sk.MAX_PAIRS + 1, 2), dtype=torch.int32)
    else:
        cols, lo, hi, valid, pairs = (t.to("meta") for t in
                                      (cols, lo, hi, valid, pairs))
        err = ValueError
    with pytest.raises(err):
        sk.scan_agg(cols, lo, hi, valid, pairs)


@pytest.mark.parametrize("bad", ["code_dtype", "vals_dtype", "shape",
                                 "domain", "device", "mixed_devices"])
def test_radix_build_rejects_bad_arguments(bad):
    code = torch.zeros(8, dtype=torch.int32)
    vals = torch.ones((2, 8), dtype=torch.float64)
    domain, err = 4, TypeError
    if bad == "code_dtype":
        code = code.to(torch.int64)
    elif bad == "vals_dtype":
        vals = vals.to(torch.float32)
    elif bad == "shape":
        vals = torch.ones((2, 9), dtype=torch.float64)
    elif bad == "domain":
        domain, err = 0, ValueError
    elif bad == "device":
        code, vals, err = code.to("meta"), vals.to("meta"), ValueError
    else:
        vals, err = vals.to("meta"), ValueError
    with pytest.raises(err):
        rk.radix_build(code, vals, domain)


@pytest.mark.parametrize("bad", ["code_dtype", "btab_dtype", "empty_table",
                                 "device", "mixed_devices"])
def test_radix_probe_rejects_bad_arguments(bad):
    code = torch.zeros(8, dtype=torch.int32)
    btab = torch.ones((4, 2), dtype=torch.float64)
    err = TypeError
    if bad == "code_dtype":
        code = code.to(torch.int16)
    elif bad == "btab_dtype":
        btab = btab.to(torch.float32)
    elif bad == "empty_table":
        btab = torch.ones((0, 2), dtype=torch.float64)
    elif bad == "device":
        code, btab, err = code.to("meta"), btab.to("meta"), ValueError
    else:
        btab, err = btab.to("meta"), ValueError
    with pytest.raises(err):
        rk.radix_probe(code, btab)


@pytest.mark.parametrize("bad", ["dtype", "shape", "device",
                                 "not_contiguous"])
def test_sort_rejects_bad_arguments(bad):
    keys = torch.ones(8, dtype=torch.float64)
    err = TypeError
    if bad == "dtype":
        keys = keys.to(torch.float32)
    elif bad == "shape":
        keys = torch.ones((2, 4), dtype=torch.float64)
    elif bad == "device":
        keys, err = keys.to("meta"), ValueError
    else:
        keys, err = torch.ones(16, dtype=torch.float64)[::2], ValueError
    with pytest.raises(err):
        so.sort_pairs(keys)


@pytest.mark.parametrize("bad", ["dtype", "shape", "device",
                                 "not_contiguous", "div", "inv"])
def test_imprint_rejects_bad_arguments(bad):
    vals = torch.ones(8, dtype=torch.float64)
    div, rng, err = 1.0, None, TypeError
    if bad == "dtype":
        vals = vals.to(torch.int8)
    elif bad == "shape":
        vals = torch.ones((2, 4), dtype=torch.float64)
    elif bad == "device":
        vals, err = vals.to("meta"), ValueError
    elif bad == "not_contiguous":
        vals, err = torch.ones(16, dtype=torch.float64)[::2], ValueError
    elif bad == "div":
        div, err = 0.0, ValueError
    else:
        rng, err = (0.0, -1.0), ValueError
    with pytest.raises(err):
        ik.zone_maps(vals, div, rng)


# ---------------------------------------------------------------------------
# imprint
# ---------------------------------------------------------------------------

_I32_NULL = np.iinfo(np.int32).min
_I64_NULL = np.iinfo(np.int64).min


def _imprint_column(rng, case, n):
    """``(stored values, reference dbtype, scale)`` of one edge case."""
    if case == "ragged":
        return rng.uniform(-100, 100, n), RDBType.FLOAT64, 0
    if case == "null_block":              # one block with no valid row
        v = rng.uniform(-100, 100, n)
        v[2048:4096] = np.nan
        return v, RDBType.FLOAT64, 0
    if case == "constant":
        return np.full(n, 42.5), RDBType.FLOAT64, 0
    if case == "int64_sentinel":
        v = rng.integers(-10**12, 10**12, n).astype(np.int64)
        v[rng.random(n) < 0.2] = _I64_NULL
        v[:2048] = _I64_NULL              # an all-NULL block too
        return v, RDBType.INT64, 0
    if case == "decimal":
        v = rng.integers(-10**9, 10**9, n).astype(np.int64)
        v[rng.random(n) < 0.1] = _I64_NULL
        return v, RDBType.DECIMAL, 2
    if case == "date":
        v = np.sort(rng.integers(8000, 10500, n)).astype(np.int32)
        v[rng.random(n) < 0.05] = _I32_NULL
        return v, RDBType.DATE, 0
    if case == "float_nan":
        v = rng.normal(0, 1e6, n)
        v[rng.random(n) < 0.3] = np.nan
        return v, RDBType.FLOAT64, 0
    if case == "float32":
        v = rng.normal(0, 10, n).astype(np.float32)
        v[rng.random(n) < 0.1] = np.nan
        return v, RDBType.FLOAT32, 0
    assert case == "all_null"
    return np.full(n, _I32_NULL, dtype=np.int32), RDBType.INT32, 0


def _reference_input(v, dbtype, scale):
    """The reference engine's ``build_imprint`` preparation of a column:
    float64 values (DECIMAL divided by 10**scale) and the NULL mask."""
    f = v.astype(np.float64)
    if dbtype == RDBType.DECIMAL:
        f = f / (10 ** scale)
    if dbtype in (RDBType.FLOAT32, RDBType.FLOAT64):
        return f, np.isnan(f)
    return f, v == (_I32_NULL if v.dtype == np.int32 else _I64_NULL)


def _assert_zone_maps_equal(got, want):
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype
    assert got[3:] == want[3:]                # lo, hi: Python floats


@pytest.mark.parametrize("n,null_frac", [(100, 0.0), (5000, 0.1),
                                         (20480, 0.5), (2048, 1.0)])
def test_imprint_matches_host_mirror_bit_identical(rng, n, null_frac):
    """test_kernels.py's sweep: the port's zone maps equal the reference
    engine's float64 ``build_zone_maps`` bit for bit."""
    vals = rng.uniform(-100, 100, n)
    nulls = rng.random(n) < null_frac
    col = np.where(nulls, np.nan, vals)
    got = iops.build_zone_maps(torch.as_tensor(col))
    _assert_zone_maps_equal(got, ref_iops.build_zone_maps(vals, nulls,
                                                          2048, 16))


@pytest.mark.parametrize("case", ["ragged", "null_block", "constant",
                                  "int64_sentinel", "decimal", "date",
                                  "float_nan", "float32", "all_null"])
def test_imprint_edge_cases_bit_identical(rng, case):
    n = 5 * 2048 + 1234
    v, dbtype, scale = _imprint_column(rng, case, n)
    div = float(10 ** scale)
    got = iops.build_zone_maps(torch.as_tensor(v), div)
    want = ref_iops.build_zone_maps(*_reference_input(v, dbtype, scale),
                                    2048, 16)
    _assert_zone_maps_equal(got, want)


class _Tail:
    """The table view ``_extend_imprint`` reads: schema, row count, tail."""

    def __init__(self, v, dbtype, scale):
        from repro.core.types import ColumnSchema
        self._v = v
        self.num_rows = len(v)
        cs = ColumnSchema("c", dbtype, scale=scale)
        self.schema = type("S", (), {"column": lambda _s, _n: cs})()

    def tail_array(self, _name, start):
        return self._v[start:]


@pytest.mark.parametrize("case", ["ragged", "int64_sentinel", "decimal",
                                  "date", "float_nan", "constant"])
def test_imprint_extension_matches_reference_bins(rng, case):
    """A tail appended past a ragged last block, with values outside the
    old range: one launch binned against the old (lo, hi) gives the
    reference ``_extend_imprint``'s mins, maxs and bitmaps."""
    n0 = 3 * 2048 + 500
    v, dbtype, scale = _imprint_column(rng, case, n0 + 4000)
    if case in ("ragged", "float_nan"):
        v[n0:] *= 3.0                       # beyond the old range
    f, nulls = _reference_input(v[:n0], dbtype, scale)
    mins, maxs, bm, lo, hi = ref_iops.build_zone_maps(f, nulls, 2048, 16)
    old = ref_indexes.Imprint(2048, mins, maxs, bm, lo, hi, n0)
    want = ref_indexes._extend_imprint(old, _Tail(v, dbtype, scale), "c")
    keep = n0 // 2048
    got = iops.extend_zone_maps(torch.as_tensor(v[keep * 2048:]),
                                float(10 ** scale), lo, hi)
    np.testing.assert_array_equal(got[0], want.mins[keep:])
    np.testing.assert_array_equal(got[1], want.maxs[keep:])
    np.testing.assert_array_equal(got[2], want.bitmaps[keep:])


def test_imprint_extension_bins_infinities_at_the_ends():
    """Appended +-inf against a finite old range land in bins 15 and 0
    (the plain version clamps before the cast, as the kernel does); a
    block holding +inf stays a candidate for a bound past the old range."""
    from repro_torch.core.indexes import Imprint
    tail = np.array([np.inf] * 3 + [-np.inf] * 2 + [np.nan])
    mins, maxs, bm = iops.extend_zone_maps(torch.as_tensor(tail), 1.0,
                                           0.0, 10.0)
    assert bm.tolist() == [(1 << 15) | 1]
    assert mins.tolist() == [-np.inf] and maxs.tolist() == [np.inf]
    imp = Imprint(2048, mins, maxs, bm, 0.0, 10.0, len(tail))
    assert imp.candidate_blocks(1e300, np.inf, False, False).all()


def test_imprint_host_vs_pallas_semantics(rng):
    """test_kernels.py's data through the Pallas kernel in interpret mode:
    the same bitmaps, and Pallas's widened float32 bounds enclose the
    port's exact float64 bounds."""
    vals = rng.normal(0, 10, 12345)
    nulls = rng.random(12345) < 0.2
    got = iops.build_zone_maps(torch.as_tensor(np.where(nulls, np.nan,
                                                        vals)))
    mp = ref_iops.build_zone_maps_pallas(vals, nulls, 2048, 16,
                                         interpret=True)
    np.testing.assert_array_equal(got[2], mp[2])
    assert (mp[0] <= got[0]).all() and (mp[1] >= got[1]).all()


def test_imprint_range_and_launch_shape(rng):
    """``zone_range`` reads (lo, hi, inv) off the block bounds as the
    reference's ``ops._range`` does off the values; without a range the
    wrapper returns bounds only (the build's first launch)."""
    vals = rng.uniform(-5, 5, 9000)
    nulls = rng.random(9000) < 0.3
    mins, maxs = ik.zone_maps(torch.as_tensor(np.where(nulls, np.nan,
                                                       vals)))
    assert mins.shape == maxs.shape == (5,)
    assert iops.zone_range(mins, maxs) == ref_iops._range(vals, nulls, 16)
    empty = torch.full((3,), np.inf, dtype=torch.float64)
    assert iops.zone_range(empty, -empty) == (0.0, 0.0, 0.0)
