"""The port's kernels (repro_torch.kernels) against the reference kernels
(repro.kernels) on the CPU: scan_agg, hash_group, radix_join (build and
probe) and sort.

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
  the reference network and the port must give the same permutation.

The CUDA kernels themselves run only on the card: ``chip_smoke.py`` holds
each against its plain version there.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.hash_group import ops as ref_hops
from repro.kernels.radix_join import ops as ref_rops
from repro.kernels.radix_join.ref import radix_join_ref
from repro.kernels.scan_agg import ops as ref_sops
from repro.kernels.sort import ops as ref_soops
from repro_torch.kernels.hash_group import kernel as hk
from repro_torch.kernels.hash_group import ops as hops
from repro_torch.kernels.hash_group.ref import hash_group_ref
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


@pytest.mark.parametrize("call,calls,launches", [
    (_call_hash_group, hk.CALLS, hk.LAUNCHES),
    (_call_radix_build, rk.BUILD_CALLS, rk.BUILD_LAUNCHES),
    (_call_radix_probe, rk.PROBE_CALLS, rk.PROBE_LAUNCHES),
    (_call_sort, so.CALLS, so.LAUNCHES)])
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
