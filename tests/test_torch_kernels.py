"""The port's kernels (repro_torch.kernels) against the reference kernels
(repro.kernels) on the CPU.

On a CPU tensor each wrapper runs its plain PyTorch version, so these tests
hold the port's arithmetic to the reference shims on the same numpy inputs:

* against the Pallas kernels in interpret mode (float32), with the
  tolerances of ``tests/test_kernels.py`` and exact counts;
* against the reference shims' host mirrors (``use_pallas=False``, float64
  sums of float32-cast inputs) at ``rtol=1e-12`` with exact counts.  Inputs
  are float32-representable, so both sides see the same values; values are
  positive, so no sum cancels.

The CUDA kernels themselves run only on the card: ``chip_smoke.py`` holds
each against its plain version there.
"""

import numpy as np
import pytest
import torch

from repro.kernels.hash_group import ops as ref_hops
from repro.kernels.scan_agg import ops as ref_sops
from repro_torch.kernels.hash_group import kernel as hk
from repro_torch.kernels.hash_group import ops as hops
from repro_torch.kernels.hash_group.ref import hash_group_ref
from repro_torch.kernels.scan_agg import kernel as sk
from repro_torch.kernels.scan_agg import ops as sops
from repro_torch.kernels.scan_agg.ref import scan_agg_ref

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
# the wrappers' contracts
# ---------------------------------------------------------------------------


def test_wrappers_count_calls_not_launches_on_cpu(rng):
    before_calls, before_launch = hk.CALLS.count, hk.LAUNCHES.count
    hops.grouped_aggregate(rng.integers(0, 3, 50), np.ones((1, 50)), 3,
                           device="cpu")
    assert hk.CALLS.count == before_calls + 1
    assert hk.LAUNCHES.count == before_launch     # plain version: no launch


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
