"""The row-panel branch of grid_tpu_torch (distances beyond the d2 budget)
against grid_tpu on the same numpy inputs, on the CPU.

Tolerances (docs/parity.md):
- float64: neighbor indices identical, distances and dipCN within 1e-9.
- float32: the rule of ``tests/torch_parity.py``: lists equal except ties
  within 1e-5 of each row's k-th distance (each distance is a sum of R
  float32 products, summed in another order by torch and XLA), dipCN
  within 1e-5 on rows whose dipCN input sets agree, ``ok`` exact.

grid_tpu's ``knn_squared`` runs with ``selector="top_k"`` where rows hold
exact ties: ``lax.approx_max_k`` keeps column order among ties only in
float32 on the CPU (ROADMAP.md queue 3), ``lax.top_k`` always does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bench import make_matrix
from grid_tpu.models.cohort import CohortParams as JCohortParams
from grid_tpu.models.cohort import cohort_step as j_cohort_step
from grid_tpu.ops.knn import knn_squared as j_knn_squared
from grid_tpu.ops.select import dipcn_from_distances_panels as j_dipcn_panels
from grid_tpu_torch.convert import inputs_to_torch, outputs_to_numpy, params_from_reference
from grid_tpu_torch.io.hap_neighbors import pad_hap_neighbors
from grid_tpu_torch.models.cohort import CohortParams, cohort_step, d2_resident
from grid_tpu_torch.ops.gpu_kernels import (
    zprep_gram_panel,
    zprep_gram_plain,
    zprep_split,
)
from grid_tpu_torch.ops.knn import (
    d2_matrix,
    d2_panels,
    knn_squared,
    panel_d2,
    sorted_smallest_k,
)
from grid_tpu_torch.ops.select import dipcn_from_distances, dipcn_from_distances_panels
from torch_parity import assert_close_to_max, dipcn_sets_differ, neighbor_rows_differing

DTYPES = {"f64": (np.float64, torch.float64), "f32": (np.float32, torch.float32)}


def _z(rng, n, r, dt, ties):
    z = rng.normal(size=(n, r))
    if ties:  # multiples of 1/4: distances are exact, and many tie
        z = np.round(z * 4) / 4
        z[5] = z[2]  # duplicate rows: distance 0 to each other
    return z.astype(dt)


def _assert_lists(got_d, got_i, want_d, want_i, exact):
    got_d, got_i = got_d.numpy(), got_i.numpy()
    want_d, want_i = np.asarray(want_d), np.asarray(want_i)
    if exact:
        np.testing.assert_array_equal(got_i, want_i)
        assert_close_to_max(got_d, want_d, 1e-9)
    else:
        neighbor_rows_differing(got_i, got_d, want_i, want_d, tol=1e-5 * want_d[:, -1])


# ---------------------------------------------------------------------------
# knn_squared (tests/test_ops_knn.py:15-149, mirrored)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("col_block", [None, 16, 7, 4])
@pytest.mark.parametrize("ties", [False, True])
def test_knn_squared_matches_grid_tpu(dt, col_block, ties):
    """The port selects over whole rows; its lists are the JAX function's
    with each of its column-block settings."""
    npdt, tdt = DTYPES[dt]
    rng = np.random.default_rng(11)
    n, k = 61, 5  # 61 rows in panels of 16: the last panel has 13
    z = _z(rng, n, 12, npdt, ties)
    got_d, got_i = knn_squared(torch.from_numpy(z), k, row_block=16)
    assert got_i.dtype == torch.int32 and got_d.shape == (n, k)
    want_d, want_i = j_knn_squared(jnp.asarray(z), k, row_block=16, col_block=col_block,
                                   selector="top_k")
    _assert_lists(got_d, got_i, want_d, want_i, exact=dt == "f64" or ties)


@pytest.mark.parametrize("dt", list(DTYPES))
def test_knn_squared_padded_invalid_rows(dt):
    npdt, _ = DTYPES[dt]
    rng = np.random.default_rng(2)
    z = np.concatenate([rng.normal(size=(40, 6)), np.zeros((9, 6))]).astype(npdt)
    valid = np.arange(49) < 40
    got_d, got_i = knn_squared(torch.from_numpy(z), 7, row_valid=torch.from_numpy(valid),
                               row_block=16)
    want_d, want_i = j_knn_squared(jnp.asarray(z), 7, row_valid=jnp.asarray(valid),
                                   row_block=16, col_block=8, selector="top_k")
    assert (got_i[:40] < 40).all()  # padding is never a neighbor
    _assert_lists(got_d[:40], got_i[:40], np.asarray(want_d)[:40], np.asarray(want_i)[:40],
                  exact=dt == "f64")


def test_knn_squared_distance_343_and_self():
    z = torch.tensor([[0.0, 0.0], [3.0, 4.0], [100.0, 100.0]], dtype=torch.float64)
    d, i = knn_squared(z, 2, row_block=2)
    assert int(i[0, 0]) == 1 and float(d[0, 0]) == 25.0
    assert all(r not in i[r].tolist() for r in range(3))
    with pytest.raises(ValueError):
        knn_squared(z, 3)


@pytest.mark.parametrize("k", [1, 5, 9, 17, 40, 41])
@pytest.mark.parametrize("seed", [0, 3])
def test_sorted_smallest_k_keeps_stable_ties(seed, k):
    """The selection's plain version against a stable argsort and against
    grid_tpu's exact sorted_smallest_k, on rows with tie clusters, a
    repeated column and an all-equal row."""
    from grid_tpu.ops.select import sorted_smallest_k as j_sorted_smallest_k

    rng = np.random.default_rng(seed)
    d = rng.gamma(2.0, 1.0, (23, 41)).astype(np.float32)
    d[d < 0.6] = 0.5  # tie clusters over the whole row
    d[:, 30] = d[:, 2]
    d[4] = 7.0  # an all-equal row
    vals, idx = sorted_smallest_k(torch.from_numpy(d), k)
    want = np.argsort(d, axis=1, kind="stable")[:, :k]
    np.testing.assert_array_equal(idx.numpy(), want)
    np.testing.assert_array_equal(vals.numpy(), np.take_along_axis(d, want, axis=1))
    j_vals, j_idx = j_sorted_smallest_k(jnp.asarray(d), k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(j_vals))


# ---------------------------------------------------------------------------
# the panel distances and the plain panel Gram
# ---------------------------------------------------------------------------


def test_panels_are_the_rows_of_the_resident_matrix():
    rng = np.random.default_rng(5)
    n, r = 70, 9
    z = torch.from_numpy(rng.normal(size=(n, r)) * 3)
    mask = torch.from_numpy(rng.random((n, r)) > 0.1)
    region = torch.from_numpy(rng.random(r) > 0.2)
    valid = torch.from_numpy(rng.random(n) > 0.2)
    split = zprep_split(z, mask, region, 2.0)
    g = zprep_gram_plain(z, mask, region, 2.0)
    resident = d2_matrix(z, mask, region, 2.0, row_valid=valid)
    assert_close_to_max(split.norms, torch.diagonal(g), 1e-12)
    seen = 0
    for i0, d2 in d2_panels(split, 16, valid):
        rows = slice(i0, i0 + d2.shape[0])
        assert d2.shape == (min(16, n - i0), n)
        assert_close_to_max(zprep_gram_panel(split, i0, d2.shape[0]), g[rows], 1e-12)
        assert_close_to_max(d2, resident[rows], 1e-12)
        big = torch.finfo(d2.dtype).max
        assert (d2.diagonal(offset=i0) == big).all() and (d2[:, ~valid] == big).all()
        seen += d2.shape[0]
    assert seen == n
    with pytest.raises(ValueError):
        next(d2_panels(split, 0))


def test_panel_d2_clamps_and_masks_columns():
    g = torch.tensor([[4.0, 5.0, 0.0], [5.0, 4.0, 1.0]], dtype=torch.float64)
    norms = torch.tensor([1.0, 4.0, 4.0], dtype=torch.float64)
    d2 = panel_d2(g, norms, 1, torch.tensor([False, True, True]))
    big = torch.finfo(torch.float64).max
    # rows 1 and 2: self at columns 1 and 2, column 0 invalid, 4 + 4 - 2 * 4 = 0
    assert d2.tolist() == [[big, big, 8.0], [big, 0.0, big]]
    d2 = panel_d2(torch.tensor([[9.0, 0.0]]), torch.tensor([1.0, 1.0]), 1)
    assert d2.tolist() == [[0.0, torch.finfo(torch.float32).max]]  # clamped at 0


# ---------------------------------------------------------------------------
# dipcn_from_distances_panels
# ---------------------------------------------------------------------------


def _panel_inputs(dt, n=83, r=14, seed=7, ties=True):
    rng = np.random.default_rng(seed)
    zp = _z(rng, n, r, dt, ties)
    rnorm = rng.uniform(0.5, 2.0, n).astype(dt)
    usable = rng.random(n) > 0.25  # reads_valid: may be averaged
    row_valid = usable | (rng.random(n) > 0.4)  # in the geometry, a superset
    return zp, rnorm, usable, row_valid


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("row_block", [16, 83, 512])
def test_dipcn_panels_matches_grid_tpu(dt, row_block):
    npdt, _ = DTYPES[dt]
    zp, rnorm, usable, row_valid = _panel_inputs(npdt)
    assert (row_valid & ~usable).any()  # read-less samples that fill k-slots
    k, n_nbr = 20, 7
    got, got_ok = dipcn_from_distances_panels(
        torch.from_numpy(zp), torch.from_numpy(rnorm), torch.from_numpy(rnorm),
        torch.from_numpy(usable), torch.from_numpy(usable), k=k, n_nbr=n_nbr,
        row_block=row_block, row_valid=torch.from_numpy(row_valid))
    want, want_ok = j_dipcn_panels(
        jnp.asarray(zp), jnp.asarray(rnorm), jnp.asarray(rnorm), jnp.asarray(usable),
        jnp.asarray(usable), k=k, n_nbr=n_nbr, row_block=row_block,
        row_valid=jnp.asarray(row_valid))
    np.testing.assert_array_equal(got_ok.numpy(), np.asarray(want_ok))
    ok = np.asarray(want_ok)
    # quantized z: every distance is exact in both dtypes, so the sets agree
    np.testing.assert_allclose(got.numpy()[ok], np.asarray(want)[ok],
                               rtol=1e-9 if dt == "f64" else 1e-5)


def test_dipcn_panels_float32_random_matches_grid_tpu():
    zp, rnorm, usable, row_valid = _panel_inputs(np.float32, n=150, r=30, seed=3, ties=False)
    k, n_nbr = 25, 9
    t = {name: torch.from_numpy(a) for name, a in
         dict(zp=zp, rnorm=rnorm, usable=usable, row_valid=row_valid).items()}
    got, got_ok = dipcn_from_distances_panels(t["zp"], t["rnorm"], t["rnorm"], t["usable"],
                                              t["usable"], k=k, n_nbr=n_nbr, row_block=64,
                                              row_valid=t["row_valid"])
    want, want_ok = j_dipcn_panels(jnp.asarray(zp), jnp.asarray(rnorm), jnp.asarray(rnorm),
                                   jnp.asarray(usable), jnp.asarray(usable), k=k, n_nbr=n_nbr,
                                   row_block=64, row_valid=jnp.asarray(row_valid))
    np.testing.assert_array_equal(got_ok.numpy(), np.asarray(want_ok))
    _, got_i = knn_squared(t["zp"], k, row_valid=t["row_valid"], row_block=64)
    _, want_i = j_knn_squared(jnp.asarray(zp), k, row_valid=jnp.asarray(row_valid), row_block=64)
    same = np.asarray(want_ok) & ~dipcn_sets_differ(got_i.numpy(), np.asarray(want_i), usable,
                                                    n_nbr)
    assert same.sum() > 100
    np.testing.assert_allclose(got.numpy()[same], np.asarray(want)[same], rtol=1e-5)


def test_dipcn_panels_equal_the_resident_core():
    """Panels of any height give the resident dipCN on the same geometry,
    and collapsing row_valid into sample_valid changes the k-sets."""
    zp, rnorm, usable, row_valid = _panel_inputs(np.float64, seed=1)
    t = [torch.from_numpy(a) for a in (zp, rnorm, usable, row_valid)]
    zp_t, rnorm_t, usable_t, row_valid_t = t
    ones = torch.ones_like(zp_t, dtype=torch.bool)
    d2 = d2_matrix(zp_t, ones, ones[0], float("inf"), row_valid=row_valid_t)
    want, want_ok = dipcn_from_distances(d2, rnorm_t, rnorm_t, usable_t, usable_t, k=20, n_nbr=7)
    for row_block in (1, 10, 100):
        got, got_ok = dipcn_from_distances_panels(zp_t, rnorm_t, rnorm_t, usable_t, usable_t,
                                                  k=20, n_nbr=7, row_block=row_block,
                                                  row_valid=row_valid_t)
        assert torch.equal(got_ok, want_ok)
        assert_close_to_max(got[got_ok], want[want_ok], 1e-12)
    # with n_nbr = k every usable member of the k-set is averaged, so the
    # read-less samples' k-slots show
    want, want_ok = dipcn_from_distances(d2, rnorm_t, rnorm_t, usable_t, usable_t, k=8, n_nbr=8)
    collapsed, c_ok = dipcn_from_distances_panels(zp_t, rnorm_t, rnorm_t, usable_t, usable_t,
                                                  k=8, n_nbr=8, row_block=16)
    ok = want_ok & c_ok
    assert not torch.allclose(collapsed[ok], want[ok])


# ---------------------------------------------------------------------------
# cohort_step: the panel branch
# ---------------------------------------------------------------------------

N, R, ROW_BLOCK = 203, 96, 64  # four panels, the last of 11 rows
PANEL_BUDGET = N * N * 4 - 1  # under one float32 [N, N] matrix: the panel branch


@pytest.fixture(scope="module")
def cohort():
    values, mask, reads = make_matrix(N, R)
    reads_valid = np.ones(N, bool)
    reads_valid[::13] = False  # read-less samples: neighbors, never averaged
    ring = [[((h + 2) % (2 * N), 1.0), ((h - 2) % (2 * N), 0.5)] for h in range(2 * N)]
    return (values, mask, reads, reads_valid, *pad_hap_neighbors(ring, 2))


def _params(**kw):
    return JCohortParams(num_neighbors=30, n_nbr=12, n_iters=8, quantize=False,
                         row_block=ROW_BLOCK, **kw)


def test_budget_picks_the_branch():
    assert d2_resident(CohortParams(), 23170, 4)
    assert not d2_resident(CohortParams(), 23171, 4)
    assert not d2_resident(CohortParams(d2_budget_bytes=0), 4, 4)
    assert not d2_resident(CohortParams(d2_budget_bytes=PANEL_BUDGET), N, 4)


@pytest.mark.parametrize("dt", list(DTYPES))
def test_cohort_panel_branch_matches_grid_tpu(cohort, dt):
    npdt, tdt = DTYPES[dt]
    values, mask, reads, reads_valid, hi, hw, hv = cohort
    params = _params(d2_budget_bytes=PANEL_BUDGET)
    want = j_cohort_step(jnp.asarray(values, npdt), jnp.asarray(mask), jnp.asarray(reads, npdt),
                         jnp.asarray(reads_valid), jnp.asarray(hi), jnp.asarray(hw),
                         jnp.asarray(hv), params)
    want = jax.tree.map(np.asarray, want)
    inputs = inputs_to_torch(values, mask, reads, reads_valid, hi, hw, hv, "cpu", tdt)
    got = outputs_to_numpy(cohort_step(*inputs, params_from_reference(params._asdict())))
    assert got.nbr_idx.dtype == np.int32 and got.nbr_idx.shape == (N, 30)
    np.testing.assert_array_equal(got.region_used, want.region_used)
    assert_close_to_max(got.z, want.z, 1e-9 if dt == "f64" else 1e-6)
    _assert_lists(torch.from_numpy(got.nbr_sq_dists), torch.from_numpy(got.nbr_idx),
                  want.nbr_sq_dists, want.nbr_idx, exact=dt == "f64")
    np.testing.assert_array_equal(got.dipcn_valid, want.dipcn_valid)
    usable = reads_valid & got.z_mask.any(axis=1)
    same = got.dipcn_valid & ~dipcn_sets_differ(got.nbr_idx, want.nbr_idx, usable, 12)
    if dt == "f64":
        assert same.sum() == got.dipcn_valid.sum()
    np.testing.assert_allclose(got.dipcn[same], want.dipcn[same],
                               rtol=1e-9 if dt == "f64" else 1e-5)
    np.testing.assert_array_equal(got.phased, want.phased)


@pytest.mark.parametrize("dt", list(DTYPES))
def test_cohort_panel_branch_matches_resident_branch(cohort, dt):
    _, tdt = DTYPES[dt]
    inputs = inputs_to_torch(*cohort, "cpu", tdt)
    resident = outputs_to_numpy(cohort_step(*inputs, CohortParams(**_params()._asdict())))
    panels = outputs_to_numpy(cohort_step(
        *inputs, CohortParams(**_params(d2_budget_bytes=0)._asdict())))
    for f in ("z", "scales", "region_used"):
        np.testing.assert_array_equal(getattr(panels, f), getattr(resident, f))
    _assert_lists(torch.from_numpy(panels.nbr_sq_dists), torch.from_numpy(panels.nbr_idx),
                  resident.nbr_sq_dists, resident.nbr_idx, exact=dt == "f64")
    np.testing.assert_array_equal(panels.dipcn_valid, resident.dipcn_valid)
    usable = cohort[3] & resident.z_mask.any(axis=1)
    same = resident.dipcn_valid & ~dipcn_sets_differ(panels.nbr_idx, resident.nbr_idx, usable, 12)
    np.testing.assert_allclose(panels.dipcn[same], resident.dipcn[same],
                               rtol=1e-9 if dt == "f64" else 1e-5)


def test_panel_branch_with_padded_rows(cohort):
    """row_valid padding: the padded rows are never neighbors, as in the
    resident branch."""
    values, mask, reads, reads_valid, hi, hw, hv = cohort
    row_valid = np.arange(N) < N - 7
    inputs = inputs_to_torch(values, mask, reads, reads_valid, hi, hw, hv, "cpu", torch.float64)
    out = {}
    for name, budget in (("resident", 2 << 30), ("panels", 0)):
        params = CohortParams(**_params(d2_budget_bytes=budget)._asdict())
        out[name] = outputs_to_numpy(cohort_step(*inputs, params,
                                                 row_valid=torch.from_numpy(row_valid)))
    assert (out["panels"].nbr_idx[row_valid] < N - 7).all()
    np.testing.assert_array_equal(out["panels"].nbr_idx[row_valid],
                                  out["resident"].nbr_idx[row_valid])
    np.testing.assert_array_equal(out["panels"].dipcn_valid, out["resident"].dipcn_valid)
