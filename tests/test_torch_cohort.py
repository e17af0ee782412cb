"""The whole fused cohort step of grid_tpu_torch against
grid_tpu.models.cohort.cohort_step on bench.make_matrix(256, 256).

Tolerances (docs/parity.md):
- float64: every output within 1e-9 (relative to the array's largest
  magnitude), neighbor lists identical.
- float32: normalize outputs within 1e-6 relative. With quantize=True a z
  value whose unrounded value lies within float32 noise of a %.2f rounding
  boundary may round the other way, so z may differ there by one 0.01
  step ("rounding-boundary flips only"). Distances then move with it, so
  each later stage is held to grid_tpu's own function on the port's input
  to that stage: neighbor distances within 1e-5 of the largest (a sum of R
  float32 products in another order), lists equal except ties within that
  bound, dipCN within 1e-6 on rows whose dipCN input sets (the k-set and
  its first n_nbr usable members) are equal, phasing within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bench import make_matrix
from grid_tpu.models.cohort import CohortParams as JCohortParams
from grid_tpu.models.cohort import cohort_step as j_cohort_step
from grid_tpu.ops.knn import d2_matrix as j_d2_matrix
from grid_tpu.ops.knn import prepare_z as j_prepare_z
from grid_tpu.ops.phasing import compute_imputed as j_imputed
from grid_tpu.ops.phasing import phase_haplotypes as j_phase
from grid_tpu.ops.select import dipcn_from_distances as j_dipcn
from grid_tpu_torch.convert import inputs_to_torch, outputs_to_numpy, params_from_reference
from grid_tpu_torch.io.hap_neighbors import pad_hap_neighbors
from grid_tpu_torch.models.cohort import CohortParams, cohort_step, make_cohort_step
from torch_parity import assert_close_to_max, dipcn_sets_differ, neighbor_rows_differing

N, R = 256, 256
NORMALIZE_FIELDS = ("col_means", "col_vars", "var_ratio", "scales")
EXACT_FIELDS = ("z_mask", "region_selected", "region_used", "r_use")


@pytest.fixture(scope="module")
def cohort():
    values, mask, reads = make_matrix(N, R)
    reads_valid = np.ones(N, bool)
    reads_valid[::17] = False
    ring = [[((h + 2) % (2 * N), 1.0), ((h - 2) % (2 * N), 0.5)] for h in range(2 * N)]
    hi, hw, hv = pad_hap_neighbors(ring, 2)
    return values, mask, reads, reads_valid, hi, hw, hv


def _run_both(cohort, dt, tdt, params):
    values, mask, reads, reads_valid, hi, hw, hv = cohort
    want = j_cohort_step(jnp.asarray(values, dt), jnp.asarray(mask), jnp.asarray(reads, dt),
                         jnp.asarray(reads_valid), jnp.asarray(hi), jnp.asarray(hw),
                         jnp.asarray(hv), params)
    inputs = inputs_to_torch(values, mask, reads, reads_valid, hi, hw, hv, "cpu", tdt)
    got = cohort_step(*inputs, params_from_reference(params._asdict()))
    return outputs_to_numpy(got), jax.tree.map(np.asarray, want)


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("dt,tdt,rtol", [(np.float64, torch.float64, 1e-9),
                                         (np.float32, torch.float32, 1e-6)])
def test_cohort_step_matches_grid_tpu(cohort, dt, tdt, rtol, quantize):
    values, mask, reads, reads_valid, hi, hw, hv = cohort
    params = JCohortParams(num_neighbors=50, n_nbr=30, n_iters=10, quantize=quantize)
    got, want = _run_both(cohort, dt, tdt, params)
    for f in got._fields:
        assert getattr(got, f).dtype == getattr(want, f).dtype or f in ("r_use", "nbr_idx"), f

    # ---- normalize + selection, against the JAX step itself ------------
    for f in EXACT_FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    for f in NORMALIZE_FIELDS:
        assert_close_to_max(getattr(got, f), getattr(want, f), rtol)
    dz = np.abs(got.z.astype(np.float64) - want.z)
    z_tol = rtol * np.max(np.abs(want.z))
    flips = dz > z_tol
    if quantize and dt == np.float32:
        assert dz.max() <= 0.01 + z_tol  # at most one %.2f step
        assert flips.mean() < 1e-3  # and only at rounding boundaries: rare
    else:
        assert not flips.any()

    # ---- kNN, dipCN, phasing: grid_tpu's functions on the port's z -----
    sample_ok = got.z_mask.any(axis=1)
    d2 = j_d2_matrix(j_prepare_z(jnp.asarray(got.z), jnp.asarray(got.z_mask), params.zmax,
                                 region_mask=jnp.asarray(got.region_used)),
                     row_valid=jnp.asarray(sample_ok))
    neg, ref_idx = jax.lax.approx_max_k(-d2, params.num_neighbors, recall_target=1.0)
    ref_d = -np.asarray(neg)
    tie_rtol = 1e-9 if dt == np.float64 else 1e-5  # of each row's k-th distance
    differ = neighbor_rows_differing(got.nbr_idx, got.nbr_sq_dists, np.asarray(ref_idx), ref_d,
                                     tol=tie_rtol * ref_d[:, -1])
    if dt == np.float64:
        assert differ.size == 0

    rv = jnp.asarray(reads_valid & sample_ok)
    w = jnp.asarray(reads, dt) / jnp.asarray(got.scales)
    ref_dip, ref_ok = j_dipcn(d2, w, w, rv, rv, k=params.num_neighbors, n_nbr=params.n_nbr)
    np.testing.assert_array_equal(got.dipcn_valid, np.asarray(ref_ok))
    usable = reads_valid & sample_ok
    same = np.asarray(ref_ok) & ~dipcn_sets_differ(got.nbr_idx, np.asarray(ref_idx), usable,
                                                   params.n_nbr)
    np.testing.assert_allclose(got.dipcn[same], np.asarray(ref_dip)[same], rtol=rtol)

    irrs = jnp.asarray(np.where(got.dipcn_valid, got.dipcn, np.nan))
    ph = j_phase(irrs, jnp.asarray(hi), jnp.asarray(hw), jnp.asarray(hv), params.min_nbr,
                 params.n_iters)
    np.testing.assert_array_equal(got.phased, np.asarray(ph.phased))
    np.testing.assert_allclose(got.hap_irrs, np.asarray(ph.hap_irrs), rtol=rtol)
    np.testing.assert_allclose(got.mean_irrs, np.asarray(ph.mean_irrs), rtol=rtol)
    imp = j_imputed(ph.hap_irrs, jnp.asarray(hi), jnp.asarray(hw), jnp.asarray(hv), ph.mean_irrs)
    np.testing.assert_allclose(got.hap_imp, np.asarray(imp), rtol=rtol)

    # ---- float64: the whole slice equals the JAX step ------------------
    if dt == np.float64:
        np.testing.assert_array_equal(got.nbr_idx, want.nbr_idx)
        for f in ("z", "nbr_sq_dists", "dipcn", "hap_irrs", "hap_imp", "mean_irrs"):
            assert_close_to_max(getattr(got, f), getattr(want, f), rtol)
        np.testing.assert_array_equal(got.dipcn_valid, want.dipcn_valid)


def test_row_valid_padding_matches_grid_tpu(cohort):
    """Padded rows (row_valid=False) leave the statistics of the others
    alone, as in grid_tpu."""
    values, mask, reads, reads_valid, hi, hw, hv = cohort
    row_valid = np.ones(N, bool)
    row_valid[-6:] = False
    params = JCohortParams(num_neighbors=20, n_nbr=10, n_iters=3, quantize=False)
    want = j_cohort_step(jnp.asarray(values), jnp.asarray(mask), jnp.asarray(reads),
                         jnp.asarray(reads_valid), jnp.asarray(hi), jnp.asarray(hw),
                         jnp.asarray(hv), params, row_valid=jnp.asarray(row_valid))
    inputs = inputs_to_torch(values, mask, reads, reads_valid, hi, hw, hv, "cpu", torch.float64)
    got = outputs_to_numpy(cohort_step(*inputs, params_from_reference(params._asdict()),
                                       row_valid=torch.from_numpy(row_valid)))
    np.testing.assert_array_equal(got.nbr_idx, np.asarray(want.nbr_idx))
    np.testing.assert_array_equal(got.dipcn_valid, np.asarray(want.dipcn_valid))
    for f in ("z", "col_vars", "dipcn", "hap_irrs"):
        assert_close_to_max(getattr(got, f), np.asarray(getattr(want, f)), 1e-9)


def test_make_cohort_step_binds_params(cohort):
    values, mask, reads, reads_valid, hi, hw, hv = cohort
    params = CohortParams(num_neighbors=10, n_nbr=5, n_iters=2)
    inputs = inputs_to_torch(values, mask, reads, reads_valid, hi, hw, hv, "cpu", torch.float64)
    a = make_cohort_step(params)(*inputs)
    b = cohort_step(*inputs, params)
    for x, y in zip(a, b):
        assert torch.equal(x.nan_to_num(), y.nan_to_num())


def test_params_match_grid_tpu_defaults():
    assert CohortParams._fields == JCohortParams._fields
    assert CohortParams() == params_from_reference(JCohortParams()._asdict())
    with pytest.raises(TypeError):
        params_from_reference({**JCohortParams()._asdict(), "bogus": 1})


@pytest.mark.parametrize("change,exc", [
    (dict(num_neighbors=N), ValueError),
    (dict(num_neighbors=N, d2_budget_bytes=0), ValueError),
])
def test_unported_branches_raise(cohort, change, exc):
    """k > N - 1 raises on both branches (every branch of grid_tpu's step is
    ported now; ``dipcn_lists`` is held to it in test_torch_filemode.py)."""
    values, mask, reads, reads_valid, hi, hw, hv = cohort
    inputs = inputs_to_torch(values, mask, reads, reads_valid, hi, hw, hv, "cpu", torch.float64)
    with pytest.raises(exc):
        cohort_step(*inputs, CohortParams(**change))


def test_use_pallas_is_accepted_and_has_no_effect(cohort):
    """``use_pallas`` names the JAX package's Pallas branch; the port's hand
    kernels are always its path, so the field is accepted and changes
    nothing (as ``device.use_pallas`` in the pipeline)."""
    values, mask, reads, reads_valid, hi, hw, hv = cohort
    inputs = inputs_to_torch(values, mask, reads, reads_valid, hi, hw, hv, "cpu", torch.float64)
    for branch in ({}, {"d2_budget_bytes": 0}):
        params = CohortParams(num_neighbors=10, n_nbr=5, n_iters=2, **branch)
        want = cohort_step(*inputs, params)
        got = cohort_step(*inputs, params._replace(use_pallas=True))
        for f, x, y in zip(want._fields, got, want):
            assert torch.equal(x.nan_to_num(), y.nan_to_num()), f


@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32], ids=["uint8", "float"])
def test_masks_of_other_dtypes_are_coerced_to_bool(cohort, dtype):
    """``mask``, ``reads_valid`` and ``row_valid`` are taken as bool whatever
    their dtype, as grid_tpu's cohort_step does: the outputs equal the bool
    call's."""
    values, mask, reads, reads_valid, hi, hw, hv = cohort
    row_valid = np.ones(N, bool)
    row_valid[-3:] = False
    params = CohortParams(num_neighbors=10, n_nbr=5, n_iters=2, quantize=False)
    inputs = inputs_to_torch(values, mask, reads, reads_valid, hi, hw, hv, "cpu", torch.float64)
    want = cohort_step(*inputs, params, row_valid=torch.from_numpy(row_valid))
    other = list(inputs)
    # a float mask holds values other than 1 where it is valid
    scale = 0.5 if dtype.is_floating_point else 3
    other[1] = inputs[1].to(dtype) * scale
    other[3] = inputs[3].to(dtype) * scale
    got = cohort_step(*other, params, row_valid=torch.from_numpy(row_valid).to(dtype) * scale)
    for f, x, y in zip(want._fields, got, want):
        assert x.dtype == y.dtype and torch.equal(x.nan_to_num(), y.nan_to_num()), f
