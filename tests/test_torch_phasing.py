"""grid_tpu_torch phasing against grid_tpu on the same numpy inputs.

Tolerances: float64 at 1e-9 (docs/parity.md); float32 at 1e-6 relative —
the sweeps repeat the same float32 arithmetic, and the row sums of K
neighbors may round in another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grid_tpu.ops.phasing import compute_imputed as j_imputed
from grid_tpu.ops.phasing import phase_haplotypes as j_phase
from grid_tpu_torch.io.hap_neighbors import pad_hap_neighbors
from grid_tpu_torch.ops.phasing import compute_imputed, phase_haplotypes


def _inputs(dt, n=64, max_nbr=4, seed=7):
    rng = np.random.default_rng(seed)
    irrs = rng.uniform(1.0, 6.0, n).astype(dt)
    irrs[[3, 17]] = np.nan  # samples without a dipCN
    hap_nbrs = []
    for h in range(2 * n):
        deg = int(rng.integers(0, max_nbr + 1)) if h % 11 else 0  # some empty lists
        hap_nbrs.append([(int(rng.integers(0, 2 * n)), float(rng.uniform(0.1, 1.0)))
                         for _ in range(deg)])
    return irrs, pad_hap_neighbors(hap_nbrs, max_nbr)


@pytest.mark.parametrize("dt,rtol", [(np.float64, 1e-9), (np.float32, 1e-6)])
@pytest.mark.parametrize("min_nbr,n_iters", [(1, 0), (1, 10), (2, 25)])
def test_phase_and_impute(dt, rtol, min_nbr, n_iters):
    irrs, (hi, hw, hv) = _inputs(dt)
    want = j_phase(jnp.asarray(irrs), jnp.asarray(hi), jnp.asarray(hw), jnp.asarray(hv),
                   min_nbr, n_iters)
    t = [torch.from_numpy(a) for a in (irrs, hi, hw, hv)]
    got = phase_haplotypes(*t, min_nbr, n_iters)
    np.testing.assert_array_equal(got.phased.numpy(), np.asarray(want.phased))
    np.testing.assert_allclose(got.hap_irrs.numpy(), np.asarray(want.hap_irrs), rtol=rtol)
    np.testing.assert_allclose(float(got.mean_irrs), float(want.mean_irrs), rtol=rtol)
    assert got.hap_irrs.dtype == t[0].dtype

    imp = compute_imputed(got.hap_irrs, t[1], t[2], t[3], got.mean_irrs)
    want_imp = j_imputed(want.hap_irrs, jnp.asarray(hi), jnp.asarray(hw), jnp.asarray(hv),
                         want.mean_irrs)
    np.testing.assert_allclose(imp.numpy(), np.asarray(want_imp), rtol=rtol)


def test_nobody_phased_gives_zero_mean():
    irrs, (hi, hw, hv) = _inputs(np.float64)
    hv[:] = False
    got = phase_haplotypes(*[torch.from_numpy(a) for a in (irrs, hi, hw, hv)], 1, 5)
    assert not got.phased.any() and float(got.mean_irrs) == 0.0
    assert torch.isnan(got.hap_irrs).all()


def test_pad_hap_neighbors_copy_matches_grid_tpu():
    from grid_tpu.io.hap_neighbors import pad_hap_neighbors as j_pad

    nbrs = [[(1, 0.5), (3, 0.25)], [], [(0, 1.0)], [(2, 0.1), (0, 0.2), (1, 0.3)]]
    for max_nbr in (1, 2, 5):
        for got, want in zip(pad_hap_neighbors(nbrs, max_nbr), j_pad(nbrs, max_nbr)):
            np.testing.assert_array_equal(got, want)
            assert got.dtype == want.dtype
