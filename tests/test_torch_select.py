"""grid_tpu_torch threshold dipCN against grid_tpu's XLA formulation and its
Pallas kernel (interpret mode) on forced-tie inputs.

Tolerances: ``ok`` exact. dipCN float64 at 1e-9 (docs/parity.md); float32
at 1e-6 relative — the take-set is the same, only the order of the masked
row sum differs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grid_tpu.ops.knn import d2_matrix as j_d2_matrix
from grid_tpu.ops.pallas_select import dipcn_from_distances_pallas as j_dipcn_pallas
from grid_tpu.ops.select import dipcn_from_distances as j_dipcn
from grid_tpu.ops.select import smallest_k_mask as j_smallest_k_mask
from grid_tpu_torch.ops.gpu_select import dipcn_from_distances_gpu
from grid_tpu_torch.ops.select import dipcn_from_distances, smallest_k_mask


def _tie_inputs(dt, seed=1, n=97, r=16):
    """The forced-tie case of tests/test_pallas_kernels.py:86-91: z rounded
    to 1/4, so many distances tie exactly."""
    rng = np.random.default_rng(seed)
    zp = (np.round(rng.normal(size=(n, r)) * 4) / 4).astype(dt)
    rnorm = rng.uniform(0.5, 2.0, n).astype(dt)
    usable = rng.random(n) > 0.2
    valid = rng.random(n) > 0.1
    d2 = np.array(j_d2_matrix(jnp.asarray(zp), row_valid=jnp.asarray(valid)))  # writable copy
    return d2, rnorm, usable, valid


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("dt", [np.float64, np.float32])
@pytest.mark.parametrize("k", [1, 20, 96])
def test_smallest_k_mask(dt, k):
    d2, _, _, _ = _tie_inputs(dt)
    got = smallest_k_mask(torch.from_numpy(d2), k).numpy()
    np.testing.assert_array_equal(got, np.asarray(j_smallest_k_mask(jnp.asarray(d2), k)))
    assert (got.sum(axis=1) == k).all()
    # per-row k, including rows that take nothing
    k_rows = np.arange(d2.shape[0]) % 5
    got = smallest_k_mask(torch.from_numpy(d2), torch.from_numpy(k_rows)).numpy()
    want = np.asarray(j_smallest_k_mask(jnp.asarray(d2), jnp.asarray(k_rows, jnp.int32)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dt,rtol", [(np.float64, 1e-9), (np.float32, 1e-6)])
@pytest.mark.parametrize("k,n_nbr", [(20, 7), (60, 50), (96, 300)])
def test_dipcn_matches_xla_formulation(dt, rtol, k, n_nbr):
    d2, rnorm, usable, valid = _tie_inputs(dt)
    want, wok = j_dipcn(jnp.asarray(d2), jnp.asarray(rnorm), jnp.asarray(rnorm),
                        jnp.asarray(usable), jnp.asarray(usable), k=k, n_nbr=n_nbr)
    got, gok = dipcn_from_distances(*_torch(d2, rnorm, rnorm, usable, usable), k=k, n_nbr=n_nbr)
    wok = np.asarray(wok)
    np.testing.assert_array_equal(gok.numpy(), wok)
    np.testing.assert_allclose(got.numpy()[wok], np.asarray(want)[wok], rtol=rtol)


@pytest.mark.parametrize("row_block", [32, 97, 128])
def test_dipcn_matches_pallas_kernel(row_block):
    d2, rnorm, usable, valid = _tie_inputs(np.float32)
    want, wok = j_dipcn_pallas(jnp.asarray(d2), jnp.asarray(rnorm), jnp.asarray(rnorm),
                               jnp.asarray(usable), jnp.asarray(usable), k=20, n_nbr=7,
                               row_block=row_block, interpret=True)
    args = _torch(d2, rnorm, rnorm, usable, usable)
    before = dipcn_from_distances_gpu.launches
    got, gok = dipcn_from_distances_gpu(*args, k=20, n_nbr=7)
    assert dipcn_from_distances_gpu.launches == before  # CPU tensors: the plain route
    wok = np.asarray(wok)
    np.testing.assert_array_equal(gok.numpy(), wok)
    np.testing.assert_allclose(got.numpy()[wok], np.asarray(want)[wok], rtol=1e-6)


def test_dipcn_no_usable_neighbor_is_not_ok():
    d2, rnorm, usable, valid = _tie_inputs(np.float64)
    usable[:] = False
    _, ok = dipcn_from_distances(*_torch(d2, rnorm, rnorm, usable, valid), k=20, n_nbr=7)
    assert not ok.any()
