"""grid_tpu_torch kNN ops against grid_tpu on the same numpy inputs.

Tolerances: float64 at 1e-9 (docs/parity.md); float32 Gram and distance
matrices at 1e-5 relative to their largest entry, because every entry is a
sum of R float32 products taken in another order (an entry's error grows
with R and with the norms, not with the entry itself).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grid_tpu.ops.knn import d2_matrix as j_d2_matrix
from grid_tpu.ops.knn import prepare_z as j_prepare_z
from grid_tpu.ops.knn import region_filter_mask as j_region_filter_mask
from grid_tpu.ops.pallas_kernels import zprep_gram as j_zprep_gram
from grid_tpu_torch.ops.gpu_kernels import zprep_gram, zprep_gram_plain
from grid_tpu_torch.ops.knn import d2_matrix, prepare_z, region_filter_mask, sorted_smallest_k
from torch_parity import assert_close_to_max, dipcn_sets_differ, neighbor_rows_differing


@pytest.mark.parametrize("dt", [np.float64, np.float32])
@pytest.mark.parametrize("frac_r,n_written", [(1.0, None), (0.9, None), (0.75, 37), (0.9, 90)])
def test_region_filter_mask(dt, frac_r, n_written):
    rng = np.random.default_rng(3)
    s = rng.uniform(0, 1500, size=120).astype(dt)
    s[rng.random(120) < 0.15] = np.nan
    s[7] = np.inf
    nw_t = None if n_written is None else torch.tensor(n_written)
    got = region_filter_mask(torch.from_numpy(s), frac_r, 1000.0, n_written=nw_t)
    want = j_region_filter_mask(jnp.asarray(s), frac_r, 1000.0, n_written=n_written)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # all non-finite: keep everything
    none = np.full(10, np.nan, dtype=dt)
    assert region_filter_mask(torch.from_numpy(none), frac_r).all()


@pytest.mark.parametrize("dt", [np.float64, np.float32])
def test_prepare_z(dt):
    rng = np.random.default_rng(4)
    z = (rng.normal(size=(30, 20)) * 3).astype(dt)
    mask = rng.random((30, 20)) > 0.1
    region = rng.random(20) > 0.2
    got = prepare_z(torch.from_numpy(z), torch.from_numpy(mask), 2.0, torch.from_numpy(region))
    want = j_prepare_z(jnp.asarray(z), jnp.asarray(mask), 2.0, jnp.asarray(region))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n,r,tile_m,tile_r", [(20, 70, 8, 128), (300, 300, 128, 128)])
def test_zprep_gram_plain_matches_pallas(rng, n, r, tile_m, tile_r):
    """Single-tile and multi-tile cases of tests/test_pallas_kernels.py:11-40."""
    z = (rng.normal(size=(n, r)) * 3).astype(np.float32)
    mask = rng.random((n, r)) > 0.1
    region = rng.random(r) > 0.2
    want = j_zprep_gram(jnp.asarray(z), jnp.asarray(mask), jnp.asarray(region), 2.0,
                        tile_m=tile_m, tile_r=tile_r, interpret=True)
    args = (torch.from_numpy(z), torch.from_numpy(mask), torch.from_numpy(region), 2.0)
    got = zprep_gram_plain(*args)
    assert got.dtype == torch.float32 and got.shape == (n, n)
    assert_close_to_max(got.numpy(), want, 1e-5)
    before = zprep_gram.launches
    assert torch.equal(zprep_gram(*args), got)  # CPU tensors: the plain route
    assert zprep_gram.launches == before


def _tf32(x):
    """Nearest TF32 value of each float32 entry, ties away from zero, as the
    kernel's split pass rounds: add half of the dropped range, then mask the
    low 13 mantissa bits."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _gram_tf32(p, products: int):
    """Emulation of csrc/zprep_gram.cu's split-precision Gram product in
    float32 matmuls: 3 products (big·small + small·big, then big·big) as the
    kernel runs them, or 1 (big·big, plain TF32)."""
    big = _tf32(p)
    if products == 1:
        return big @ big.T
    small = _tf32(p - big)
    return (big @ small.T + small @ big.T) + big @ big.T


def _d2_from_gram(g):
    """d2_matrix's epilogue, diagonal excluded."""
    sq = torch.diagonal(g)
    d2 = (sq[:, None] + sq[None, :] - 2 * g).clamp_min(0)
    return d2.fill_diagonal_(torch.finfo(d2.dtype).max)


@pytest.mark.parametrize("n,r,check_neighbors", [(97, 70, False), (300, 257, False),
                                                 (512, 512, True)])
def test_split_tf32_gram_arithmetic(n, r, check_neighbors):
    """The Gram kernel's 3xTF32 arithmetic keeps float32 accuracy: within
    1e-5 of max|G| of the Pallas kernel, and at N=R=512 the same neighbor
    lists up to ties within 1e-5 of each row's k-th distance, a rule that
    plain TF32 breaks."""
    rng = np.random.default_rng(n + r)
    z = (rng.normal(size=(n, r)) * 1.2).astype(np.float32)
    mask = rng.random((n, r)) > 0.02
    region = rng.random(r) > 0.1
    want = np.array(j_zprep_gram(jnp.asarray(z), jnp.asarray(mask), jnp.asarray(region), 2.0,
                                 interpret=True))
    p = prepare_z(torch.from_numpy(z), torch.from_numpy(mask), 2.0, torch.from_numpy(region))
    got = _gram_tf32(p, 3)
    assert_close_to_max(got.numpy(), want, 1e-5)
    if not check_neighbors:
        return
    k = 50
    want_d, want_i = sorted_smallest_k(_d2_from_gram(torch.from_numpy(want)), k)
    tol = 1e-5 * want_d[:, -1].double().numpy()
    got_d, got_i = sorted_smallest_k(_d2_from_gram(got), k)
    neighbor_rows_differing(got_i, got_d, want_i, want_d, tol)
    one_d, one_i = sorted_smallest_k(_d2_from_gram(_gram_tf32(p, 1)), k)
    with pytest.raises(AssertionError, match="differ"):
        neighbor_rows_differing(one_i, one_d, want_i, want_d, tol)


@pytest.mark.parametrize("dt,rtol", [(np.float64, 1e-9), (np.float32, 1e-5)])
def test_d2_matrix(dt, rtol):
    rng = np.random.default_rng(5)
    n, r = 64, 40
    z = (rng.normal(size=(n, r)) * 2).astype(dt)
    mask = rng.random((n, r)) > 0.1
    region = rng.random(r) > 0.2
    valid = rng.random(n) > 0.1
    want = np.asarray(j_d2_matrix(j_prepare_z(jnp.asarray(z), jnp.asarray(mask), 2.0,
                                              jnp.asarray(region)),
                                  row_valid=jnp.asarray(valid)))
    got = d2_matrix(torch.from_numpy(z), torch.from_numpy(mask), torch.from_numpy(region), 2.0,
                    row_valid=torch.from_numpy(valid)).numpy()
    big = np.finfo(dt).max
    np.testing.assert_array_equal(got == big, want == big)  # diagonal + invalid columns
    assert (np.diag(got) == big).all() and (got[:, ~valid] == big).all()
    fin = want != big
    assert_close_to_max(got[fin], want[fin], rtol)
    assert (got >= 0).all()


def test_neighbor_parity_rule():
    """Lists may differ only by ties within tol; dipCN input sets are the
    k-set and its first n_nbr usable members."""
    want_i = np.array([[1, 2, 3], [4, 5, 6]])
    want_d = np.array([[1.0, 2.0, 2.0], [1.0, 2.0, 3.0]])
    swapped = np.array([[1, 3, 2], [4, 5, 6]])  # exact tie: allowed at tol 0
    assert neighbor_rows_differing(swapped, want_d, want_i, want_d, 0.0).tolist() == [0]
    with pytest.raises(AssertionError):  # 1.0 vs 2.0 is no tie
        neighbor_rows_differing(np.array([[2, 1, 3], [4, 5, 6]]), want_d, want_i, want_d, 0.5)
    outside = np.array([[1, 2, 3], [4, 5, 7]])  # 7 in, 6 out: ties with the k-th only
    near = np.array([[1.0, 2.0, 2.0], [1.0, 2.0, 3.05]])
    assert neighbor_rows_differing(outside, near, want_i, want_d, 0.1).tolist() == [1]
    with pytest.raises(AssertionError):
        neighbor_rows_differing(outside, near, want_i, want_d, 0.01)
    # a tolerance per row: the tie in row 1 passes its own bound only
    assert neighbor_rows_differing(outside, near, want_i, want_d,
                                   np.array([0.0, 0.1])).tolist() == [1]
    with pytest.raises(AssertionError, match="row 1"):
        neighbor_rows_differing(outside, near, want_i, want_d, np.array([0.1, 0.01]))

    usable = np.ones(8, bool)
    usable[2] = False
    # row 0: same sets in another order; row 1: another k-set
    sets = dipcn_sets_differ(np.array([[3, 1, 2], [4, 5, 7]]), want_i, usable, n_nbr=2)
    assert sets.tolist() == [False, True]
    # column 2 is not usable, so the first 2 usable members are {3, 1} either way
    assert not dipcn_sets_differ(np.array([[3, 2, 1]]), want_i[:1], usable, n_nbr=2)[0]
    # same k-set, but the first usable member is 0 on one side and 1 on the other
    assert dipcn_sets_differ(np.array([[0, 1, 3]]), np.array([[1, 0, 3]]), usable, n_nbr=1)[0]


@pytest.mark.parametrize("dt", [np.float64, np.float32])
@pytest.mark.parametrize("k", [1, 2, 7, 40])
def test_sorted_smallest_k_matches_approx_max_k_on_ties(dt, k):
    rng = np.random.default_rng(6)
    # values on a coarse grid: many exact ties, which must go to the lower column
    d2 = (rng.integers(0, 6, size=(33, 41)) / 4).astype(dt)
    d2[:, 5] = np.finfo(dt).max
    vals, idx = sorted_smallest_k(torch.from_numpy(d2), k)
    assert idx.dtype == torch.int32
    stable = np.argsort(d2, axis=1, kind="stable")[:, :k]
    np.testing.assert_array_equal(idx.numpy(), stable)
    np.testing.assert_array_equal(vals.numpy(), np.take_along_axis(d2, stable, axis=1))
    # On the CPU, approx_max_k keeps the stable tie order only for float32
    # (the device dtype) and k >= 2: it lowers k=1 to an argmax that keeps
    # the LAST tie, and its float64 sort does not keep ties in column order.
    # Those cases are held to lax.top_k, which keeps the stable order.
    neg, want_idx = jax.lax.approx_max_k(-jnp.asarray(d2), k, recall_target=1.0)
    np.testing.assert_array_equal(vals.numpy(), -np.asarray(neg))
    if k == 1 or dt == np.float64:
        want_idx = jax.lax.top_k(-jnp.asarray(d2), k)[1]
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
