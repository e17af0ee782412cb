"""grid_tpu_torch normalize ops against grid_tpu on the same numpy inputs.

Tolerances: float64 at 1e-9 (docs/parity.md); float32 at 1e-6 relative to
the largest magnitude of the compared array, since both packages round
every step in float32 and sum in different orders.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grid_tpu.ops import masked as jmasked
from grid_tpu.ops.normalize import normalize_cohort as j_normalize
from grid_tpu.ops.normalize import select_high_variance_mask as j_select
from grid_tpu.ops.pallas_kernels import masked_column_stats as j_colstats
from grid_tpu_torch.ops import masked as tmasked
from grid_tpu_torch.ops.gpu_kernels import (
    _COLSTATS_BLOCK_C,
    _COLSTATS_BLOCK_M,
    colstats_plan,
    masked_column_stats,
    masked_column_stats_plain,
)
from grid_tpu_torch.ops.normalize import normalize_cohort, select_high_variance_mask
from torch_parity import assert_close_to_max

DTYPES = [(np.float64, torch.float64, 1e-9), (np.float32, torch.float32, 1e-6)]


def _matrix(rng, n, r, dt):
    values = rng.uniform(10, 60, size=(n, r)).astype(dt)
    mask = rng.random((n, r)) > 0.15
    mask[3] = False  # an all-invalid row
    values[5] = 0.0  # a zero-mean row
    return values, mask


@pytest.mark.parametrize("dt,tdt,rtol", DTYPES)
def test_masked_reductions(dt, tdt, rtol):
    rng = np.random.default_rng(0)
    v = rng.normal(size=(9, 6)).astype(dt)
    m = rng.random((9, 6)) > 0.3
    m[:, 2] = False  # a column with nothing valid -> NaN mean
    tv, tm = torch.from_numpy(v), torch.from_numpy(m)
    for axis in (0, 1, None):
        assert_close_to_max(tmasked.masked_mean(tv, tm, axis=axis),
                            jmasked.masked_mean(jnp.asarray(v), jnp.asarray(m), axis=axis), rtol)
    mu = rng.normal(size=6).astype(dt)
    assert_close_to_max(
        tmasked.masked_var_numerator(tv, tm, torch.from_numpy(mu)),
        jmasked.masked_var_numerator(jnp.asarray(v), jnp.asarray(m), jnp.asarray(mu)), rtol)


@pytest.mark.parametrize("dt,tdt,rtol", DTYPES)
@pytest.mark.parametrize("n_valid", [0, 1, 4, 7])
def test_masked_median_averages_middle_pair(dt, tdt, rtol, n_valid):
    v = np.array([5.0, -1.0, 3.0, 9.0, 2.0, 8.0, 7.0, 4.0], dtype=dt)
    m = np.zeros(8, bool)
    m[:n_valid] = True
    got = tmasked.masked_median(torch.from_numpy(v), torch.from_numpy(m))
    want = jmasked.masked_median(jnp.asarray(v), jnp.asarray(m))
    assert_close_to_max(got, want, rtol)
    if n_valid == 4:  # even count: mean of the middle pair, not the lower one
        assert float(got) == pytest.approx(np.median(v[:4]))
        assert float(got) != float(torch.median(torch.from_numpy(v[:4])))


@pytest.mark.parametrize("dt,tdt,rtol", DTYPES)
@pytest.mark.parametrize("n_rows", [None, 40])
def test_normalize_cohort(dt, tdt, rtol, n_rows):
    rng = np.random.default_rng(1)
    values, mask = _matrix(rng, 48, 33, dt)
    want = j_normalize(jnp.asarray(values), jnp.asarray(mask), n_rows=n_rows)
    got = normalize_cohort(torch.from_numpy(values), torch.from_numpy(mask), n_rows=n_rows)
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    assert not got.mask[3].any() and not got.mask[5].any()
    # z: the port scales rows by the reciprocal mean where grid_tpu divides
    # by it — one extra rounding of x, inside the bound
    for field in ("z", "col_means", "col_vars", "var_ratio", "row_means_raw", "scale"):
        assert_close_to_max(getattr(got, field).numpy(), getattr(want, field), rtol)


@pytest.mark.parametrize("dt,tdt,rtol", DTYPES)
@pytest.mark.parametrize("top_frac", [0.0, 0.1, 0.5])
def test_select_high_variance_mask(dt, tdt, rtol, top_frac):
    rng = np.random.default_rng(2)
    ratio = rng.uniform(0, 200, size=97).astype(dt)
    ratio[rng.random(97) < 0.2] = np.nan
    ratio[10:14] = ratio[20]  # ties at the threshold
    got = select_high_variance_mask(torch.from_numpy(ratio), top_frac)
    want = j_select(jnp.asarray(ratio), top_frac)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    nothing = select_high_variance_mask(torch.full((5,), float("nan"), dtype=tdt), top_frac)
    assert not nothing.any()


def _colstats_inputs(rng):
    """The case of tests/test_pallas_kernels.py:43-69."""
    n, r = 50, 40
    values = rng.uniform(10, 60, size=(n, r)).astype(np.float32)
    mask = rng.random((n, r)) > 0.15
    rm = np.nanmean(np.where(mask, values, np.nan), axis=1)
    inv_rm = np.where(np.isfinite(rm) & (rm != 0), 1.0 / rm, 0.0).astype(np.float32)
    return values, mask, inv_rm


@pytest.mark.parametrize("centered", [False, True])
def test_masked_column_stats_plain_matches_pallas(rng, centered):
    values, mask, inv_rm = _colstats_inputs(rng)
    mu = None
    if centered:
        x = np.where(mask, values * inv_rm[:, None], 0.0)
        mu = (x.sum(0) / np.maximum(mask.sum(0), 1)).astype(np.float32)
    want = j_colstats(jnp.asarray(values), jnp.asarray(mask), jnp.asarray(inv_rm),
                      col_means=None if mu is None else jnp.asarray(mu),
                      tile_m=16, tile_c=128, interpret=True)
    got = masked_column_stats_plain(torch.from_numpy(values), torch.from_numpy(mask),
                                    torch.from_numpy(inv_rm),
                                    None if mu is None else torch.from_numpy(mu))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))  # counts: exact
    # sums run over 50 rows in float32, in tile order in Pallas and in
    # torch's order here; a centered sum of squares loses more to
    # cancellation than a sum, hence 1e-5 for sqdev
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-6)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=1e-5)


def test_masked_column_stats_cpu_tensors_take_plain_route(rng):
    values, mask, inv_rm = _colstats_inputs(rng)
    args = (torch.from_numpy(values), torch.from_numpy(mask), torch.from_numpy(inv_rm))
    before = masked_column_stats.launches
    got = masked_column_stats(*args)
    want = masked_column_stats_plain(*args)
    assert masked_column_stats.launches == before  # no kernel ran
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _emulate_colstats_chunks(values, mask, inv_rm, mu, n_sm):
    """The two Triton kernels' arithmetic in plain PyTorch: each row chunk
    of the plan accumulates [BLOCK_M, R] sums over its row steps and
    reduces them to a partial; the partials are added in chunk order."""
    n, r = values.shape
    _, chunks, rows_per_chunk = colstats_plan(n, r, n_sm)
    block_m = _COLSTATS_BLOCK_M
    x = torch.where(mask, values * inv_rm[:, None], 0)
    c = torch.where(mask, x - (0 if mu is None else mu[None, :]), 0)
    part = torch.zeros((chunks, 3, r), dtype=torch.float32)
    for s in range(chunks):
        acc = torch.zeros((3, block_m, r), dtype=torch.float32)
        for r0 in range(s * rows_per_chunk, (s + 1) * rows_per_chunk, block_m):
            step = [t[r0:r0 + block_m] for t in (mask.float(), x, c * c)]
            for a, t in zip(acc, step):
                a[:t.shape[0]] += t
        part[s] = acc.sum(dim=1)
    out = torch.zeros((3, r), dtype=torch.float32)
    for s in range(chunks):
        out += part[s]
    return chunks, out


@pytest.mark.parametrize("n,r", [(97, 70), (300, 257)])
@pytest.mark.parametrize("centered", [False, True])
def test_colstats_row_chunks_match_pallas(n, r, centered):
    """The row-split grid's partial statistics, merged in chunk order,
    against grid_tpu's kernel in interpret mode."""
    rng = np.random.default_rng(n + r)
    values = rng.uniform(10, 60, size=(n, r)).astype(np.float32)
    mask = rng.random((n, r)) > 0.15
    rm = np.nanmean(np.where(mask, values, np.nan), axis=1)
    inv_rm = np.where(np.isfinite(rm) & (rm != 0), 1.0 / rm, 0.0).astype(np.float32)
    mu = None
    if centered:
        x = np.where(mask, values * inv_rm[:, None], 0.0)
        mu = (x.sum(0) / np.maximum(mask.sum(0), 1)).astype(np.float32)
    want = j_colstats(jnp.asarray(values), jnp.asarray(mask), jnp.asarray(inv_rm),
                      col_means=None if mu is None else jnp.asarray(mu),
                      tile_m=16, tile_c=128, interpret=True)
    args = (torch.from_numpy(values), torch.from_numpy(mask), torch.from_numpy(inv_rm),
            None if mu is None else torch.from_numpy(mu))
    chunks, got = _emulate_colstats_chunks(*args, n_sm=132)
    assert chunks > 1  # the merge runs
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))  # counts: exact
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-6)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=1e-5)
    # chunk-order merges are deterministic
    assert torch.equal(got, _emulate_colstats_chunks(*args, n_sm=132)[1])


@pytest.mark.parametrize("n,r,n_sm,chunks", [(2504, 2048, 132, 10), (100, 3_000_000, 132, 1),
                                             (97, 70, 132, 7), (300, 257, 4, 3)])
def test_colstats_plan(n, r, n_sm, chunks):
    """Row chunks partition the rows in whole steps, and the main pass
    holds at least 4 programs per SM wherever the rows allow it."""
    col_tiles, s, rows_per_chunk = colstats_plan(n, r, n_sm)
    assert s == chunks
    assert rows_per_chunk % _COLSTATS_BLOCK_M == 0
    assert (s - 1) * rows_per_chunk < n <= s * rows_per_chunk
    assert (col_tiles - 1) * _COLSTATS_BLOCK_C < r <= col_tiles * _COLSTATS_BLOCK_C
    programs = col_tiles * s
    assert programs >= 4 * n_sm or rows_per_chunk == _COLSTATS_BLOCK_M


@pytest.mark.parametrize("n,r", [(6, 30), (37, 203)])
@pytest.mark.parametrize("dt,tdt,rtol", DTYPES)
def test_equal_columns_get_equal_statistics_and_selection(rng, n, r, dt, tdt, rtol):
    """Columns with equal values and masks, wherever they sit in the row,
    get bitwise equal statistics, so the selection's strict ``>`` keeps or
    drops all of them, as grid_tpu's does (a fabricated cohort without
    indels has such columns: its flank bins tie exactly)."""
    values, mask = _matrix(rng, n, r, dt)
    # the first and last ten columns equal (a cohort's two flanks), and
    # five in the middle
    groups = ([*range(10), *range(r - 10, r)], list(range(r // 2 - 3, r // 2 + 2)))
    for group in groups:
        values[:, group] = values[:, group[:1]]
        mask[:, group] = mask[:, group[:1]]
    res = normalize_cohort(torch.as_tensor(values, dtype=tdt), torch.as_tensor(mask))
    for group in groups:
        for field in ("col_means", "col_vars", "var_ratio"):
            got = getattr(res, field).numpy()[group]
            assert len(set(got.tobytes()[i:i + got.itemsize]
                           for i in range(0, got.nbytes, got.itemsize))) == 1, field
    want = j_normalize(jnp.asarray(values), jnp.asarray(mask))
    for top_frac in (0.1, 0.4):
        got = select_high_variance_mask(res.var_ratio, top_frac).numpy()
        np.testing.assert_array_equal(got, np.asarray(j_select(want.var_ratio, top_frac)))
