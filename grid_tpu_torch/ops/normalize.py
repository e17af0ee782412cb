"""Cohort depth-matrix normalization (twin of ``grid_tpu/ops/normalize.py``).

The reference transform (``grid/utils/normalize_mosdepth.py:419-476``):

1.  row-wise: divide each sample row by its mean depth (rows whose mean is
    0 or that have no valid entries are invalidated);
2.  column-wise: mu = masked mean, s2 = masked sum of squared deviations
    divided by ``N - 1`` where **N is the total row count** (the reference's
    quirk — NOT the per-column valid count);
3.  variance ratio = 100 * s2 / mu for mu > 0;
4.  z-transform x -> (x - mu) / sqrt(mu) for mu > 0 columns;
5.  global rescale by 1 / sqrt(median_ratio / 100).

The column statistics of step 2 come from two launches of
:func:`grid_tpu_torch.ops.gpu_kernels.masked_column_stats` (a Triton kernel
on the card): counts and sums first, then the sum of squared deviations
centered on the means. Like that kernel, the port scales rows by the
reciprocal row mean where the JAX package divides by it; the two differ by
at most one rounding of x.

In bfloat16 every step rounds where ``grid_tpu``'s does (XLA rounds each
bfloat16 op once and sums in float32): x = values / row mean is a division
(a product with the reciprocal would round twice), and the divisors
``grid_tpu`` takes as weakly typed scalars (N - 1, ``ratio_mult``) are
rounded to bfloat16 first, where a Python scalar would keep them exact.
``grid_tpu`` rounds the squares of the variance sum in its op-by-op file
step 4 and sums them exactly in its jitted fused step (XLA keeps a product
that feeds a reduction in float32): ``round_squares`` picks the one to
follow.

Sharded over ranks in bfloat16 (``all_reduce``), each rank's kernel hands
its float32 sums to the all-reduce, the counts exact, and the two forms of
the sharded step reduce them as ``grid_tpu``'s two forms do
(``parallel/pstats.py``): ``round_partials`` rounds each rank's sums to
bfloat16 first, as a shard's ``jnp.sum`` in ``grid_tpu``'s ring rounds them.
The ranks' sums are added in float32 and rounded once.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from grid_tpu_torch.ops.gpu_kernels import masked_column_stats
from grid_tpu_torch.ops.masked import masked_mean, masked_median


class NormalizeResult(NamedTuple):
    """Output of :func:`normalize_cohort`.

    Attributes:
        z: [N, R] normalized + rescaled z-scores (0 where ~mask).
        mask: [N, R] validity after row invalidation.
        col_means: [R] per-region mu of the row-normalized matrix (NaN where
            no valid entries).
        col_vars: [R] per-region s2 (ddof=1 over total N).
        var_ratio: [R] 100 * s2 / mu (NaN where mu <= 0 or no data).
        row_means_raw: [N] per-sample mean RAW depth — the ``scale`` column.
        scale: 0-d global rescale factor applied to z.
    """

    z: torch.Tensor
    mask: torch.Tensor
    col_means: torch.Tensor
    col_vars: torch.Tensor
    var_ratio: torch.Tensor
    row_means_raw: torch.Tensor
    scale: torch.Tensor


def normalize_cohort(values, mask, ratio_mult: float = 100.0, n_rows=None,
                     all_reduce=None, round_squares: bool = True,
                     round_partials: bool = False) -> NormalizeResult:
    """Normalize a [N, R] masked depth matrix. See module docstring.

    Args:
        values: [N, R] raw depths (entries where ~mask are ignored).
        mask: [N, R] bool validity.
        ratio_mult: variance-ratio multiplier (reference hardcodes 100).
        n_rows: effective cohort size for the ``N - 1`` variance denominator
            (an int or a 0-d tensor). Defaults to the row count; pass the
            REAL sample count when rows are padded.
        all_reduce: where ``values`` is one rank's rows of a sharded cohort,
            the function that sums a tensor of partial column statistics
            over the ranks (:meth:`grid_tpu_torch.parallel.mesh.CohortGroup.all_reduce_sum`);
            it is called twice, on the [2, R] counts and sums and on the
            [R] squared deviations (in bfloat16 on the float32 partials,
            the totals rounded once after it). Row statistics need no
            exchange.
        round_squares: bfloat16 only: round each squared deviation before
            it is summed, as ``grid_tpu``'s file-mode step 4 does (True), or
            sum them exactly, as its jitted cohort step does (False).
        round_partials: bfloat16 with ``all_reduce`` only: round this
            rank's sums (not its counts) to bfloat16 before they are
            reduced.
    """
    n_inds = values.shape[0] if n_rows is None else n_rows
    half = values.dtype == torch.bfloat16

    def rounded(c):  # a divisor as grid_tpu takes it: in the values' dtype
        return torch.as_tensor(c, device=values.device).to(values.dtype) if half else c

    wide = half and all_reduce is not None  # float32 partials, reduced, then rounded

    def partial(t):  # a bfloat16 rank's sums as its form hands them on
        return t.to(values.dtype).float() if wide and round_partials else t

    # -- step 1: row normalization --------------------------------------
    row_means_raw = masked_mean(values, mask, axis=1)  # NaN for empty rows
    row_ok = torch.isfinite(row_means_raw) & (row_means_raw != 0)
    # Invalid rows become all-invalid (reference: row_mean 0 -> NaN row);
    # the kernel counts the mask as given, so it gets the cleared one.
    mask = mask & row_ok[:, None]
    if half:  # x = values / row mean, as grid_tpu divides
        row = torch.where(row_ok, row_means_raw, 1)
    else:
        row = torch.where(row_ok, 1 / torch.where(row_ok, row_means_raw, 1), 0)

    # -- step 2: column stats -------------------------------------------
    col_cnt, col_sum, _ = masked_column_stats(values, mask, row, wide=wide)
    if all_reduce is not None:
        totals = all_reduce(torch.stack([col_cnt, partial(col_sum)]))
        col_cnt, col_sum = totals.to(values.dtype)
    col_ok = col_cnt > 0
    col_means = torch.where(col_ok, col_sum / col_cnt.clamp_min(1), math.nan)
    safe_mu = torch.where(col_ok, col_means, 0)
    # Denominator is total N - 1 (reference parity), not valid count; an
    # all-invalid column keeps variance 0.0, as np.nansum does.
    _, _, col_sqdev = masked_column_stats(values, mask, row, safe_mu, round_squares, wide)
    if all_reduce is not None:
        col_sqdev = all_reduce(partial(col_sqdev)).to(values.dtype)
    col_vars = col_sqdev / rounded(n_inds - 1)

    # -- step 3: variance ratios ----------------------------------------
    mu_pos = col_ok & (safe_mu > 0)
    var_ratio = torch.where(
        mu_pos, ratio_mult * col_vars / torch.where(mu_pos, safe_mu, 1), math.nan
    )

    # -- step 4: z-transform (only mu > 0 columns are transformed) ------
    x = torch.where(mask, values / row[:, None] if half else values * row[:, None], 0)
    sqrt_mu = torch.sqrt(torch.where(mu_pos, safe_mu, 1))
    z = torch.where(mu_pos[None, :], (x - safe_mu[None, :]) / sqrt_mu[None, :], x)
    z = torch.where(mask, z, 0)

    # -- step 5: median rescale -----------------------------------------
    ratio_valid = ~torch.isnan(var_ratio)
    med = masked_median(var_ratio, ratio_valid)
    scale = torch.where(
        ratio_valid.any() & (med > 0),
        1.0 / torch.sqrt(med / rounded(ratio_mult)),
        torch.ones((), dtype=values.dtype, device=values.device),
    )
    return NormalizeResult(
        z=z * scale,
        mask=mask,
        col_means=col_means,
        col_vars=col_vars,
        var_ratio=var_ratio,
        row_means_raw=row_means_raw,
        scale=scale,
    )


def select_high_variance_indices(var_ratio, top_frac: float = 0.1) -> np.ndarray:
    """The file-mode step 4's form of :func:`select_high_variance_mask`:
    ascending int indices of the regions it keeps, from a host array."""
    var_ratio = np.asarray(var_ratio)
    if var_ratio.size == 0:
        return np.array([], dtype=int)
    return np.flatnonzero(select_high_variance_mask(torch.as_tensor(var_ratio), top_frac).numpy())


def select_high_variance_mask(var_ratio, top_frac: float = 0.1):
    """Boolean [R] mask of the regions kept by the reference's selection
    (quirk Q2, ``grid/utils/normalize_mosdepth.py:479-499``): the threshold
    is the value at rank ``int(top_frac * n_valid)`` of the ascending valid
    ratios, and regions STRICTLY ABOVE it are kept (~90% at top_frac=0.1).
    De-selected columns are later zeroed rather than gathered."""
    valid = ~torch.isnan(var_ratio)
    n_valid = valid.sum()
    sorted_vals = torch.sort(torch.where(valid, var_ratio, torch.inf)).values
    threshold_idx = torch.minimum(
        torch.floor(n_valid.to(torch.float64) * top_frac).long(), (n_valid - 1).clamp_min(0)
    )
    threshold = sorted_vals[threshold_idx]
    return valid & (var_ratio > threshold) & (n_valid > 0)
