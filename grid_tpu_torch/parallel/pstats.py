"""Cohort statistics over a sharded depth matrix (twin of
``grid_tpu/parallel/pstats.py``).

Each rank normalizes its own block of rows with the flat step's code
(:func:`grid_tpu_torch.ops.normalize.normalize_cohort`): row statistics need
no exchange, since a row lies whole on one rank. The column statistics come
from the same two calls of the hand ``masked_column_stats`` kernel, on the
rank's rows only, each followed by one all-reduce over the ranks: the
[2, R] counts and sums, then the [R] squared deviations about the cohort's
means. The variance ratios, their median and the rescale are then computed
on every rank from the replicated [R] statistics: R is small next to N * R,
so this costs nothing and needs no gather.
"""

from __future__ import annotations

from grid_tpu_torch.ops.normalize import NormalizeResult, normalize_cohort
from grid_tpu_torch.parallel.mesh import CohortGroup


def normalize_cohort_sharded(values, mask, group: CohortGroup, n_rows=None,
                             ratio_mult: float = 100.0) -> NormalizeResult:
    """Normalize this rank's rows of a sharded [N, R] matrix.

    Args:
        values, mask: [B, R] this rank's block, padding rows masked out.
        group: the ranks.
        n_rows: the cohort's real (unpadded) row count, for the N - 1
            denominator; defaults to W * B.

    Returns a NormalizeResult whose z, mask and row means are the block's
    rows and whose column statistics, ratios and scale are the cohort's,
    bitwise equal on every rank.
    """
    if n_rows is None:
        n_rows = values.shape[0] * group.world
    return normalize_cohort(values, mask, ratio_mult, n_rows=n_rows,
                            all_reduce=group.all_reduce_sum)
