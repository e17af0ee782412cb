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

In bfloat16 the two forms of the sharded step reduce as ``grid_tpu``'s two
forms do. Both take each rank's sums from the kernel in float32, its counts
exact, and add the ranks' partials in float32 and round once (XLA's
``psum`` of bfloat16). The ring (``ring=True``, ``grid_tpu``'s ``shard_map``
step) rounds each rank's sums to bfloat16 before the reduction, as a
shard's ``jnp.sum`` rounds them there. The gather form (``ring=False``,
``grid_tpu``'s GSPMD step, its flat step bit for bit) adds the float32
partials unrounded, as one sum over all N rows: that is the flat step's sum
but for its order, so a column may land one bfloat16 ulp off it. Both sum
the exact squares of the deviations, as ``grid_tpu``'s jitted step does.
float32 and float64 take one reduction: the partials added in rank order.
"""

from __future__ import annotations

from grid_tpu_torch.ops.normalize import NormalizeResult, normalize_cohort
from grid_tpu_torch.parallel.mesh import CohortGroup


def normalize_cohort_sharded(values, mask, group: CohortGroup, n_rows=None,
                             ratio_mult: float = 100.0, ring: bool = True) -> NormalizeResult:
    """Normalize this rank's rows of a sharded [N, R] matrix.

    Args:
        values, mask: [B, R] this rank's block, padding rows masked out.
        group: the ranks.
        n_rows: the cohort's real (unpadded) row count, for the N - 1
            denominator; defaults to W * B.
        ring: bfloat16 only: reduce as the ring does (each rank's sums
            rounded first), else as the gather form does (module
            docstring).

    Returns a NormalizeResult whose z, mask and row means are the block's
    rows and whose column statistics, ratios and scale are the cohort's,
    bitwise equal on every rank.
    """
    if n_rows is None:
        n_rows = values.shape[0] * group.world
    return normalize_cohort(values, mask, ratio_mult, n_rows=n_rows,
                            all_reduce=group.all_reduce_sum, round_squares=False,
                            round_partials=ring)
