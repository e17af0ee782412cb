"""Rank functions for the sharded layer's tests (``tests/test_torch_parallel.py``,
``tests/test_torch_fused.py``).

``run_ranks`` spawns its ranks, which import the function they run by its
module's name: these live here, in a module that imports no JAX, so a
rank starts in about a second. Each writes what it computed into the
shared tensors it is handed; the test holds them to ``grid_tpu``'s.
"""

from __future__ import annotations

import grid_tpu_torch.parallel.pknn as pknn
import torch
from grid_tpu_torch.ops.normalize import select_high_variance_mask
from grid_tpu_torch.parallel.mesh import shard_cohort_inputs
from grid_tpu_torch.parallel.pcohort import _rank_step
from grid_tpu_torch.parallel.pstats import normalize_cohort_sharded

NORMALIZE_ROW_FIELDS = ("z", "mask", "row_means_raw")
NORMALIZE_COL_FIELDS = ("col_means", "col_vars", "var_ratio", "scale", "selected")


def rank_step_failing_on_rank_1(group, *args):
    """The sharded step's rank function, but rank 1 raises at once."""
    if group.rank == 1:
        raise ValueError("rank 1 fails on purpose")
    return _rank_step(group, *args)


def normalize_rank(group, cases):
    """Each case: (values, mask, outputs) handles; the rank writes its rows
    of z, mask and the raw row means, and rank 0 the column statistics, the
    scale and the high-variance selection."""
    for values_h, mask_h, outs in cases:
        values, mask = values_h.open(), mask_h.open()
        n = values.shape[0]
        v, m, _, _, row_valid, row0 = shard_cohort_inputs(
            group, values, mask, torch.zeros(n), torch.zeros(n, dtype=torch.bool))
        res = normalize_cohort_sharded(v, m & row_valid[:, None], group, n_rows=n)
        b = v.shape[0]
        for name in NORMALIZE_ROW_FIELDS:
            outs[name].open()[row0:row0 + b] = getattr(res, name)
        if group.rank == 0:
            got = res._asdict() | {"selected": select_high_variance_mask(res.var_ratio)}
            for name in NORMALIZE_COL_FIELDS:
                outs[name].open().copy_(got[name])


def knn_rank(group, cases):
    """Each case: (z, row_valid, w, usable, k, outputs) handles; the rank
    writes its rows of the ring's distances, indices and carried payloads,
    and the widest input of any merge it made (k + the visiting block's
    rows) into ``widest[rank]``."""
    real, merge_rows = pknn.merge_candidates, pknn.MERGE_ROWS
    for z_h, valid_h, w_h, u_h, k, outs in cases:
        widths = []

        def recording(best_d, best_i, best_p, d2, *rest):
            widths.append(best_d.shape[1] + d2.shape[1])
            return real(best_d, best_i, best_p, d2, *rest)

        z, valid, w, usable = (h.open() for h in (z_h, valid_h, w_h, u_h))
        zb, valid_b, w_b, u_b, _, row0 = shard_cohort_inputs(group, z, valid, w, usable)
        # two rows a merge panel, so every block merges in several panels
        pknn.merge_candidates, pknn.MERGE_ROWS = recording, 2
        try:
            found = pknn.ring_knn(zb, k, group, row_valid=valid_b, payloads=(w_b, u_b))
        finally:
            pknn.merge_candidates, pknn.MERGE_ROWS = real, merge_rows
        b = zb.shape[0]
        for name, t in zip(("d", "idx", "w", "usable"), found):
            outs[name].open()[row0:row0 + b] = t
        outs["widest"].open()[group.rank] = max(widths)


def both_rank(group, norm_cases, knn_cases):
    """:func:`normalize_rank`, then :func:`knn_rank`, in one spawn."""
    normalize_rank(group, norm_cases)
    knn_rank(group, knn_cases)
