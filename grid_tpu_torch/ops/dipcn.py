"""Neighbor-normalized diploid copy number from neighbor lists (twin of
``grid_tpu/ops/dipcn.py``; reference ``grid/utils/compute_dipcn.py:62-87``):

    dipCN_i = (reads_i / scale_i) / mean_{j in first n_nbr usable nbrs}(reads_j / scale_j)

"Usable" keeps the reference's skip-and-continue: a neighbor whose ID has no
read count is skipped WITHOUT using one of the n_nbr slots. The ragged
prefix becomes a cumulative-sum mask over the [N, K] lists. The file-mode
step 6 builds the lists on the host from the neighbors file; the fused step
needs no lists (``ops/select.py``).
"""

from __future__ import annotations

import torch


def compute_dipcn(rnorm, sample_valid, nbr_contrib, nbr_usable, n_nbr: int):
    """dipCN of every sample at once.

    Args:
        rnorm: [N] reads_i / scale_i (junk where ~sample_valid).
        sample_valid: [N] bool — the sample has a scale and a read count.
        nbr_contrib: [N, K] reads_j / scale_j per neighbor slot, ascending
            by distance (junk where ~nbr_usable).
        nbr_usable: [N, K] bool — the slot exists AND its ID has a read count.
        n_nbr: most neighbors averaged per sample.

    Returns (dipcn [N], out_valid [N]): out_valid is sample_valid with at
    least one usable neighbor.
    """
    take = nbr_usable & (torch.cumsum(nbr_usable.to(torch.int32), dim=1) <= n_nbr)
    cnt = take.sum(dim=1)
    tot = torch.where(take, nbr_contrib, 0).sum(dim=1)
    dipcn = rnorm / (tot / cnt.clamp_min(1))
    return dipcn, sample_valid & (cnt > 0)
