"""Distributed k-nearest neighbors: a ring of row blocks (twin of
``grid_tpu/parallel/pknn.py``).

The rows are sharded over the ranks and the N x N distance matrix never
exists: each rank keeps its own block of B rows and a visiting block goes
round the ring. At step s a rank holds the block of rank (rank - s) % W, its
own first; it computes the [B, B] distances of its rows to the visiting
rows, folds them into its running k best, and passes the block on to rank
rank + 1. After W steps every row has met every row once.

What a step does on the card:

- the Gram block G = P_a P_b^T by the Gram kernel's cross mode
  (:func:`grid_tpu_torch.ops.gpu_kernels.zprep_gram_cross`), from the split
  that :func:`~grid_tpu_torch.ops.gpu_kernels.zprep_split` made once of
  each rank's rows (float32: P's TF32 halves; float64: P itself, the FP64
  kernel's cross mode; bfloat16: P itself and the norms as ``grid_tpu``'s
  jitted ring sums them, ``sum(z * z)`` with exact squares, the bf16
  kernel's cross mode). Its entries are bitwise those of the flat panel
  branch for the same two rows, so the ring's distances are the flat
  step's, entry for entry, for the same prepared z;
- the epilogue of the flat branch (:func:`grid_tpu_torch.ops.knn.block_d2`):
  d2 = max(|a|^2 + |b|^2 - 2G, 0), self and invalid columns at finfo.max;
- the merge: the k smallest of [best | d2] per row (the ``knn_select``
  kernel on the card, a stable sort on the CPU: the same positions), and
  the payloads follow the same positions. Equal distances keep the lower
  position, ``lax.top_k``'s rule, and the blocks are visited in the JAX
  ring's order, so exact ties break as they do there (the visited block
  first, not the lower row).

The visiting block carries its split and squared norms (on the card
2 * B * R_pad float32 and B float32, B * R_pad float64 and B float64, or
B * R_pad bfloat16 and B bfloat16; on the CPU the prepared rows), its row
validity and the payloads: the split runs once per rank, and a step moves
8 * B * R_pad bytes (in float32 or float64; 2 * B * R_pad in bfloat16) +
5 * B bytes in float32, 9 * B in float64, 3 * B in bfloat16, plus the
payloads', which keep the reads' dtype. In float64 the merge's
``knn_select`` takes [best | d2] rows of k + B columns one block a row up
to 8,192 columns and in its wide mode past that; in bfloat16 on 16-bit
keys, ``big`` being bfloat16's finfo.max as in ``grid_tpu``'s ring. The
merge runs in row panels
of ``MERGE_ROWS`` rows, so besides the [B, B] Gram block no tensor is wider
than k + B: at N = 65,536 and W = 4 (B = 16,384) a whole-block merge would
hold ~3.3 GB of keys and indices per rank.
"""

from __future__ import annotations

import math

import torch

from grid_tpu_torch.ops.gpu_kernels import SplitZ, zprep_gram_cross, zprep_split
from grid_tpu_torch.ops.gpu_select import sorted_smallest_k_gpu
from grid_tpu_torch.ops.knn import block_d2
from grid_tpu_torch.parallel.mesh import CohortGroup

MERGE_ROWS = 4096  # rows of the block merged at once


def merge_candidates(best_d, best_i, best_p, d2, cols, block_pay, k: int):
    """Fold a visiting block into the running k best of each row.

    Args:
        best_d, best_i: [b, k] the best distances so far and their columns.
        best_p: tuple of [b, k] payloads carried with them.
        d2: [b, B] distances to the visiting rows; cols [B] their indices.
        block_pay: tuple of [B] payloads of the visiting rows.

    Returns (best_d, best_i, best_p): the k smallest of [best | d2] in
    stable-sort order (equal distances keep the lower position).
    """
    vals, pos = sorted_smallest_k_gpu(torch.cat([best_d, d2], dim=1), k)
    pos = pos.long()
    old = pos < k
    old_pos, new_pos = pos.clamp(max=k - 1), (pos - k).clamp_min(0)

    def pick(best, fresh):
        return torch.where(old, best.gather(1, old_pos), fresh[new_pos].to(best.dtype))

    return (vals, pick(best_i, cols),
            tuple(pick(bp, pb) for bp, pb in zip(best_p, block_pay)))


def ring_knn(z, k: int, group: CohortGroup, row_valid=None, payloads=()):
    """kNN over a row-sharded prepared z matrix, from one rank.

    Args:
        z: [B, R] this rank's rows of the prepared z (clipped, zero-filled;
            :func:`grid_tpu_torch.ops.knn.prepare_z`).
        k: neighbors per row (< the number of valid rows).
        group: the ranks; rank r holds rows r*B .. r*B + B - 1.
        row_valid: [B] bool; False rows (padding) are never returned as
            neighbors.
        payloads: tuple of [B] per-row vectors carried round the ring with
            the rows, returned as [B, k] at the neighbors' positions (so no
            gather by index is needed after the ring).

    Returns (sq_dists [B, k] ascending, idx [B, k] int32 global rows,
    *carried [B, k]).
    """
    b = z.shape[0]
    row0 = group.rank * b
    if row_valid is None:
        row_valid = torch.ones(b, dtype=torch.bool, device=z.device)
    own = zprep_split(z, None, None, math.inf)
    block = [own.p, own.norms, row_valid.bool(), *payloads]
    big = torch.finfo(own.norms.dtype).max
    best_d = torch.full((b, k), big, dtype=own.norms.dtype, device=z.device)
    best_i = torch.zeros((b, k), dtype=torch.int32, device=z.device)
    best_p = tuple(torch.zeros((b, k), dtype=p.dtype, device=z.device) for p in payloads)
    for s in range(group.world):
        owner = (group.rank - s) % group.world
        visiting = SplitZ(block[0], block[1])
        g = zprep_gram_cross(own, visiting, row0, owner * b)
        cols = torch.arange(owner * b, owner * b + b, dtype=torch.int32, device=z.device)
        for r0 in range(0, b, MERGE_ROWS):
            rows = slice(r0, min(b, r0 + MERGE_ROWS))
            d2 = block_d2(g[rows], own.norms[rows], visiting.norms, block[2],
                          self_offset=r0 if owner == group.rank else None)
            best_d[rows], best_i[rows], merged = merge_candidates(
                best_d[rows], best_i[rows], tuple(p[rows] for p in best_p), d2, cols,
                tuple(block[3:]), k)
            for p, m in zip(best_p, merged):
                p[rows] = m
            del d2
        del g
        if s + 1 < group.world:
            block = group.ring_shift(block)
    return (best_d, best_i, *best_p)
