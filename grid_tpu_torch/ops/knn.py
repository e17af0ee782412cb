"""Depth-matched nearest neighbors (twin of ``grid_tpu/ops/knn.py``).

Squared Euclidean distances come from a Gram product,
``d2(a, b) = |a|^2 + |b|^2 - 2 a.b``; self is excluded and invalid rows are
never selectable. Two forms, as in the JAX package: the resident [N, N]
matrix (:func:`d2_matrix`), and row panels [B, N] that never hold more
than O(B N) (:func:`d2_panels`, :func:`knn_squared`), for cohorts whose
[N, N] matrix exceeds the d2 budget.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from grid_tpu_torch.ops.gpu_kernels import SplitZ, zprep_gram, zprep_gram_panel, zprep_split


def _region_mask_at_rank(sigma2ratios, rank, sigma2_max: float):
    """The rule of both region filters (ref: grid/utils/find_neighbors.py:128-175):
    keep the finite ratios in [sigma2_min, sigma2_max], sigma2_min being the
    value at ``rank`` (clamped into them) of the ascending finite ratios;
    with no finite ratio every region is kept. R >= 1."""
    finite = torch.isfinite(sigma2ratios)
    n_finite = finite.sum()
    sorted_vals = torch.sort(torch.where(finite, sigma2ratios, torch.inf)).values
    lower_idx = torch.minimum(torch.as_tensor(rank, device=sigma2ratios.device),
                              (n_finite - 1).clamp_min(0))
    sigma2_min = sorted_vals[lower_idx]
    mask = finite & (sigma2ratios >= sigma2_min) & (sigma2ratios <= sigma2_max)
    return torch.where(n_finite > 0, mask, torch.ones_like(mask))


def filter_regions_by_variance(sigma2ratios, frac_r: float = 1.0, sigma2_max: float = 1000.0):
    """The region filter of the file-mode step 5, on a host array.

    Its rank is ``int(R * (1 - frac_r))`` in float64 against the TOTAL
    region count R (the reference's quirk). :func:`region_filter_mask`
    takes the rank in float32, as the JAX package's fused step does, so the
    two forms may keep one region more or less where R * (1 - frac_r) is
    within rounding of an integer (R=1000, frac_r=0.9: rank 99 here, 100
    there); each matches its twin in ``grid_tpu``.

    Returns (valid_indices ascending, R_use).
    """
    sigma2ratios = np.asarray(sigma2ratios)
    r = len(sigma2ratios)
    if r == 0:
        return np.arange(0), 0
    keep = _region_mask_at_rank(torch.as_tensor(sigma2ratios), int(r * (1.0 - frac_r)),
                                sigma2_max)
    valid_indices = np.flatnonzero(keep.numpy())
    return valid_indices, len(valid_indices)


def region_filter_mask(sigma2ratios, frac_r: float = 1.0, sigma2_max: float = 1000.0,
                       n_written=None):
    """Boolean [R] region mask of the fused step: the rule of
    :func:`_region_mask_at_rank` at rank ``int(n_written * (1 - frac_r))``.

    Args:
        n_written: the column count the rank is computed against (the
            number of WRITTEN columns in the file pipeline); an int or a
            0-d tensor. Defaults to the array length.
    """
    r = sigma2ratios.shape[0] if n_written is None else n_written
    # int() truncation of r * (1 - frac_r), in float32 like the JAX step;
    # the epsilon guards float error flipping e.g. 90.0 to 89.999996
    f32 = dict(dtype=torch.float32, device=sigma2ratios.device)
    rank = torch.floor(
        torch.as_tensor(r, **f32) * torch.tensor(1.0 - frac_r, **f32) + torch.tensor(1e-4, **f32)
    ).long()
    return _region_mask_at_rank(sigma2ratios, rank, sigma2_max)


def prepare_z(z, mask, zmax: float, region_mask=None):
    """Clip z to [-zmax, zmax] and zero-fill invalid entries
    (ref: grid/utils/find_neighbors.py:57-58). De-selected regions are
    zeroed too, which is the same as dropping them from every distance."""
    out = torch.where(mask, z.clamp(-zmax, zmax), 0)
    if region_mask is not None:
        out = out * region_mask[None, :].to(out.dtype)
    return out


def d2_matrix(z, mask, region_mask, zmax: float, row_valid=None):
    """The full [N, N] squared-distance matrix of the PREPARED rows, with the
    diagonal (self) and the columns of invalid rows set to finfo.max.

    Equals ``grid_tpu.ops.knn.d2_matrix(prepare_z(z, mask, zmax,
    region_mask), row_valid)``, but takes the raw z: the Gram matrix G comes
    from :func:`grid_tpu_torch.ops.gpu_kernels.zprep_gram`, which prepares z
    inside the product, and the squared norms are its diagonal (in bfloat16
    ``sum(P * P)`` as ``grid_tpu`` sums them, from the same call: they
    decide the order of the distances). The epilogue d2 = max(|a|^2 + |b|^2
    - 2 G, 0) is plain elementwise code, each op rounded in bfloat16 as
    ``grid_tpu``'s.
    """
    g, sq = zprep_gram(z, mask, region_mask, zmax, norms=True)
    d2 = (sq[:, None] + sq[None, :] - 2 * g).clamp_min_(0)
    big = torch.finfo(d2.dtype).max
    d2.fill_diagonal_(big)
    if row_valid is not None:
        d2.masked_fill_(~row_valid[None, :], big)
    return d2


def sorted_smallest_k(d2, k: int):
    """The k smallest values of each row, ascending, with their column
    indices; ties go to the lower column (stable-argsort parity).

    This is what ``lax.approx_max_k(-d2, k, recall_target=1.0)`` gives the
    JAX package and what the written neighbor artifact depends on. A stable
    full-row sort keeps that order; ``torch.topk`` promises no order among
    equal values, so it is not used. This is the plain version of the
    ``knn_select`` kernel (:func:`grid_tpu_torch.ops.gpu_select.sorted_smallest_k_gpu`).

    bfloat16 rows sort by their int16 keys, the order ``grid_tpu`` and the
    kernel take (a sort of the values flushes subnormals to zero on the
    CPU).

    Returns (vals [N, k], idx [N, k] int32).
    """
    if d2.dtype == torch.bfloat16:
        idx = torch.sort(d2.view(torch.int16), dim=1, stable=True).indices[:, :k]
        return torch.gather(d2, 1, idx), idx.to(torch.int32)
    vals, idx = torch.sort(d2, dim=1, stable=True)
    return vals[:, :k].contiguous(), idx[:, :k].to(torch.int32)


def block_d2(g, row_norms, col_norms, col_valid=None, self_offset=None):
    """Distances of a block of rows against a block of columns from their
    Gram block ``g`` [B, C]: d2 = max(|a|^2 + |b|^2 - 2 G, 0), with the
    columns of invalid rows (``col_valid`` False) and, where the blocks
    share rows, self (the diagonal at ``self_offset``: column
    ``self_offset + r`` for row r) set to finfo.max. The arithmetic is
    :func:`d2_matrix`'s, element by element."""
    d2 = (row_norms[:, None] + col_norms[None, :]).sub_(g, alpha=2).clamp_min_(0)
    big = torch.finfo(d2.dtype).max
    if self_offset is not None:
        d2.diagonal(offset=self_offset).fill_(big)
    if col_valid is not None:
        d2.masked_fill_(~col_valid[None, :], big)
    return d2


def panel_d2(g, norms, i0: int, col_valid=None):
    """The row panel's distances from its Gram rows: :func:`block_d2` of
    G = ``g`` [B, N] (rows i0 .. i0+B-1 against all N), self being global
    column i0 + r; the rows stay as they are."""
    return block_d2(g, norms[i0:i0 + g.shape[0]], norms, col_valid, self_offset=i0)


def d2_panels(split: SplitZ, row_block: int, col_valid=None, rows=None):
    """Yield (i0, d2 [B, N]) for the row panels i0 = lo, lo + B, ... of the
    prepared rows lo .. hi-1 in ``split`` (``rows=(lo, hi)``, default all:
    :func:`panel_d2` of each Gram panel against every row; the last panel
    has the rows that are left)."""
    if row_block < 1:
        raise ValueError(f"row_block={row_block} must be >= 1")
    lo, hi = rows or (0, split.norms.shape[0])
    for i0 in range(lo, hi, row_block):
        count = min(row_block, hi - i0)
        yield i0, panel_d2(zprep_gram_panel(split, i0, count), split.norms, i0, col_valid)


def knn_squared(z, k: int, row_valid=None, row_block: int = 512):
    """Exact k nearest neighbors by row panels of the Gram product; the
    twin of ``grid_tpu.ops.knn.knn_squared``.

    The JAX function's ``selector``, ``recall_target`` and ``col_block``
    are left out: each of its selectors and column blocks gives the same
    exact lists (recall 1.0), and the port has one selection over whole
    rows, the ``knn_select`` kernel
    (:func:`grid_tpu_torch.ops.gpu_select.sorted_smallest_k_gpu`; on the
    CPU its plain version :func:`sorted_smallest_k`).

    Args:
        z: [N, R] prepared z (clipped, zero-filled; :func:`prepare_z`).
        k: neighbors per row (self excluded), <= N - 1.
        row_valid: optional [N] bool; invalid rows are never returned as
            neighbors, and their own results are junk.
        row_block: rows per distance panel; a panel holds row_block * N
            distances.

    Returns (sq_dists [N, k] ascending, idx [N, k] int32).
    """
    n = z.shape[0]
    if k > n - 1:
        raise ValueError(f"k={k} must be <= N-1={n - 1}")
    # imported here: ops.gpu_select imports this module
    from grid_tpu_torch.ops.gpu_select import sorted_smallest_k_gpu

    split = zprep_split(z, None, None, math.inf)
    col_valid = None if row_valid is None else row_valid.to(torch.bool)
    found = [sorted_smallest_k_gpu(d2, k) for _, d2 in d2_panels(split, row_block, col_valid)]
    return torch.cat([v for v, _ in found]), torch.cat([i for _, i in found])
