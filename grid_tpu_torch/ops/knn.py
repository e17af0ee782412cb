"""Depth-matched nearest neighbors on the resident distance matrix (twin of
``grid_tpu/ops/knn.py``).

Squared Euclidean distances come from a Gram product,
``d2(a, b) = |a|^2 + |b|^2 - 2 a.b``; self is excluded and invalid rows are
never selectable. Only the d2-resident form of the fused cohort step is
ported here; the row-panel scan (``knn_squared``) waits on ROADMAP queue 1.
"""

from __future__ import annotations

import torch

from grid_tpu_torch.ops.gpu_kernels import zprep_gram


def region_filter_mask(sigma2ratios, frac_r: float = 1.0, sigma2_max: float = 1000.0,
                       n_written=None):
    """Boolean [R] region mask keeping finite ratios in
    [sigma2_min, sigma2_max] (ref: grid/utils/find_neighbors.py:128-175).

    sigma2_min is the value at rank ``int(n_written * (1 - frac_r))`` of the
    ascending finite ratios, clamped into them; with no finite ratio every
    region is kept.

    Args:
        n_written: the column count the rank is computed against (the
            number of WRITTEN columns in the file pipeline); an int or a
            0-d tensor. Defaults to the array length.
    """
    r = sigma2ratios.shape[0] if n_written is None else n_written
    finite = torch.isfinite(sigma2ratios)
    n_finite = finite.sum()
    sorted_vals = torch.sort(torch.where(finite, sigma2ratios, torch.inf)).values
    # int() truncation of r * (1 - frac_r), in float32 like the reference;
    # the epsilon guards float error flipping e.g. 90.0 to 89.999996
    f32 = dict(dtype=torch.float32, device=sigma2ratios.device)
    rank = torch.floor(
        torch.as_tensor(r, **f32) * torch.tensor(1.0 - frac_r, **f32) + torch.tensor(1e-4, **f32)
    ).long()
    lower_idx = torch.minimum(rank, (n_finite - 1).clamp_min(0))
    sigma2_min = sorted_vals[lower_idx]
    mask = finite & (sigma2ratios >= sigma2_min) & (sigma2ratios <= sigma2_max)
    return torch.where(n_finite > 0, mask, torch.ones_like(mask))


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
    inside the product, and the squared norms are its diagonal. The epilogue
    d2 = max(|a|^2 + |b|^2 - 2 G, 0) is plain elementwise code.
    """
    g = zprep_gram(z, mask, region_mask, zmax)
    sq = torch.diagonal(g)
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
    equal values, so it is not used.

    Returns (vals [N, k], idx [N, k] int32).
    """
    vals, idx = torch.sort(d2, dim=1, stable=True)
    return vals[:, :k].contiguous(), idx[:, :k].to(torch.int32)
