"""Iterative haplotype copy-number inference (twin of
``grid_tpu/ops/phasing.py``; reference ``grid/utils/hi_inference.py:175-250``).

The ragged per-haplotype neighbor lists are padded ``[2N, K]``
index/weight/valid tensors, and each of the n_iters Jacobi sweeps is a few
vectorised gathers and row sums (the JAX package's ``lax.scan`` becomes a
Python loop). The reference's 1e-9 weight-sum floor is kept, so padded and
empty neighbor sets fall back exactly as there.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


class PhasingResult(NamedTuple):
    """Outputs of :func:`phase_haplotypes`.

    Attributes:
        hap_irrs: [2N] final haplotype values (NaN for unphased samples);
            sample i's haplotypes are rows 2i and 2i+1.
        mean_irrs: 0-d mean diploid IRR over phased samples (0 if none).
        phased: [N] bool — both haplotypes had >= min_nbr neighbors.
    """

    hap_irrs: torch.Tensor
    mean_irrs: torch.Tensor
    phased: torch.Tensor


def _neighbor_means(hap_irrs, nbr_idx, nbr_w, nbr_valid):
    """Weighted mean of non-NaN neighbor values per haplotype row, with the
    reference's floor: sum(w*val) / (1e-9 + sum(w)). Returns (means, wsum)."""
    val = hap_irrs[nbr_idx]  # [2N, K]
    ok = nbr_valid & ~torch.isnan(val)
    wsum = torch.where(ok, nbr_w, 0).sum(dim=1)
    wval = torch.where(ok, nbr_w * val, 0).sum(dim=1)
    return wval / (1e-9 + wsum.to(hap_irrs.dtype)), wsum


def phase_haplotypes(irrs, nbr_idx, nbr_w, nbr_valid, min_nbr: int, n_iters: int) -> PhasingResult:
    """Run the iterative phasing to n_iters (Jacobi ordering).

    Args:
        irrs: [N] diploid IRR (dipCN) per sample; non-finite entries are
            samples outside phasing.
        nbr_idx: [2N, K] neighbor haplotype-row indices (padding -> 0).
        nbr_w: [2N, K] neighbor weights (padding -> 0).
        nbr_valid: [2N, K] bool padding mask.
        min_nbr: both haplotypes need >= min_nbr neighbors to participate.
        n_iters: number of sweeps.
    """
    n = irrs.shape[0]
    nbr_idx = nbr_idx.long()
    deg = nbr_valid.sum(dim=1).reshape(n, 2)  # per-sample [h0, h1]
    phased = (deg[:, 0] >= min_nbr) & (deg[:, 1] >= min_nbr) & torch.isfinite(irrs)

    hap0 = torch.where(phased, irrs / 2, math.nan)
    hap = torch.stack([hap0, hap0], dim=1).reshape(2 * n)
    irr_rep = irrs.repeat_interleave(2)

    for _ in range(n_iters):
        means, _ = _neighbor_means(hap, nbr_idx, nbr_w, nbr_valid)
        m = means.reshape(n, 2)
        denom = m[:, 0] + m[:, 1]
        new = (irr_rep * means) / denom.repeat_interleave(2)
        keep_old = (denom <= 0).repeat_interleave(2) | torch.isnan(hap)
        hap = torch.where(keep_old, hap, new)

    n_phased = phased.sum()
    mean_irrs = torch.where(
        n_phased > 0, torch.where(phased, irrs, 0).sum() / n_phased.clamp_min(1), 0.0
    )
    return PhasingResult(hap_irrs=hap, mean_irrs=mean_irrs, phased=phased)


def compute_imputed(hap_irrs, nbr_idx, nbr_w, nbr_valid, mean_irrs):
    """Final-iteration imputation (ref: grid/utils/hi_inference.py:229-250):
    per haplotype the weighted neighbor mean, or ``mean_irrs / 2`` when no
    phased neighbor contributed. Returns imp [2N]."""
    means, wsum = _neighbor_means(hap_irrs, nbr_idx.long(), nbr_w, nbr_valid)
    return torch.where(wsum > 0, means, mean_irrs / 2)
