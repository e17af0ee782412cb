"""Masked-array reduction primitives (twin of ``grid_tpu/ops/masked.py``).

An explicit ``(values, mask)`` pair replaces numpy NaN propagation; every
function keeps the input dtype.
"""

from __future__ import annotations

import math

import torch


def masked_mean(values, mask, axis=None):
    """Mean over ``mask``-valid entries; positions with zero valid count
    return NaN (matching ``np.nanmean`` of an all-NaN slice)."""
    v = torch.where(mask, values, 0)
    cnt = mask.sum(dim=axis)
    s = v.sum(dim=axis)
    return torch.where(cnt > 0, s / cnt.clamp_min(1), math.nan)


def masked_var_numerator(values, mask, means, axis=0):
    """Sum over valid entries of (x - mean)^2 along ``axis``; the caller
    divides by the TOTAL row count minus one (reference ddof convention)."""
    centered = torch.where(mask, values - means, 0)
    return (centered * centered).sum(dim=axis)


def masked_median(values, mask):
    """Median over valid entries of a 1-D tensor, matching ``np.median``:
    the AVERAGE of the two middle values for an even count (``torch.median``
    returns the lower one). NaN when nothing is valid."""
    s = torch.sort(torch.where(mask, values, math.inf)).values
    n_valid = mask.sum()
    lo = ((n_valid - 1) // 2).clamp_min(0)
    hi = (n_valid // 2).clamp_min(0)
    med = (s[lo] + s[hi]) / 2
    return torch.where(n_valid > 0, med, math.nan)
