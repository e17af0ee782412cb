"""Iterative haplotype copy-number inference (twin of
``grid_tpu/ops/phasing.py``; reference ``grid/utils/hi_inference.py:175-250``).

The ragged per-haplotype neighbor lists are padded ``[2N, K]``
index/weight/valid tensors, and each of the n_iters Jacobi sweeps is a few
vectorised gathers and row sums (the JAX package's ``lax.scan`` becomes a
Python loop). The reference's 1e-9 weight-sum floor is kept, so padded and
empty neighbor sets fall back exactly as there.

The reference updates in place while it walks the samples (Gauss-Seidel);
the device sweeps are Jacobi. Both share their fixed points.
:func:`phase_gauss_seidel_host` and :func:`compute_imputed_host` repeat the
reference's order in Python floats, for ``device.exact_phasing``.

:func:`phase_bootstrap` resamples each haplotype's neighbor slots per
replicate and runs all replicates as one leading batch dimension through
the sweeps of :func:`phase_haplotypes`.
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
    reference's floor: sum(w*val) / (1e-9 + sum(w)). Returns (means, wsum).

    ``hap_irrs`` is [..., 2N] and ``nbr_idx``/``nbr_w`` [..., 2N, K] with the
    same leading (replicate) dimensions; ``nbr_valid`` is [2N, K]."""
    lead = hap_irrs.shape[:-1]
    val = torch.gather(hap_irrs, -1, nbr_idx.reshape(*lead, -1)).reshape(nbr_idx.shape)
    ok = nbr_valid & ~torch.isnan(val)
    wsum = torch.where(ok, nbr_w, 0).sum(dim=-1)
    wval = torch.where(ok, nbr_w * val, 0).sum(dim=-1)
    return wval / (1e-9 + wsum.to(hap_irrs.dtype)), wsum


def phase_haplotypes(irrs, nbr_idx, nbr_w, nbr_valid, min_nbr: int, n_iters: int) -> PhasingResult:
    """Run the iterative phasing to n_iters (Jacobi ordering).

    Args:
        irrs: [N] diploid IRR (dipCN) per sample; non-finite entries are
            samples outside phasing.
        nbr_idx: [2N, K] neighbor haplotype-row indices (padding -> 0), or
            [B, 2N, K] for B replicates phased at once.
        nbr_w: [2N, K] neighbor weights (padding -> 0), shaped as nbr_idx.
        nbr_valid: [2N, K] bool padding mask, shared by all replicates.
        min_nbr: both haplotypes need >= min_nbr neighbors to participate.
        n_iters: number of sweeps.

    Returns hap_irrs [2N] ([B, 2N] for replicates); mean_irrs and phased
    depend on irrs and nbr_valid only.
    """
    n = irrs.shape[0]
    nbr_idx = nbr_idx.long()
    lead = nbr_idx.shape[:-2]
    deg = nbr_valid.sum(dim=1).reshape(n, 2)  # per-sample [h0, h1]
    phased = (deg[:, 0] >= min_nbr) & (deg[:, 1] >= min_nbr) & torch.isfinite(irrs)

    hap0 = torch.where(phased, irrs / 2, math.nan)
    hap = torch.stack([hap0, hap0], dim=1).reshape(2 * n).expand(*lead, 2 * n)
    irr_rep = irrs.repeat_interleave(2)

    for _ in range(n_iters):
        means, _ = _neighbor_means(hap, nbr_idx, nbr_w, nbr_valid)
        m = means.reshape(*lead, n, 2)
        denom = m[..., 0] + m[..., 1]
        new = (irr_rep * means) / denom.repeat_interleave(2, dim=-1)
        keep_old = (denom <= 0).repeat_interleave(2, dim=-1) | torch.isnan(hap)
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


# ----------------------------------------------------------------- host ---


def phase_gauss_seidel_host(irrs, hap_nbrs, min_nbr: int, n_iters: int):
    """Reference-ordered phasing on the host, bit for bit
    (grid/utils/hi_inference.py:175-226: in-place updates, Python float64,
    sequential sums).

    Args:
        irrs: sequence of N diploid IRRs.
        hap_nbrs: ragged list (length 2N) of (neighbor_hap_idx, weight).

    Returns (hap_irrs list[2N], mean_irrs float, phased list[N] bool).
    """
    n = len(irrs)
    hap_irrs = [float("nan")] * (2 * n)
    phased = [False] * n

    n_to_phase = 0
    mean_irrs = 0.0
    for i in range(n):
        if len(hap_nbrs[2 * i]) >= min_nbr and len(hap_nbrs[2 * i + 1]) >= min_nbr:
            hap_irrs[2 * i] = irrs[i] / 2
            hap_irrs[2 * i + 1] = irrs[i] / 2
            phased[i] = True
            n_to_phase += 1
            mean_irrs += irrs[i]
    if n_to_phase > 0:
        mean_irrs /= n_to_phase

    for _ in range(n_iters):
        for i in range(n):
            if math.isnan(hap_irrs[2 * i]):
                continue
            wsum = [1e-9, 1e-9]
            wval = [0.0, 0.0]
            for h in range(2):
                for nbr, w in hap_nbrs[2 * i + h]:
                    val = hap_irrs[nbr]
                    if not math.isnan(val):
                        wsum[h] += w
                        wval[h] += w * val
            m0 = wval[0] / wsum[0]
            m1 = wval[1] / wsum[1]
            denom = m0 + m1
            if denom > 0:
                hap_irrs[2 * i] = irrs[i] * m0 / denom
                hap_irrs[2 * i + 1] = irrs[i] * m1 / denom

    return hap_irrs, mean_irrs, phased


def compute_imputed_host(i, hap_irrs, hap_nbrs, mean_irrs):
    """Host imputation of sample i (grid/utils/hi_inference.py:229-250):
    (imp0, imp1), each the weighted mean of the haplotype's phased
    neighbors, or mean_irrs / 2 where none contributed."""
    wsum = [1e-9, 1e-9]
    wval = [0.0, 0.0]
    for h in range(2):
        for nbr, w in hap_nbrs[2 * i + h]:
            val = hap_irrs[nbr]
            if not math.isnan(val):
                wsum[h] += w
                wval[h] += w * val
    imp0 = wval[0] / wsum[0]
    imp1 = wval[1] / wsum[1]
    if wsum[0] <= 1e-9:
        imp0 = mean_irrs / 2
    if wsum[1] <= 1e-9:
        imp1 = mean_irrs / 2
    return imp0, imp1


# ------------------------------------------------------------- bootstrap ---


def bootstrap_slots(nbr_valid, n_boot: int, generator: torch.Generator):
    """The slots each bootstrap replicate draws: [n_boot, 2N, K] int64,
    uniform in [0, deg) for a haplotype of degree deg (valid neighbors are
    the prefix of its row), 0 where deg is 0. Drawn on ``generator``'s
    device, which must be nbr_valid's."""
    deg = nbr_valid.sum(dim=1).clamp_min(1)  # [2N]
    u = torch.rand((n_boot, *nbr_valid.shape), generator=generator, dtype=torch.float64,
                   device=nbr_valid.device)
    # floor(u * deg), kept below deg where u * deg rounds up to it
    return torch.minimum((u * deg[None, :, None]).long(), deg[None, :, None] - 1)


def phase_bootstrap_slots(irrs, nbr_idx, nbr_w, nbr_valid, slots, min_nbr: int, n_iters: int):
    """The bootstrap replicates of :func:`phase_haplotypes` for given slots:
    replicate b takes ``nbr_idx[h, slots[b, h]]`` and its weight in place of
    each neighbor of haplotype h (validity, and with it the min_nbr gate,
    is kept), and all replicates run through the sweeps at once.

    Returns (hap_mean [2N], hap_std [2N] (population), hap_boot [B, 2N]).
    """
    b = slots.shape[0]
    bi = torch.gather(nbr_idx.long().expand(b, *nbr_idx.shape), 2, slots)
    bw = torch.gather(nbr_w.expand(b, *nbr_w.shape), 2, slots)
    hap_boot = phase_haplotypes(irrs, bi, bw, nbr_valid, min_nbr, n_iters).hap_irrs
    return hap_boot.mean(dim=0), hap_boot.std(dim=0, correction=0), hap_boot


def phase_bootstrap(generator, irrs, nbr_idx, nbr_w, nbr_valid, min_nbr: int, n_iters: int,
                    n_boot: int = 100):
    """Bootstrap uncertainty of the haplotype estimates (the twin of
    ``grid_tpu.ops.phasing.phase_bootstrap``, with a ``torch.Generator`` in
    place of a JAX key): each of n_boot replicates resamples every
    haplotype's neighbor list with replacement (:func:`bootstrap_slots`)
    and reruns the n_iters sweeps (:func:`phase_bootstrap_slots`). The
    draws differ from JAX's; their distribution is the same.

    Returns (hap_mean [2N], hap_std [2N], hap_boot [n_boot, 2N]).
    """
    slots = bootstrap_slots(nbr_valid, n_boot, generator)
    return phase_bootstrap_slots(irrs, nbr_idx, nbr_w, nbr_valid, slots, min_nbr, n_iters)
