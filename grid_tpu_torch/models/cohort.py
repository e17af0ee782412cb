"""The fused cohort step, normalize -> kNN -> dipCN -> phasing (twin of
``grid_tpu/models/cohort.py``):

    raw depth matrix [N, R] + read counts [N] (+ hap neighbors [2N, K])
        -> normalize (masked column stats: Triton kernel)       ~ O(N R)
        -> region selection + variance filter  (masking, not gathering)
        -> d2 = |a|^2 + |b|^2 - 2 G, G from the fused z-prep Gram
           (CUDA kernel)                                        ~ O(N^2 R)
        -> sorted k nearest neighbors (CUDA kernel, one block per row)
        -> threshold dipCN (CUDA kernel, one block per row)     ~ O(N^2)
        -> phasing (CUDA kernel, all Jacobi sweeps)             ~ O(iters N K)

While the [N, N] distance matrix fits ``d2_budget_bytes`` it is resident;
beyond that the step streams row panels of ``row_block`` rows: P's split
once per step, then per panel one Gram panel [B, N] whose distances feed
both the neighbor selection and dipCN. The JAX package computes each
panel's Gram product twice there (``knn_squared`` and
``dipcn_from_distances_panels``); the outputs are the same either way.

De-selected regions are zeroed rather than dropped: a zero column adds
nothing to any distance, so every shape stays fixed.

The step runs on the device its inputs lie on: the hand kernels on a CUDA
device, their plain PyTorch versions on the CPU.

bfloat16 values (``device.dtype: bfloat16``) run steps 4-6 in bfloat16,
each op rounded where ``grid_tpu``'s step rounds it, through the kernels'
bf16 forms; the d2 budget counts 2 bytes an entry. The dipCN weights
``reads / scales`` are taken in the reads' dtype and rounded to bfloat16
once, as ``grid_tpu`` under x64 takes them in float64. Step 7 computes as
under ``auto`` (``utils.device.step_dtype``): in float32 on the card, in
float64 on the CPU.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from grid_tpu_torch.ops.gpu_kernels import zprep_split
from grid_tpu_torch.ops.gpu_select import dipcn_from_distances_gpu, sorted_smallest_k_gpu
from grid_tpu_torch.ops.knn import (
    d2_matrix,
    d2_panels,
    region_filter_mask,
)
from grid_tpu_torch.ops.normalize import normalize_cohort, select_high_variance_mask
from grid_tpu_torch.ops.phasing import PhasingResult, compute_imputed, phase_haplotypes
from grid_tpu_torch.ops.select import dipcn_from_lists


class CohortParams(NamedTuple):
    """Hyperparameters of the fused cohort step; the same fields and
    defaults as ``grid_tpu.models.cohort.CohortParams``."""

    top_frac: float = 0.1  # normalize: high-variance selection (quirk Q2)
    zmax: float = 2.0  # neighbors: z clip
    sigma2_max: float = 1000.0  # neighbors: variance-ratio upper bound
    frac_r: float = 1.0  # neighbors: hidden lower-bound knob
    num_neighbors: int = 5  # neighbors per sample (C++ default 500)
    n_nbr: int = 300  # dipCN: neighbors averaged
    min_nbr: int = 1  # phasing: per-hap neighbor floor
    n_iters: int = 100  # phasing sweeps
    quantize: bool = True  # mimic %.2f file round-trip of scales/z
    row_block: int = 512  # kNN panel rows (panel branch)
    dipcn_lists: bool = False  # resident branch: dipCN from the sorted lists, any device
    use_pallas: bool = False  # accepted, no effect: the hand kernels are the path on the card
    # the [N, N] distance matrix stays resident while N*N*itemsize fits
    # this budget; beyond it the step streams row panels (0: always panels)
    d2_budget_bytes: int = 2 << 30


class CohortOutputs(NamedTuple):
    """Everything the file pipeline writes, as tensors."""

    z: torch.Tensor  # [N, R] normalized z-scores (0 where ~z_mask)
    z_mask: torch.Tensor  # [N, R]
    col_means: torch.Tensor  # [R]
    col_vars: torch.Tensor  # [R]
    var_ratio: torch.Tensor  # [R]
    region_selected: torch.Tensor  # [R] bool — high-variance selection
    region_used: torch.Tensor  # [R] bool — selected AND variance-filtered
    r_use: torch.Tensor  # 0-d — |region_used|
    scales: torch.Tensor  # [N] per-sample scale (quantized if requested)
    nbr_idx: torch.Tensor  # [N, k] int32
    nbr_sq_dists: torch.Tensor  # [N, k] squared distances, ascending
    dipcn: torch.Tensor  # [N]
    dipcn_valid: torch.Tensor  # [N]
    hap_irrs: torch.Tensor  # [2N]
    hap_imp: torch.Tensor  # [2N]
    phased: torch.Tensor  # [N]
    mean_irrs: torch.Tensor  # 0-d


def _q2(x):
    """Quantize to 2 decimals (round-half-even), matching %.2f file writes.
    In bfloat16 the divisor is a bf16 tensor: on the card a Python scalar
    divisor becomes a product with its reciprocal, which rounds otherwise
    than ``grid_tpu``'s division."""
    if x.dtype == torch.bfloat16:
        return torch.round(x * 100) / torch.tensor(100.0, dtype=x.dtype, device=x.device)
    return torch.round(x * 100) / 100


def _check_branch(params: CohortParams, n: int) -> None:
    """Raise for a neighbor count the cohort cannot give."""
    if params.num_neighbors > n - 1:
        raise ValueError(f"k={params.num_neighbors} must be <= N-1={n - 1}")


def d2_resident(params: CohortParams, n: int, itemsize: int) -> bool:
    """Whether the step keeps the [N, N] distance matrix resident (the JAX
    step's rule): the budget is positive and N * N * itemsize fits it."""
    return 0 < params.d2_budget_bytes and n * n * itemsize <= params.d2_budget_bytes


def _panel_knn_dipcn(z, z_mask, region_used, sample_ok, w, reads_valid, params: CohortParams):
    """kNN and threshold dipCN by row panels: P's split once, then
    :func:`panel_knn_dipcn` of every row. Never holds an [N, N] tensor."""
    split = zprep_split(z, z_mask, region_used, params.zmax)
    return panel_knn_dipcn(split, sample_ok, w, reads_valid, params)


def panel_knn_dipcn(split, sample_ok, w, reads_valid, params: CohortParams, rows=None):
    """kNN and threshold dipCN of the rows ``rows=(lo, hi)`` (default all)
    against all N rows of ``split``, by row panels: per panel one Gram
    panel and its distances, read by the selection (the ``knn_select``
    kernel over whole rows) and by the dipCN kernel. The flat panel branch
    takes every row; the gather form of the sharded step
    (``parallel/pcohort.py``) takes a rank's rows of the gathered split.

    Args:
        split: P's split (:func:`grid_tpu_torch.ops.gpu_kernels.zprep_split`)
            of all N rows.
        sample_ok: [N] rows that may be neighbors.
        w, reads_valid: [N] each row's dipCN weight and its usability.

    Returns (sq_dists [hi-lo, k], nbr_idx [hi-lo, k] int32 of global rows,
    dipcn [hi-lo], dipcn_valid [hi-lo]).
    """
    k = params.num_neighbors
    sq, idx, dips, oks = [], [], [], []
    for i0, d2 in d2_panels(split, params.row_block, sample_ok, rows):
        part = slice(i0, i0 + d2.shape[0])
        vals, nbr = sorted_smallest_k_gpu(d2, k)
        dip, ok = dipcn_from_distances_gpu(d2, w[part], w, reads_valid, reads_valid[part],
                                           k=k, n_nbr=params.n_nbr)
        del d2
        sq.append(vals)
        idx.append(nbr)
        dips.append(dip)
        oks.append(ok)
    return torch.cat(sq), torch.cat(idx), torch.cat(dips), torch.cat(oks)


def cohort_step(
    values,
    mask,
    reads,
    reads_valid,
    hap_nbr_idx,
    hap_nbr_w,
    hap_nbr_valid,
    params: CohortParams = CohortParams(),
    row_valid=None,
) -> CohortOutputs:
    """Run normalize -> kNN -> dipCN -> phasing on the inputs' device.

    Args:
        values: [N, R] raw binned depths.
        mask: [N, R] validity of each depth cell (any dtype: non-zero is valid).
        reads: [N] VNTR-window read counts (junk where ~reads_valid).
        reads_valid: [N] validity of each read count (non-zero is valid).
        hap_nbr_idx/w/valid: [2N, K] padded haplotype neighbors
            (see grid_tpu_torch.io.hap_neighbors.pad_hap_neighbors).
        params: hyperparameters.
        row_valid: optional [N] marking padding rows (non-zero is valid);
            invalid rows are excluded from all statistics.
    """
    n = values.shape[0]
    _check_branch(params, n)
    # the masks as bool whatever their dtype, as grid_tpu's step does
    mask, reads_valid = mask.bool(), reads_valid.bool()
    n_rows = None
    if row_valid is not None:
        row_valid = row_valid.bool()
        mask = mask & row_valid[:, None]
        n_rows = row_valid.sum()  # padding must not inflate the N-1 denom

    # ---- step 4: normalize + select ------------------------------------
    # bfloat16: the variance sums as grid_tpu's jitted step takes them
    norm = normalize_cohort(values, mask, n_rows=n_rows, round_squares=False)
    selected = select_high_variance_mask(norm.var_ratio, params.top_frac)

    scales = norm.row_means_raw
    z = norm.z
    if params.quantize:
        scales = _q2(scales)
        z = torch.where(norm.mask, _q2(z), z)

    # ---- step 5: region variance filter + kNN --------------------------
    # The neighbors step recomputes ratios from the WRITTEN (selected)
    # columns only: unselected regions are fed as NaN, and the rank base is
    # the written-column count.
    ratios_seen = torch.where(selected, norm.var_ratio, torch.nan)
    vfilter = region_filter_mask(
        ratios_seen, params.frac_r, params.sigma2_max, n_written=selected.sum()
    )
    region_used = selected & vfilter
    r_use = region_used.sum()

    # Rows with no surviving cells are never in the written matrix: they
    # are neither selectable neighbors nor contributors to dipCN means.
    sample_ok = norm.mask.any(dim=1)
    if row_valid is not None:
        sample_ok = sample_ok & row_valid
    # ---- step 6: threshold dipCN on the same distances -----------------
    # A sample without a read count still fills k-slots (the geometry is
    # sample_ok) but adds nothing to a mean (usable is reads_valid).
    reads_valid = reads_valid & sample_ok
    w = (reads / scales).to(values.dtype)
    if d2_resident(params, n, values.element_size()):
        d2 = d2_matrix(z, norm.mask, region_used, params.zmax, row_valid=sample_ok)
        sq_dists, nbr_idx = sorted_smallest_k_gpu(d2, params.num_neighbors)
        if params.dipcn_lists:  # the JAX step's opt-in form: tensor code on the lists
            dipcn, dipcn_valid = dipcn_from_lists(
                d2, sq_dists, nbr_idx, w, w, reads_valid, reads_valid,
                k=params.num_neighbors, n_nbr=params.n_nbr,
            )
        else:
            dipcn, dipcn_valid = dipcn_from_distances_gpu(
                d2, w, w, reads_valid, reads_valid, k=params.num_neighbors, n_nbr=params.n_nbr
            )
        del d2
    else:
        sq_dists, nbr_idx, dipcn, dipcn_valid = _panel_knn_dipcn(
            z, norm.mask, region_used, sample_ok, w, reads_valid, params
        )

    # ---- step 7: phasing ----------------------------------------------
    # Samples without a dipCN estimate never enter phasing; NaN marks them.
    irrs = torch.where(dipcn_valid, dipcn, torch.nan)
    if irrs.dtype == torch.bfloat16:  # as under auto: float32 on the card, float64 on the CPU
        wide = torch.float32 if irrs.is_cuda else torch.float64
        irrs, hap_nbr_w = irrs.to(wide), hap_nbr_w.to(wide)
    phasing: PhasingResult = phase_haplotypes(
        irrs, hap_nbr_idx, hap_nbr_w, hap_nbr_valid, params.min_nbr, params.n_iters
    )
    imp = compute_imputed(
        phasing.hap_irrs, hap_nbr_idx, hap_nbr_w, hap_nbr_valid, phasing.mean_irrs
    )

    return CohortOutputs(
        z=z,
        z_mask=norm.mask,
        col_means=norm.col_means,
        col_vars=norm.col_vars,
        var_ratio=norm.var_ratio,
        region_selected=selected,
        region_used=region_used,
        r_use=r_use,
        scales=scales,
        nbr_idx=nbr_idx,
        nbr_sq_dists=sq_dists,
        dipcn=dipcn,
        dipcn_valid=dipcn_valid,
        hap_irrs=phasing.hap_irrs,
        hap_imp=imp,
        phased=phasing.phased,
        mean_irrs=phasing.mean_irrs,
    )


def make_cohort_step(params: CohortParams):
    """Bind params; returns fn(values, mask, reads, reads_valid, hap_nbr_idx,
    hap_nbr_w, hap_nbr_valid) -> CohortOutputs."""

    def step(values, mask, reads, reads_valid, hap_nbr_idx, hap_nbr_w, hap_nbr_valid):
        return cohort_step(
            values, mask, reads, reads_valid, hap_nbr_idx, hap_nbr_w, hap_nbr_valid, params
        )

    return step
