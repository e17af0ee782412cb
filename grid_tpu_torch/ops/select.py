"""Exact threshold selection and gather-free dipCN (twin of
``grid_tpu/ops/select.py``), on the resident distance matrix or on its row
panels, for one locus or for L loci's weights on the same distances
(:func:`dipcn_from_distances_multi`), and from the sorted neighbor lists
(:func:`dipcn_from_lists`).

Non-negative floats bitcast to signed integers of the same width keep their
order (int16 keys for bfloat16, as ``grid_tpu`` takes them), so the k-th
smallest distance of a row is found by bisection on the integer key space:
each round is one compare-and-count pass. In bfloat16 the sums round where
``grid_tpu``'s do: the weights cast to bfloat16, each row's sum accumulated
in float32 and rounded once, the mean and the quotient each rounded. Ties at the
threshold go to the lower column (stable-argsort parity) through a second
bisection on the column index.

:func:`dipcn_from_distances` and :func:`dipcn_from_distances_multi` are the
plain versions of the CUDA kernel's two forms in
:mod:`grid_tpu_torch.ops.gpu_select`.
"""

from __future__ import annotations

import math

import torch

from grid_tpu_torch import native
from grid_tpu_torch.ops.gpu_kernels import zprep_gram_panel_plain, zprep_split_plain
from grid_tpu_torch.ops.knn import panel_d2

# order-preserving integer key type per float dtype (values are >= 0, so the
# raw bit pattern as a SIGNED int of the same width is monotone)
_KEY_TYPES = {
    torch.float32: torch.int32,
    torch.float64: torch.int64,
    torch.bfloat16: torch.int16,
}


def _key_type(dtype):
    key_type = _KEY_TYPES.get(dtype)
    if key_type is None:
        raise ValueError(f"unsupported dtype {dtype}")
    return key_type


def _per_row(k, n, device):
    """``k`` (an int or an [N] tensor) as an [N] int64 tensor."""
    return torch.as_tensor(k, dtype=torch.int64, device=device).expand(n)


def _kth_smallest_key(u, k):
    """Exact k-th smallest integer key per row of ``u`` [N, W] (keys are
    non-negative). ``k`` is an int or an [N] tensor, 1 <= k <= W; rows with
    k <= 0 return a value the caller must mask."""
    n = u.shape[0]
    bits = 8 * u.element_size()
    k_arr = _per_row(k, n, u.device)
    lo = torch.zeros(n, dtype=u.dtype, device=u.device)
    hi = torch.full((n,), (1 << (bits - 1)) - 1, dtype=u.dtype, device=u.device)
    for _ in range(bits - 1):
        mid = lo + (hi - lo) // 2
        ge = (u <= mid[:, None]).sum(dim=1) >= k_arr
        hi = torch.where(ge, mid, hi)
        lo = torch.where(ge, lo, mid + 1)
    return hi


def _tie_cut_column(tie_mask, need):
    """Smallest column c with ``count(tie & col <= c) >= need`` per row, by
    bisection on the column index; -1 where need <= 0 (no ties taken)."""
    n, w = tie_mask.shape
    cols = torch.arange(w, device=tie_mask.device)
    lo = torch.zeros(n, dtype=torch.int64, device=tie_mask.device)
    hi = torch.full((n,), w - 1, dtype=torch.int64, device=tie_mask.device)
    for _ in range(max(int(w - 1).bit_length(), 1)):
        mid = lo + (hi - lo) // 2
        ge = (tie_mask & (cols[None, :] <= mid[:, None])).sum(dim=1) >= need
        hi = torch.where(ge, mid, hi)
        lo = torch.where(ge, lo, mid + 1)
    return torch.where(need > 0, hi, -1)


def _take_smallest(u, k):
    """Membership of the k smallest keys per row, ties to the lower column."""
    t = _kth_smallest_key(u, k)
    below = u < t[:, None]
    at = u == t[:, None]
    need = _per_row(k, u.shape[0], u.device) - below.sum(dim=1)
    cut = _tie_cut_column(at, need)
    cols = torch.arange(u.shape[1], device=u.device)
    return below | (at & (cols[None, :] <= cut[:, None]))


def smallest_k_mask(d2, k):
    """Exact membership mask of the k smallest values per row (ties broken
    by ascending column) — [N, W] bool with exactly ``min(k, W)`` True per
    row. ``k`` is an int or an [N] tensor; rows with k <= 0 get empty
    masks."""
    u = d2.view(_key_type(d2.dtype))
    mask = _take_smallest(u, k)
    return mask & (_per_row(k, u.shape[0], u.device) > 0)[:, None]


def _take_set(d2, col_usable, k: int, n_nbr: int):
    """(take [N, W] bool, m_eff [N]): each row's first ``m_eff = min(n_nbr,
    usable members of its k-set)`` usable columns among its k nearest, ties
    to the lower column; no column where m_eff is 0."""
    key_type = _key_type(d2.dtype)
    big = torch.iinfo(key_type).max
    u = d2.view(key_type)
    in_sk = smallest_k_mask(d2, k)
    uu = torch.where(in_sk & col_usable[None, :], u, big)

    m_eff = (uu < big).sum(dim=1).clamp_max(n_nbr)
    return _take_smallest(uu, m_eff) & (m_eff > 0)[:, None], m_eff


def dipcn_from_distances(d2, rnorm, nbr_w, col_usable, sample_valid, k: int, n_nbr: int):
    """dipCN straight from the distance matrix, with no neighbor lists and
    no gathers.

    Equivalent to gathering the k nearest neighbors (ascending, stable ties)
    and averaging ``nbr_w`` over the first n_nbr usable ones: the usable
    prefix is a second thresholding restricted to usable members of the
    k-set, and the mean is one masked row sum.

    Args:
        d2: [N, W] squared distances with self and invalid-row columns
            already set to a large FINITE value.
        rnorm: [N] reads_i / scale_i.
        nbr_w: [W] reads_j / scale_j contribution of each column.
        col_usable: [W] bool — column j may be averaged.
        sample_valid: [N] bool.
        k / n_nbr: neighbor-list length and averaging depth.

    Returns (dipcn [N], out_valid [N]).
    """
    take, m_eff = _take_set(d2, col_usable, k, n_nbr)
    tot = torch.where(take, nbr_w.to(d2.dtype)[None, :], 0).sum(dim=1)
    nbr_mean = tot / m_eff.clamp_min(1)
    dipcn = rnorm.to(d2.dtype) / nbr_mean
    return dipcn, sample_valid & (m_eff > 0)


def dipcn_from_distances_multi(d2, rnorm, nbr_w, col_usable, sample_valid, k: int, n_nbr: int):
    """:func:`dipcn_from_distances` for L loci's weights on one distance
    geometry (the multi-locus sweep; twin of
    ``grid_tpu.ops.select.dipcn_from_distances_multi``). The take-set
    depends only on d2 and the shared ``col_usable``, so the L masked sums
    are one [N, W] @ [W, L] product of the take mask. Per locus it equals
    :func:`dipcn_from_distances` up to summation order.

    Args:
        d2: [N, W] squared distances (self and invalid-row columns set to a
            large FINITE value).
        rnorm: [N, L] reads_i / scale_i per locus.
        nbr_w: [W, L] contribution of each column per locus.
        col_usable: [W] bool, shared by the L loci (call once per group of
            loci with one usability pattern).
        sample_valid: [N, L] bool.
        k / n_nbr: neighbor-list length and averaging depth.

    Returns (dipcn [N, L], out_valid [N, L]).
    """
    take, m_eff = _take_set(d2, col_usable, k, n_nbr)
    tot = take.to(d2.dtype) @ nbr_w.to(d2.dtype)
    nbr_mean = tot / m_eff.clamp_min(1)[:, None]
    dipcn = rnorm.to(d2.dtype) / nbr_mean
    return dipcn, sample_valid & (m_eff > 0)[:, None]


def dipcn_from_lists(d2, sq_dists, nbr_idx, rnorm, nbr_w, col_usable, sample_valid, k: int,
                     n_nbr: int):
    """Threshold dipCN from the sorted k-nearest lists of the same d2
    (``CohortParams.dipcn_lists``): the same function as
    :func:`dipcn_from_distances` and ``grid_tpu``'s ``dipcn_from_lists``,
    in tensor code on any device (``grid_tpu`` runs it as XLA code on its
    device; it has no Pallas kernel).

    The lists hold each row's k-set in (value, column) order, so its
    take-set is the first ``m_eff = min(usable in the list, n_nbr)`` usable
    entries of the list: a gather of ``col_usable`` over [N, k], a running
    count and a compare, where the JAX package bisects list positions with
    passes over d2. The take-set's weights are then summed over the columns
    of a zero [N, W] row, as :func:`dipcn_from_distances` sums them, so the
    two give the same float wherever their take-sets agree. No value
    crosses to the host; each call on the card counts one launch of the
    route.

    PRECONDITION: the lists are the exact k smallest of each row of d2,
    ascending, ties to the lower column (:func:`ops.knn.sorted_smallest_k`,
    bitwise the ``knn_select`` kernel's). ``sq_dists`` is not read: the
    positions carry the order.

    Args: as :func:`dipcn_from_distances`, plus the [N, k] lists.
    Returns (dipcn [N], out_valid [N]).
    """
    idx = nbr_idx.long()
    usable = col_usable[idx]
    seen = usable.cumsum(dim=1)  # usable entries up to each list position
    m_eff = seen[:, -1].clamp_max(n_nbr)
    take = usable & (seen <= m_eff[:, None])  # empty where m_eff is 0
    weights = torch.where(take, nbr_w.to(d2.dtype)[idx], 0)
    tot = torch.zeros_like(d2).scatter_(1, idx, weights).sum(dim=1)
    dipcn = rnorm.to(d2.dtype) / (tot / m_eff.clamp_min(1))
    if d2.is_cuda:
        native.count_launch(dipcn_from_lists)
    return dipcn, sample_valid & (m_eff > 0)


dipcn_from_lists.launches = 0


def dipcn_from_distances_panels(zp, rnorm, nbr_w, col_usable, sample_valid, k: int, n_nbr: int,
                                row_block: int = 512, row_valid=None):
    """:func:`dipcn_from_distances` without the resident [N, N] matrix: one
    [row_block, N] distance panel at a time, from a plain Gram product of
    the prepared rows, each run through the resident core. A panel holds
    its rows' whole distance vectors, so every row's sets are exact. The
    plain twin of ``grid_tpu.ops.select.dipcn_from_distances_panels`` (its
    binary form; the cohort step's panel branch runs the hand kernels on
    the same panels; ``ops.gpu_select.dipcn_multi_panels_gpu`` is the card
    route of the multi-locus form).

    Args:
        zp: [N, R] prepared z (``ops.knn.prepare_z``).
        rnorm: [N] reads_i / scale_i, or [N, L] for the multi-locus form
            (:func:`dipcn_from_distances_multi`; nbr_w and sample_valid are
            then [N, L] too, and the outputs gain the L axis).
        nbr_w: [N] neighbor contribution per column.
        col_usable: [N] bool — column may be averaged.
        sample_valid: [N] bool — output validity per row.
        k / n_nbr: neighbor-list length and averaging depth.
        row_block: panel height.
        row_valid: [N] bool — rows that exist in the distance geometry
            (their columns are not set to finfo.max); defaults to
            sample_valid (in the multi-locus form, the rows valid for any
            locus). A sample without a read count is row_valid but not
            col_usable: it can fill a k-slot but adds nothing to the mean,
            so the two must not be collapsed.

    Returns (dipcn [N], out_valid [N]), or [N, L] each.
    """
    if row_block < 1:
        raise ValueError(f"row_block={row_block} must be >= 1")
    n = zp.shape[0]
    multi = rnorm.dim() == 2
    if row_valid is not None:
        geom = row_valid
    else:
        geom = sample_valid.any(dim=1) if multi else sample_valid
    core = dipcn_from_distances_multi if multi else dipcn_from_distances
    split = zprep_split_plain(zp, None, None, math.inf)
    dips, oks = [], []
    for i0 in range(0, n, row_block):
        rows = min(row_block, n - i0)
        d2 = panel_d2(zprep_gram_panel_plain(split, i0, rows), split.norms, i0, geom.to(torch.bool))
        dip, ok = core(d2, rnorm[i0:i0 + rows], nbr_w, col_usable, sample_valid[i0:i0 + rows],
                       k=k, n_nbr=n_nbr)
        dips.append(dip)
        oks.append(ok)
    return torch.cat(dips), torch.cat(oks)
