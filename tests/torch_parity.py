"""The parity contract (``docs/parity.md``) as checks that both the
``tests/test_torch_*.py`` files and ``chip_smoke.py`` apply.

Values are compared relative to the largest magnitude of the reference
array: most entries here are sums of many rounded terms (z-scores,
distances), so an entry's error follows the array's scale, not its own.

Two float32 routes to the same distances (another summation order in the
Gram product, say) may order two neighbors whose distances differ by less
than the rounding error the other way round. The lists then still agree
"except ties": every column listed by only one side, or listed at another
position, has a distance within ``tol`` of where the other side put it.
With ``tol=0`` only exact ties may differ.
"""

from __future__ import annotations

import numpy as np

# The bfloat16 contract (``device.dtype: bfloat16``; README, the port's
# section). bfloat16 gives another answer, not a less precise one (grid_tpu
# in bf16 against float64: neighbor sets overlap ~89%), so bf16 is held to
# bf16. The port's plain bf16 route against grid_tpu's bf16 on the CPU:
# values within BF16_RTOL of max|want|, neighbor lists equal but for ties
# within BF16_RTOL of the row's k-th distance, dipCN within rtol BF16_RTOL
# where the input sets agree, and at least BF16_MIN_EQUAL of the entries
# exactly equal (measured: 1.0 of z, the column statistics, the distances
# and dipCN on tests/test_torch_bfloat16.py's cohorts, the lists equal but
# for the order of exact ties). A kernel against its plain version on the
# card: knn_select and dipcn_select bitwise on the same d2, the column
# statistics (sums of non-negative terms) within BF16_ULPS units in the last
# place, and the Gram within BF16_ULPS of each entry or BF16_GRAM_FLOOR of
# max|G|, whichever is larger: its float32 sums run in another order than
# cuBLAS's, and an entry that cancels to near 0 keeps their difference
# (~1e-3 at R=2048) at many of its own ulps.
BF16_RTOL = 2.0 ** -7
BF16_MIN_EQUAL = 0.99
BF16_ULPS = 1
BF16_GRAM_FLOOR = 2.0 ** -16


def assert_close_to_max(got, want, rtol: float) -> float:
    """Raise unless NaNs sit in the same places and every finite entry of
    ``got`` is within ``rtol * max|want|`` of ``want``; returns the largest
    difference."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.shape != want.shape:
        raise AssertionError(f"shape {got.shape} != {want.shape}")
    if not np.array_equal(np.isnan(got), np.isnan(want)):
        raise AssertionError("NaN positions differ")
    fin = np.isfinite(want)
    err = float(np.max(np.abs(got[fin] - want[fin]), initial=0.0))
    bound = rtol * float(np.max(np.abs(want[fin]), initial=0.0))
    if err > bound:
        raise AssertionError(f"max difference {err} > {rtol} * max|want| = {bound}")
    return err


def neighbor_rows_differing(idx_got, d_got, idx_want, d_want, tol) -> np.ndarray:
    """Rows whose sorted neighbor lists differ, after checking that every
    difference is a tie within ``tol``; raises AssertionError otherwise.

    Args:
        idx_got, d_got: [N, k] neighbor indices and ascending distances
            under test.
        idx_want, d_want: the same from the reference.
        tol: absolute distance tolerance, one for all rows or [N] per row.
    """
    idx_got, idx_want = np.asarray(idx_got), np.asarray(idx_want)
    d_got, d_want = np.asarray(d_got, np.float64), np.asarray(d_want, np.float64)
    tol = np.broadcast_to(np.asarray(tol, np.float64), d_want.shape[:1])
    row_err = np.max(np.abs(d_got - d_want), axis=1, initial=0.0)
    over = np.where(row_err > tol)[0]
    if over.size:
        i = over[0]
        raise AssertionError(f"row {i}: sorted neighbor distances differ by {row_err[i]} > "
                             f"tol {tol[i]} ({over.size} rows over)")
    rows = np.where((idx_got != idx_want).any(axis=1))[0]
    for i in rows:
        pos_want = {int(c): p for p, c in enumerate(idx_want[i])}
        pos_got = {int(c): p for p, c in enumerate(idx_got[i])}
        boundary = d_want[i, -1]
        for c in pos_want.keys() | pos_got.keys():
            if c in pos_want and c in pos_got:
                gap = abs(d_want[i, pos_want[c]] - d_want[i, pos_got[c]])
            else:  # in one list only: it must tie with the k-th distance
                d = d_want[i, pos_want[c]] if c in pos_want else d_got[i, pos_got[c]]
                gap = abs(d - boundary)
            if gap > tol[i]:
                raise AssertionError(
                    f"row {i}: neighbor {c} differs by {gap} > tol {tol[i]}, not a tie"
                )
    return rows


def dipcn_sets_differ(idx_got, idx_want, usable, n_nbr: int) -> np.ndarray:
    """[N] bool: rows whose dipCN inputs differ between two neighbor lists.

    dipCN depends on the lists only through two sets: the k nearest
    columns, and the first ``n_nbr`` usable columns among them in list
    order. Rows where both sets agree must give the same dipCN up to
    summation order, however ties were ordered inside the lists.
    """
    usable = np.asarray(usable, bool)

    def sets(idx):
        idx = np.asarray(idx)
        u = usable[idx]
        prefix = np.where(u & (np.cumsum(u, axis=1) <= n_nbr), idx, -1)
        return np.sort(idx, axis=1), np.sort(prefix, axis=1)

    (k_got, p_got), (k_want, p_want) = sets(idx_got), sets(idx_want)
    return (k_got != k_want).any(axis=1) | (p_got != p_want).any(axis=1)


def bf16_ulps(got, want) -> int:
    """The largest distance, in bfloat16 units in the last place, between
    two arrays of bfloat16 values (given as float32, float64 or bfloat16
    tensors' numpy float32 views): their bit patterns, ordered as
    integers, compared entry by entry; NaNs must sit in the same places."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    if not np.array_equal(np.isnan(got), np.isnan(want)):
        raise AssertionError("NaN positions differ")

    def ordered(a):  # the bf16 pattern as an integer that orders as the value
        bits = (a.view(np.uint32) >> 16).astype(np.int64)
        return np.where(bits & 0x8000, -(bits & 0x7FFF), bits)

    keep = ~np.isnan(want)
    if not keep.any():
        return 0
    return int(np.max(np.abs(ordered(got[keep]) - ordered(want[keep]))))


def equal_fraction(got, want) -> float:
    """The fraction of entries of two arrays exactly equal (NaN equal to
    NaN)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    same = (got == want) | (np.isnan(got) & np.isnan(want))
    return float(same.mean()) if same.size else 1.0


def bf16_gram_ratio(got, want) -> float:
    """The Gram rule of the bf16 contract as one number, at most 1 where it
    holds: the largest |got - want| over max(BF16_ULPS bf16 ulps of the
    entry, BF16_GRAM_FLOOR * max|want|)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    ulp = np.spacing(np.abs(want).astype(np.float32)).astype(np.float64) * 2.0 ** 16
    allowed = np.maximum(BF16_ULPS * ulp, BF16_GRAM_FLOOR * float(np.max(np.abs(want),
                                                                          initial=0.0)))
    allowed = np.where(allowed > 0, allowed, np.finfo(np.float64).tiny)
    return float(np.max(np.abs(got - want) / allowed, initial=0.0))
