"""PBWT-based IBS haplotype-neighbor search (numpy reference core; copy of
``grid_tpu/ops/pbwt.py``).

The reference's step 7 requires an IBS neighbor file produced by
``computeIBSpbwt``, an *external* C++ tool the reference does not ship —
users must obtain supplementary sources and build them against Eagle
headers + Boost (ref: docs/source/ibs_ibd.rst:14-19,26-90). grid_tpu
implements the capability natively so the pipeline is self-contained from
phased genotypes to haploid copy numbers.

This module is the algorithmic core in pure numpy; a multithreaded C++
twin lives in ``grid_tpu_torch/csrc/host/ibs.cpp`` (bitpacked haplotypes). Both
implement the exact same contract and tie-breaking so they are
interchangeable and cross-checked in tests.

Contract (documented in docs/ibs_ibd.md):

- Input: ``H`` binary haplotype matrix ``[n_hap, M]`` (rows ``2*i`` and
  ``2*i+1`` are the two haplotypes of sample ``i``), ascending genetic-map
  positions ``cm[M]``, focal site index ``f`` (first site at/after the
  focal bp) and interpolated ``focal_cm``.
- Left extent of a pair: the largest ``a`` with ``H[x, f-a:f] ==
  H[y, f-a:f]``; in cM, ``focal_cm - cm[f-a]`` (0 when ``a == 0``).
- Right extent: largest ``b`` with ``H[x, f:f+b] == H[y, f:f+b]``; in cM,
  ``cm[f+b-1] - focal_cm`` (0 when ``b == 0``).
- Score ``cMlen = left + right``; ``cMedge = min(left, right)`` — the
  columns hi_inference's IBS loader reads (grid/utils/hi_inference.py:38-43).
- Ranking: ``cMlen`` desc, ties by total site extent desc, then
  ``min(a, b)`` site extent desc, then neighbor haplotype index asc.
- A sample's own other haplotype is never a neighbor (phasing would be
  circular).

Search: one PBWT pass left of the focal point and one (reversed) right of
it give, at the focal boundary, orderings in which haplotypes sharing long
one-sided matches are adjacent (Durbin 2014, PBWT). Expanding outward from
a haplotype's position enumerates candidates in non-increasing one-sided
extent, so a Fagin threshold merge of the two orderings finds the exact
top-k by two-sided length: stop once the k-th best found total exceeds the
sum of the current per-side bounds (or either side is fully enumerated).
``max_scan`` caps per-side expansion for degenerate panels; within the cap
results are exact, beyond it best-effort (tests run uncapped).
"""

from __future__ import annotations

import heapq

import numpy as np

__all__ = ["pbwt_order", "pbwt_ibs_neighbors"]


def pbwt_order(H: np.ndarray):
    """Positional prefix ordering + divergence after the last column.

    Runs Durbin's PBWT over the columns of ``H [n_hap, L]`` and returns
    ``(a, d)``: ``a`` is the haplotype order sorted by reversed prefix
    ending at the last column; ``d[i]`` is the smallest site index s such
    that haplotypes ``a[i]`` and ``a[i-1]`` agree on ``[s, L)`` (``d == L``
    means no match; ``d[0] == L`` by convention).

    Column update is vectorized (stable partition + segment maxima via
    ``np.maximum.reduceat``), O(n_hap) numpy work per column.
    """
    n_hap, L = H.shape
    a = np.arange(n_hap, dtype=np.int64)
    d = np.zeros(n_hap, dtype=np.int64)
    d[0] = 0  # becomes the sentinel below on the first column
    for j in range(L):
        y = H[a, j]
        idx0 = np.flatnonzero(y == 0)
        idx1 = np.flatnonzero(y != 0)
        sentinel = j + 1

        def group_div(idx):
            if idx.size == 0:
                return np.empty(0, dtype=np.int64)
            out = np.empty(idx.size, dtype=np.int64)
            out[0] = max(sentinel, int(np.max(d[: idx[0] + 1])))
            if idx.size > 1:
                # segment t covers input positions (idx[t-1], idx[t]]
                out[1:] = np.maximum.reduceat(d[: idx[-1] + 1], idx[:-1] + 1)
            return out

        d = np.concatenate([group_div(idx0), group_div(idx1)])
        a = np.concatenate([a[idx0], a[idx1]])
    # First entry has no predecessor: force the no-match sentinel.
    if n_hap:
        d[0] = L
    return a, d


def _direct_extents(H, x, y, f):
    """Exact (left, right) site extents of the IBS match of x,y around f."""
    left = H[x, :f][::-1] != H[y, :f][::-1]
    if left.size and left.any():
        a = int(np.argmax(left))
    else:
        a = int(left.size)
    right = H[x, f:] != H[y, f:]
    if right.size and right.any():
        b = int(np.argmax(right))
    else:
        b = int(right.size)
    return a, b


class _Expander:
    """Enumerate candidates around position ``p`` of one PBWT ordering in
    non-increasing one-sided match extent (skipping same-sample rows)."""

    def __init__(self, a, d, inv, h, L):
        self.a = a
        self.d = d
        self.L = L
        self.up = int(inv[h])
        self.dn = int(inv[h])
        self.s_up = 0
        self.s_dn = 0
        self.mate = h ^ 1
        self.n = len(a)

    def next(self):
        """(hap, extent_sites) of the next-best candidate, or None."""
        while True:
            can_up = self.up > 0
            can_dn = self.dn < self.n - 1
            if not can_up and not can_dn:
                return None
            s_up_next = max(self.s_up, int(self.d[self.up])) if can_up else self.L
            s_dn_next = max(self.s_dn, int(self.d[self.dn + 1])) if can_dn else self.L
            # Smaller match start = longer extent; tie goes up.
            if can_up and (not can_dn or s_up_next <= s_dn_next):
                self.s_up = s_up_next
                self.up -= 1
                cand = int(self.a[self.up])
                ext = self.L - s_up_next
            else:
                self.s_dn = s_dn_next
                self.dn += 1
                cand = int(self.a[self.dn])
                ext = self.L - s_dn_next
            if cand != self.mate:
                return cand, ext


def pbwt_ibs_neighbors(H, cm, focal, focal_cm, k, max_scan=None):
    """Top-``k`` IBS neighbors of every haplotype around the focal site.

    Args:
      H: uint8 ``[n_hap, M]`` phased alleles (0/1), sample ``i`` owns rows
        ``2*i`` and ``2*i+1``.
      cm: float64 ``[M]`` ascending genetic-map positions.
      focal: site index ``f`` — the first site at/after the focal bp.
      focal_cm: genetic position of the focal bp (``cm[f-1] <= focal_cm
        <= cm[f]`` when interior).
      k: neighbors per haplotype.
      max_scan: per-side expansion cap (default ``max(4*k, k+64)``).

    Returns ``(idx, cmlen, cmedge, count)``: int32 ``[n_hap, k]`` neighbor
    haplotype indices (-1 padding), float64 cM lengths/edges, and int32
    ``[n_hap]`` valid counts.
    """
    H = np.ascontiguousarray(H, dtype=np.uint8)
    cm = np.asarray(cm, dtype=np.float64)
    n_hap, M = H.shape
    f = int(focal)
    if not 0 <= f <= M:
        raise ValueError(f"focal index {f} outside [0, {M}]")
    if max_scan is None:
        max_scan = max(4 * k, k + 64)

    aL, dL = pbwt_order(H[:, :f])
    aR, dR = pbwt_order(H[:, f:][:, ::-1])
    invL = np.empty(n_hap, dtype=np.int64)
    invL[aL] = np.arange(n_hap)
    invR = np.empty(n_hap, dtype=np.int64)
    invR[aR] = np.arange(n_hap)
    Lf, Rf = f, M - f

    def left_cm(a):
        return focal_cm - cm[f - a] if a > 0 else 0.0

    def right_cm(b):
        return cm[f + b - 1] - focal_cm if b > 0 else 0.0

    idx = np.full((n_hap, k), -1, dtype=np.int32)
    out_len = np.zeros((n_hap, k), dtype=np.float64)
    out_edge = np.zeros((n_hap, k), dtype=np.float64)
    count = np.zeros(n_hap, dtype=np.int32)
    n_capped = 0  # haplotypes whose expansion hit max_scan pre-threshold

    for h in range(n_hap):
        gl = _Expander(aL, dL, invL, h, Lf)
        gr = _Expander(aR, dR, invR, h, Rf)
        seen: dict[int, tuple[int, int]] = {}
        heap: list[float] = []  # k largest totals (min-heap)
        bound_l = np.inf
        bound_r = np.inf
        popped_l = popped_r = 0
        exhausted = False
        while True:
            progressed = False
            if popped_l < max_scan:
                item = gl.next()
                if item is None:
                    exhausted = True
                else:
                    y, ext = item
                    popped_l += 1
                    progressed = True
                    bound_l = left_cm(ext)
                    if y not in seen:
                        ab = _direct_extents(H, h, y, f)
                        seen[y] = ab
                        total = left_cm(ab[0]) + right_cm(ab[1])
                        if len(heap) < k:
                            heapq.heappush(heap, total)
                        elif total > heap[0]:
                            heapq.heapreplace(heap, total)
            if popped_r < max_scan:
                item = gr.next()
                if item is None:
                    exhausted = True
                else:
                    y, ext = item
                    popped_r += 1
                    progressed = True
                    bound_r = right_cm(ext)
                    if y not in seen:
                        ab = _direct_extents(H, h, y, f)
                        seen[y] = ab
                        total = left_cm(ab[0]) + right_cm(ab[1])
                        if len(heap) < k:
                            heapq.heappush(heap, total)
                        elif total > heap[0]:
                            heapq.heapreplace(heap, total)
            if exhausted or not progressed:
                if not exhausted:  # both sides capped before the Fagin
                    n_capped += 1  # threshold fired: top-k is best-effort
                break
            if len(heap) >= k and heap[0] > bound_l + bound_r:
                break

        ranked = sorted(
            seen.items(),
            key=lambda it: (
                -(left_cm(it[1][0]) + right_cm(it[1][1])),
                -(it[1][0] + it[1][1]),
                -min(it[1][0], it[1][1]),
                it[0],
            ),
        )[:k]
        count[h] = len(ranked)
        for r, (y, (a, b)) in enumerate(ranked):
            idx[h, r] = y
            lcm, rcm = left_cm(a), right_cm(b)
            out_len[h, r] = lcm + rcm
            out_edge[h, r] = min(lcm, rcm)
    if n_capped:
        import logging

        logging.getLogger(__name__).warning(
            "pbwt_ibs_neighbors: max_scan=%d terminated expansion before the "
            "Fagin threshold for %d/%d haplotypes — top-k is best-effort "
            "there; raise max_scan (compute_ibs.max_scan / ibs --max-scan) "
            "for exact results",
            max_scan, n_capped, n_hap,
        )
    return idx, out_len, out_edge, count
