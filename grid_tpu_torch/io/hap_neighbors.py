"""Padded haplotype-neighbor tables (numpy only).

A copy of ``grid_tpu/io/hap_neighbors.py:pad_hap_neighbors``, so that the
port never imports ``grid_tpu`` (whose package import pulls in JAX).
"""

from __future__ import annotations

import numpy as np


def pad_hap_neighbors(hap_nbrs, max_nbr: int, dtype=np.float32):
    """Convert ragged hap_nbrs into fixed [2N, max_nbr] arrays.

    Returns (nbr_idx int32, nbr_w ``dtype``, nbr_valid bool). Padded slots get
    index 0 and weight 0 with valid=False; the phasing op masks them out, and
    the reference's 1e-9 wsum floor (grid/utils/hi_inference.py:209) makes an
    all-padding hap behave identically to an empty neighbor list.
    """
    two_n = len(hap_nbrs)
    nbr_idx = np.zeros((two_n, max_nbr), dtype=np.int32)
    nbr_w = np.zeros((two_n, max_nbr), dtype=dtype)
    nbr_valid = np.zeros((two_n, max_nbr), dtype=bool)
    for h, lst in enumerate(hap_nbrs):
        for k, (j, w) in enumerate(lst[:max_nbr]):
            nbr_idx[h, k] = j
            nbr_w[h, k] = w
            nbr_valid[h, k] = True
    return nbr_idx, nbr_w, nbr_valid
