"""ctypes wrapper of the host library's PBWT IBS neighbor engine (port of
``grid_tpu/native/ibs.py``)."""

from __future__ import annotations

import ctypes

import numpy as np

from grid_tpu_torch.native_host import require


def pbwt_ibs_neighbors(H, cm, focal, focal_cm, k, max_scan=None, threads=1):
    """Multithreaded C++ twin of :func:`grid_tpu_torch.ops.pbwt.pbwt_ibs_neighbors`:
    the same contract, tie-breaking and outputs. Raises RuntimeError where
    the host library is not loaded, ValueError on a failed call."""
    lib = require()
    H = np.ascontiguousarray(H, dtype=np.uint8)
    cm = np.ascontiguousarray(cm, dtype=np.float64)
    n_hap, m = H.shape
    if cm.shape != (m,):
        raise ValueError(f"cm has shape {cm.shape}, expected ({m},)")
    if max_scan is None:
        max_scan = max(4 * k, k + 64)

    idx = np.full((n_hap, k), -1, dtype=np.int32)
    out_len = np.zeros((n_hap, k), dtype=np.float64)
    out_edge = np.zeros((n_hap, k), dtype=np.float64)
    count = np.zeros(n_hap, dtype=np.int32)

    c = ctypes
    rc = lib.grid_ibs_neighbors(
        H.ctypes.data_as(c.POINTER(c.c_uint8)), n_hap, m,
        cm.ctypes.data_as(c.POINTER(c.c_double)), int(focal), float(focal_cm), int(k),
        int(max_scan), int(threads),
        idx.ctypes.data_as(c.POINTER(c.c_int32)),
        out_len.ctypes.data_as(c.POINTER(c.c_double)),
        out_edge.ctypes.data_as(c.POINTER(c.c_double)),
        count.ctypes.data_as(c.POINTER(c.c_int32)),
    )
    if rc != 0:
        raise ValueError(f"grid_ibs_neighbors failed with code {rc}")
    return idx, out_len, out_edge, count
