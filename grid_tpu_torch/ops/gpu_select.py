"""Threshold dipCN as one CUDA kernel (``csrc/dipcn_select.cu``).

Replaces ``grid_tpu/ops/pallas_select.py:dipcn_from_distances_pallas``
(``pallas_call`` at line 130). Its plain version is
:func:`grid_tpu_torch.ops.select.dipcn_from_distances`; the wrapper runs it
for CPU tensors only. The kernel selects the same sets by another algorithm
(a histogram radix select from each row's own key range, a one-scan tie
cut, and a second select on the compacted usable k-set); see its source.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from grid_tpu_torch import native
from grid_tpu_torch.ops.select import dipcn_from_distances


@functools.cache
def _lib():
    lib = native.load("dipcn_select")
    launch = lib.dipcn_select_launch
    launch.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3
    launch.restype = ctypes.c_int
    max_cols = lib.dipcn_select_max_cols
    max_cols.argtypes = [ctypes.c_int]
    max_cols.restype = ctypes.c_int
    lib.dipcn_select_info.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    lib.dipcn_select_info.restype = ctypes.c_int
    return launch, max_cols


_INFO_KEYS = ("threads", "smem_bytes", "static_smem_bytes", "blocks_per_sm", "registers",
              "spill_bytes")


def dipcn_select_info(w: int, k: int, device: torch.device) -> dict:
    """The kernel's launch shape for rows of ``w`` columns at this ``k`` on
    the CUDA ``device``: threads, dynamic and static shared memory per
    block, resident blocks per SM, registers and local (spill) bytes per
    thread."""
    _lib()  # declares the argument types
    info = native.load("dipcn_select").dipcn_select_info
    out = (ctypes.c_int * len(_INFO_KEYS))()
    with torch.cuda.device(device):
        native.check_launch("dipcn_select", info(w, k, out))
    return dict(zip(_INFO_KEYS, out))


def dipcn_from_distances_gpu(d2, rnorm, nbr_w, col_usable, sample_valid, k: int, n_nbr: int):
    """dipCN from the [N, W] distance matrix; same contract as
    :func:`grid_tpu_torch.ops.select.dipcn_from_distances` and as the Pallas
    kernel (float32 only on the card).

    One thread block per row holds the row's keys, its usable bits and its
    compacted usable k-set in shared memory, so the distance matrix crosses
    device memory once. A row must fit in the block's shared memory (about
    37,000 float32 columns on an H100 at any k, past the 23,170 the default
    2 GB d2 budget admits); a wider one raises.

    Returns (dipcn [N] float32, out_valid [N] bool).
    """
    if not native.on_cuda(d2, rnorm, nbr_w, col_usable, sample_valid):
        return dipcn_from_distances(d2, rnorm, nbr_w, col_usable, sample_valid, k=k, n_nbr=n_nbr)
    n, w = d2.shape
    native.check(d2, "d2", torch.float32, (n, w))
    native.check(rnorm, "rnorm", torch.float32, (n,))
    native.check(nbr_w, "nbr_w", torch.float32, (w,))
    native.check(col_usable, "col_usable", torch.bool, (w,))
    native.check(sample_valid, "sample_valid", torch.bool, (n,))
    if not 1 <= k <= w:
        raise ValueError(f"k={k} must be in [1, {w}]")
    if n_nbr < 1:
        raise ValueError(f"n_nbr={n_nbr} must be >= 1")
    launch, max_cols = _lib()
    device_index = d2.device.index if d2.device.index is not None else torch.cuda.current_device()
    limit = max_cols(device_index)
    if w > limit:
        raise ValueError(f"d2 rows of {w} columns exceed the kernel's shared-memory limit of {limit}")
    dipcn = torch.empty(n, dtype=torch.float32, device=d2.device)
    ok = torch.empty(n, dtype=torch.bool, device=d2.device)
    with torch.cuda.device(d2.device):
        err = launch(d2.data_ptr(), rnorm.data_ptr(), nbr_w.data_ptr(), col_usable.data_ptr(),
                     sample_valid.data_ptr(), n, w, k, n_nbr, dipcn.data_ptr(), ok.data_ptr(),
                     native.stream_ptr(d2.device))
    native.check_launch("dipcn_select", err)
    dipcn_from_distances_gpu.launches += 1
    return dipcn, ok


dipcn_from_distances_gpu.launches = 0
