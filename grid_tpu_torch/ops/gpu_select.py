"""Threshold dipCN as one CUDA kernel (``csrc/dipcn_select.cu``).

Replaces ``grid_tpu/ops/pallas_select.py:dipcn_from_distances_pallas``
(``pallas_call`` at line 130). Its plain version is
:func:`grid_tpu_torch.ops.select.dipcn_from_distances`; the wrapper runs it
for CPU tensors only. The kernel selects the same sets by another algorithm
(a histogram radix select from each row's own key range, a one-scan tie
cut, and a second select on the compacted usable k-set); see its source.
It has two modes: the row's keys in shared memory, or, for rows wider than
that holds (the row panels of the large-N branch), in device memory.

:func:`dipcn_from_distances_multi_gpu` launches the kernel's multi-weight
form for the multi-locus sweep: one take-set per row, L loci's sums over
it. Its plain version is
:func:`grid_tpu_torch.ops.select.dipcn_from_distances_multi`.
:func:`dipcn_multi_panels_gpu` runs it on the row panels of the
prepared z, beside the Gram panel kernel.

:func:`sorted_smallest_k_gpu` launches ``csrc/knn_select.cu``: each row's
k smallest entries, ascending, ties to the lower column. It replaces the
XLA selections of ``grid_tpu``'s cohort step (``approx_max_k`` at
``grid_tpu/models/cohort.py:189``, the two-stage ``top_k`` of
``grid_tpu/ops/knn.py:168-199``, the ring merge's ``top_k`` at
``grid_tpu/parallel/pknn.py:84``); its plain version is
:func:`grid_tpu_torch.ops.knn.sorted_smallest_k`, a stable sort.

Both kernels take float32 or float64 rows (``device.dtype``), in every
form: the float64 forms are the same kernels at int64 keys (the ``*_f64``
entry points of their sources), chosen by the dtype of ``d2``. bfloat16
rows take the bf16 forms (the ``*_bf16`` entry points) of ``knn_select``
and of ``dipcn_select``'s binary form: the rows stored as their 16-bit
patterns, the keys int16 as ``grid_tpu`` takes them; the multi-weight form
has none (the multi-locus sweep computes in float32 under bfloat16).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from grid_tpu_torch import native
from grid_tpu_torch.ops.gpu_kernels import zprep_split
from grid_tpu_torch.ops.knn import d2_panels, sorted_smallest_k
from grid_tpu_torch.ops.select import dipcn_from_distances, dipcn_from_distances_multi


MODES = ("resident", "wide")  # the kernel's modes, by the number it takes


@functools.cache
def _lib():
    lib = native.load("dipcn_select")
    lib.dipcn_select_launch.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 3)
    lib.dipcn_select_launch.restype = ctypes.c_int
    lib.dipcn_select_multi_launch.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 3)
    lib.dipcn_select_multi_launch.restype = ctypes.c_int
    lib.dipcn_select_mode.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    lib.dipcn_select_mode.restype = ctypes.c_int
    lib.dipcn_select_info.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
    lib.dipcn_select_info.restype = ctypes.c_int
    for name, suffixes in (("launch", ("_f64", "_bf16")), ("multi_launch", ("_f64",)),
                           ("mode", ("_f64", "_bf16")), ("info", ("_f64", "_bf16"))):
        for suffix in suffixes:
            form = getattr(lib, f"dipcn_select_{name}{suffix}")
            form.argtypes = getattr(lib, f"dipcn_select_{name}").argtypes
            form.restype = ctypes.c_int
    return lib


@functools.cache
def _knn_lib():
    lib = native.load("knn_select")
    lib.knn_select_launch.argtypes = (
        [ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3)
    lib.knn_select_launch.restype = ctypes.c_int
    lib.knn_select_mode.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)] * 2
    lib.knn_select_mode.restype = ctypes.c_int
    lib.knn_select_info.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
    lib.knn_select_info.restype = ctypes.c_int
    for name in ("launch", "mode", "info"):
        for suffix in ("_f64", "_bf16"):
            form = getattr(lib, f"knn_select_{name}{suffix}")
            form.argtypes = getattr(lib, f"knn_select_{name}").argtypes
            form.restype = ctypes.c_int
    return lib


_INFO_KEYS = ("threads", "smem_bytes", "static_smem_bytes", "blocks_per_sm", "registers",
              "spill_bytes")


# the largest k each form of knn_select takes (its list of 8-byte entries in
# float32, of 16-byte pairs in float64, fills 128 KB of a block; bfloat16's
# 4-byte entries are float32's limit)
KNN_MAX_K = {torch.float32: 16384, torch.float64: 8192, torch.bfloat16: 16384}
# the widest bfloat16 row knn_select takes: a list entry's 17-bit column
KNN_BF16_MAX_W = 1 << 17


def _device_index(device: torch.device) -> int:
    return device.index if device.index is not None else torch.cuda.current_device()


def dipcn_select_mode(w: int, k: int, device: torch.device,
                      dtype: torch.dtype = torch.float32) -> str | None:
    """The mode the kernel (either form) takes rows of ``w`` columns of
    ``dtype`` in at this ``k`` on the CUDA ``device``: "resident" (the
    row's keys in shared memory) where that fits and at least 4 of its
    blocks fit an SM, else "wide" (the keys stay in device memory), or None
    where neither fits. The keys' size moves the edge: ~12,000 float32
    columns at k=500 on an H100, about half that in float64, twice that in
    bfloat16."""
    mode = _dipcn_mode_on(w, k, _device_index(device), native.dtype_suffix(dtype, bf16=True))
    return MODES[mode] if mode >= 0 else None


@functools.cache
def _dipcn_mode_on(w: int, k: int, index: int, suffix: str) -> int:
    """:func:`dipcn_select_mode`'s number on card ``index`` (``suffix``
    the form's), asked once, as :func:`_knn_mode_on`: the answer depends on
    the card alone, and its occupancy queries cost the host more than a
    resident launch."""
    mode = ctypes.c_int()
    fn = getattr(_lib(), f"dipcn_select_mode{suffix}")
    with torch.cuda.device(index):
        err = fn(index, w, k, ctypes.byref(mode))
    native.check_launch("dipcn_select", err)
    return mode.value


def dipcn_select_info(w: int, k: int, device: torch.device, multi: bool = False,
                      dtype: torch.dtype = torch.float32, mode: str | None = None) -> dict:
    """The kernel's launch shape (of its multi-weight form when ``multi``;
    of its float64 or bfloat16 form for that ``dtype``; bfloat16 has no
    multi-weight form) for rows of ``w`` columns at
    this ``k`` on the CUDA ``device``, in ``mode`` (default: the one
    :func:`dipcn_select_mode` picks): its mode, threads, dynamic and static
    shared memory per block, resident blocks per SM (0 where the mode does
    not take rows of ``w`` columns or its shared memory does not fit),
    registers and local (spill) bytes per thread."""
    if multi:
        native.dtype_suffix(dtype)  # the multi-weight form: float32 or float64
    mode = mode or dipcn_select_mode(w, k, device, dtype)
    if mode is None:
        raise ValueError(f"no mode of dipcn_select takes rows of {w} columns at k={k}")
    out = (ctypes.c_int * len(_INFO_KEYS))()
    fn = getattr(_lib(), f"dipcn_select_info{native.dtype_suffix(dtype, bf16=True)}")
    with torch.cuda.device(device):
        native.check_launch("dipcn_select", fn(MODES.index(mode), int(multi), w, k, out))
    return {"mode": mode, **dict(zip(_INFO_KEYS, out))}


def dipcn_from_distances_gpu(d2, rnorm, nbr_w, col_usable, sample_valid, k: int, n_nbr: int):
    """dipCN from the [N, W] distance matrix; same contract as
    :func:`grid_tpu_torch.ops.select.dipcn_from_distances` and as the Pallas
    kernel (float32, float64 or bfloat16 on the card: d2, rnorm and nbr_w
    of one dtype; float64 sums and keys in the float64 form; in bfloat16
    int16 keys and a float32 sum rounded as ``grid_tpu`` rounds it).

    One thread block per row. Where the row's keys, its usable bits and its
    compacted usable k-set fit in the block's shared memory with at least 4
    blocks an SM (up to ~12,000 float32 columns at k=500 on an H100), the
    distance matrix crosses device memory once; wider rows (the
    65,536-column panels of the large-N branch, up to ~1.7 M columns at
    k=500) keep their keys in device memory and re-read them
    (:func:`dipcn_select_mode`). Raises where neither mode fits.

    Returns (dipcn [N] in d2's dtype, out_valid [N] bool).
    """
    if not native.on_cuda(d2, rnorm, nbr_w, col_usable, sample_valid):
        return dipcn_from_distances(d2, rnorm, nbr_w, col_usable, sample_valid, k=k, n_nbr=n_nbr)
    n, w = d2.shape
    native.dtype_suffix(d2.dtype, bf16=True)
    native.check(d2, "d2", d2.dtype, (n, w))
    native.check(rnorm, "rnorm", d2.dtype, (n,))
    native.check(nbr_w, "nbr_w", d2.dtype, (w,))
    native.check(col_usable, "col_usable", torch.bool, (w,))
    native.check(sample_valid, "sample_valid", torch.bool, (n,))
    if not 1 <= k <= w:
        raise ValueError(f"k={k} must be in [1, {w}]")
    if n_nbr < 1:
        raise ValueError(f"n_nbr={n_nbr} must be >= 1")
    mode = dipcn_select_mode(w, k, d2.device, d2.dtype)
    if mode is None:
        raise ValueError(f"d2 rows of {w} columns at k={k} fit no mode of the kernel")
    return _launch(mode, d2, rnorm, nbr_w, col_usable, sample_valid, k, n_nbr)


def _launch(mode: str, d2, rnorm, nbr_w, col_usable, sample_valid, k: int, n_nbr: int):
    """Launch the kernel in ``mode`` on checked inputs (its float64 form for
    float64 d2). The wrapper picks the mode; the card tests also run the
    wide mode where both fit."""
    n, w = d2.shape
    dipcn = torch.empty(n, dtype=d2.dtype, device=d2.device)
    ok = torch.empty(n, dtype=torch.bool, device=d2.device)
    launch = getattr(_lib(), f"dipcn_select_launch{native.dtype_suffix(d2.dtype, bf16=True)}")
    with torch.cuda.device(d2.device):
        err = launch(
            d2.data_ptr(), rnorm.data_ptr(), nbr_w.data_ptr(), col_usable.data_ptr(),
            sample_valid.data_ptr(), n, w, k, n_nbr, MODES.index(mode), dipcn.data_ptr(),
            ok.data_ptr(), native.stream_ptr(d2.device))
    native.check_launch("dipcn_select", err)
    native.count_launch(dipcn_from_distances_gpu)
    return dipcn, ok


dipcn_from_distances_gpu.launches = 0


def dipcn_from_distances_multi_gpu(d2, rnorm, nbr_w, col_usable, sample_valid, k: int,
                                   n_nbr: int):
    """dipCN of L loci from one [N, W] distance matrix; same contract as
    :func:`grid_tpu_torch.ops.select.dipcn_from_distances_multi` (float32
    or float64 on the card: d2, rnorm and nbr_w of one dtype).

    The kernel's multi-weight form: each row's take-set is found once, as
    in :func:`dipcn_from_distances_gpu` and in the same mode, then its
    threads stride over the L loci and sum ``nbr_w`` [W, L] over the
    take-set's columns in a fixed order, in float64 in both dtypes.

    Args:
        d2: [N, W] distances; rnorm, sample_valid: [N, L];
        nbr_w: [W, L]; col_usable: [W], shared by the L loci.

    Returns (dipcn [N, L] in d2's dtype, out_valid [N, L] bool).
    """
    if not native.on_cuda(d2, rnorm, nbr_w, col_usable, sample_valid):
        return dipcn_from_distances_multi(d2, rnorm, nbr_w, col_usable, sample_valid, k=k,
                                          n_nbr=n_nbr)
    n, w = d2.shape
    if rnorm.dim() != 2 or rnorm.shape[1] < 1:
        raise ValueError(f"rnorm: expected [N, L] with L >= 1, got {tuple(rnorm.shape)}")
    n_loci = rnorm.shape[1]
    native.dtype_suffix(d2.dtype)
    native.check(d2, "d2", d2.dtype, (n, w))
    native.check(rnorm, "rnorm", d2.dtype, (n, n_loci))
    native.check(nbr_w, "nbr_w", d2.dtype, (w, n_loci))
    native.check(col_usable, "col_usable", torch.bool, (w,))
    native.check(sample_valid, "sample_valid", torch.bool, (n, n_loci))
    if not 1 <= k <= w:
        raise ValueError(f"k={k} must be in [1, {w}]")
    if n_nbr < 1:
        raise ValueError(f"n_nbr={n_nbr} must be >= 1")
    mode = dipcn_select_mode(w, k, d2.device, d2.dtype)
    if mode is None:
        raise ValueError(f"d2 rows of {w} columns at k={k} fit no mode of the kernel")
    return _launch_multi(mode, d2, rnorm, nbr_w, col_usable, sample_valid, k, n_nbr)


def _launch_multi(mode: str, d2, rnorm, nbr_w, col_usable, sample_valid, k: int, n_nbr: int):
    """Launch the multi-weight form in ``mode`` on checked inputs (its
    float64 form for float64 d2)."""
    (n, w), n_loci = d2.shape, rnorm.shape[1]
    dipcn = torch.empty((n, n_loci), dtype=d2.dtype, device=d2.device)
    ok = torch.empty((n, n_loci), dtype=torch.bool, device=d2.device)
    launch = getattr(_lib(), f"dipcn_select_multi_launch{native.dtype_suffix(d2.dtype)}")
    with torch.cuda.device(d2.device):
        err = launch(
            d2.data_ptr(), rnorm.data_ptr(), nbr_w.data_ptr(), col_usable.data_ptr(),
            sample_valid.data_ptr(), n, w, n_loci, k, n_nbr, MODES.index(mode),
            dipcn.data_ptr(), ok.data_ptr(), native.stream_ptr(d2.device))
    native.check_launch("dipcn_select", err)
    native.count_launch(dipcn_from_distances_multi_gpu)
    return dipcn, ok


dipcn_from_distances_multi_gpu.launches = 0


def dipcn_multi_panels_gpu(zp, rnorm, nbr_w, col_usable, sample_valid, k: int, n_nbr: int,
                           row_block: int = 512, row_valid=None):
    """The multi-locus form of
    :func:`grid_tpu_torch.ops.select.dipcn_from_distances_panels` through
    the kernels: one ``zprep_split`` of the prepared z (no mask, no clip),
    then per row panel ``zprep_gram_panel`` and its distances
    (``ops.knn.d2_panels``) and one :func:`dipcn_from_distances_multi_gpu`,
    all in zp's dtype (float64 zp: the FP64 split and panels, the distances
    and the multi kernel in float64). Never holds an [N, N] tensor:
    O(row_block * N + N * L) memory. The arguments are the plain form's;
    CPU tensors take the wrappers' plain versions.

    Returns (dipcn [N, L], out_valid [N, L]).
    """
    geom = (sample_valid.any(dim=1) if row_valid is None else row_valid).to(torch.bool)
    split = zprep_split(zp, None, None, math.inf)
    dips, oks = [], []
    for i0, d2 in d2_panels(split, row_block, geom):
        rows = slice(i0, i0 + d2.shape[0])
        dip, ok = dipcn_from_distances_multi_gpu(d2, rnorm[rows], nbr_w, col_usable,
                                                 sample_valid[rows], k=k, n_nbr=n_nbr)
        del d2
        dips.append(dip)
        oks.append(ok)
    return torch.cat(dips), torch.cat(oks)


_KNN_INFO_KEYS = (*_INFO_KEYS, "cluster_blocks", "clusters", "slice")


def _knn_mode(w: int, k: int, device: torch.device, dtype: torch.dtype) -> tuple:
    """(mode number, cluster size) the kernel takes rows of ``w`` columns
    of ``dtype`` in at this ``k``; mode -1 where none fits."""
    return _knn_mode_on(w, k, _device_index(device), native.dtype_suffix(dtype, bf16=True))


@functools.cache
def _knn_mode_on(w: int, k: int, index: int, suffix: str) -> tuple:
    """:func:`_knn_mode` on card ``index`` (``suffix`` "_f64" for the
    float64 form), asked once: the answer depends on the card alone, and
    the occupancy queries cost the host more than the resident launch they
    pick."""
    mode, cluster = ctypes.c_int(), ctypes.c_int()
    fn = getattr(_knn_lib(), f"knn_select_mode{suffix}")
    with torch.cuda.device(index):
        err = fn(index, w, k, ctypes.byref(mode), ctypes.byref(cluster))
    native.check_launch("knn_select", err)
    return mode.value, cluster.value


def knn_select_mode(w: int, k: int, device: torch.device,
                    dtype: torch.dtype = torch.float32) -> str | None:
    """The mode ``knn_select`` takes rows of ``w`` columns of ``dtype`` in at
    this ``k`` on the CUDA ``device``: "resident" (one block a row, the
    row's keys in its shared memory), "cluster" (a cluster of 2-8 blocks a
    row, each block a slice of the keys in its shared memory; the panels'
    65,536 columns take 8; float32 only) whenever the slices fit and a
    cluster can be scheduled, else "wide" (one block a row, the keys stay
    in device memory; past 448,192 float32 columns at k=500 on an H100, past
    8,192 float64 ones; it takes every k up to ``KNN_MAX_K``, at any width),
    or None where none fits."""
    mode, cluster = _knn_mode(w, k, device, dtype)
    if mode < 0:
        return None
    return "wide" if mode == 1 else ("resident" if cluster == 1 else "cluster")


def knn_select_info(w: int, k: int, device: torch.device, mode: str | None = None,
                    dtype: torch.dtype = torch.float32) -> dict:
    """``knn_select``'s launch shape for rows of ``w`` columns of ``dtype``
    at this ``k`` on the CUDA ``device``, in ``mode`` (default: the one
    :func:`knn_select_mode` picks; "resident" and "cluster" are the shared
    mode over the cluster size ``w`` picks): its threads, dynamic and
    static shared memory per block,
    resident blocks per SM, registers and local (spill) bytes per thread,
    blocks a cluster, clusters the card holds at once (0 where the blocks'
    shared memory does not fit) and columns a block."""
    mode = mode or knn_select_mode(w, k, device, dtype)
    if mode is None:
        raise ValueError(f"no mode of knn_select takes rows of {w} columns at k={k}")
    out = (ctypes.c_int * len(_KNN_INFO_KEYS))()
    fn = getattr(_knn_lib(), f"knn_select_info{native.dtype_suffix(dtype, bf16=True)}")
    with torch.cuda.device(device):
        native.check_launch("knn_select",
                            fn(_device_index(device), _knn_mode_number(mode), w, k, out))
    return {"mode": mode, **dict(zip(_KNN_INFO_KEYS, out))}


def _knn_mode_number(mode: str) -> int:
    """The kernel's mode number of a mode's name: 0 (shared) for "resident"
    and "cluster", 1 for "wide"."""
    if mode == "wide":
        return 1
    if mode in ("resident", "cluster"):
        return 0
    raise ValueError(f"unknown knn_select mode {mode!r}")


def sorted_smallest_k_gpu(d2, k: int):
    """The k smallest entries of each row of ``d2``, ascending, with their
    columns, ties to the lower column; the contract of
    :func:`grid_tpu_torch.ops.knn.sorted_smallest_k` (stable-argsort
    order), which CPU tensors take.

    On the card: float32, float64 or bfloat16 [B, W] rows, contiguous,
    non-negative (finfo.max or larger for excluded columns; -0.0 is not
    expected), 1 <= k <= W, k <= ``KNN_MAX_K`` (16,384 in float32 and
    bfloat16, 8,192 in float64; bfloat16 rows of at most 131,072 columns).
    A row is split over a cluster of 1-8 blocks (float64: 1), each holding
    its slice of the keys in shared memory (one bulk copy: the row crosses
    device memory once): a histogram radix select of the k-th value with
    the blocks' histograms summed through distributed shared memory, one
    walk that places the entries below it and the first ties in column
    order into the leading block's list, and a bitonic sort of those k
    there, in registers and shuffles but for its widest strides. Rows too
    wide for 8 blocks (float64: for one) keep their keys in device memory
    and re-read them (:func:`knn_select_mode`). Raises where no mode fits.

    Returns (vals [B, k] in d2's dtype, idx [B, k] int32).
    """
    if not native.on_cuda(d2):
        return sorted_smallest_k(d2, k)
    if d2.dim() != 2:
        raise ValueError(f"d2: expected [B, W], got {tuple(d2.shape)}")
    n, w = d2.shape
    native.dtype_suffix(d2.dtype, bf16=True)
    native.check(d2, "d2", d2.dtype, (n, w))
    if not 1 <= k <= w:
        raise ValueError(f"k={k} must be in [1, {w}]")
    if d2.dtype == torch.bfloat16 and w > KNN_BF16_MAX_W:
        raise ValueError(f"knn_select takes bfloat16 rows of at most {KNN_BF16_MAX_W} columns, "
                         f"got {w}")
    if k > KNN_MAX_K[d2.dtype]:
        raise ValueError(f"k={k}: knn_select takes k <= {KNN_MAX_K[d2.dtype]} in {d2.dtype}")
    mode = knn_select_mode(w, k, d2.device, d2.dtype)
    if mode is None:
        raise ValueError(f"d2 rows of {w} columns at k={k} fit no mode of knn_select")
    return _knn_launch(mode, d2, k)


def _knn_launch(mode: str, d2, k: int):
    """Launch ``knn_select`` in ``mode`` on a checked ``d2``. The wrapper
    picks the mode; the card tests also run the wide mode beside it."""
    n, w = d2.shape
    number = _knn_mode_number(mode)
    vals = torch.empty((n, k), dtype=d2.dtype, device=d2.device)
    idx = torch.empty((n, k), dtype=torch.int32, device=d2.device)
    if n == 0:
        return vals, idx
    launch = getattr(_knn_lib(), f"knn_select_launch{native.dtype_suffix(d2.dtype, bf16=True)}")
    with torch.cuda.device(d2.device):
        err = launch(d2.data_ptr(), n, w, k, number, vals.data_ptr(), idx.data_ptr(),
                     native.stream_ptr(d2.device))
    native.check_launch("knn_select", err)
    native.count_launch(sorted_smallest_k_gpu)
    return vals, idx


sorted_smallest_k_gpu.launches = 0
