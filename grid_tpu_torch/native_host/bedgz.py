"""ctypes wrappers of the host library's regions.bed.gz readers (port of
``grid_tpu/native/bedgz.py``). ctypes releases the interpreter lock for the
call, so threads scan files in parallel; the C++ side keeps one
decompressor per thread.

Each reader raises :class:`NativeReadError` when the library returns a
non-zero code: -1 the file did not open, -2 it is corrupt or truncated, -3
the reader ran out of memory.
"""

from __future__ import annotations

import ctypes

import numpy as np

from grid_tpu_torch import native_host


class NativeReadError(OSError):
    """The native reader returned a non-zero code for one file."""

    def __init__(self, function: str, path, code: int):
        super().__init__(f"{function}({path}) failed with code {code}")
        self.code = code


def _array(ptr, n: int, dtype) -> np.ndarray:
    return np.ctypeslib.as_array(ptr, shape=(n,)).copy() if n else np.empty(0, dtype)


def _mask_args(excluded):
    """The repeat mask as the C ABI takes it: NUL-separated chromosome
    names, their count, offsets into the kb bins, and the bins (each
    chromosome's sorted)."""
    c = ctypes
    excluded = excluded or {}
    names = b""
    kb_all: list[int] = []
    offsets = [0]
    for chrom_name, kbs in excluded.items():
        names += chrom_name.encode() + b"\0"
        kb_all.extend(sorted(kbs))
        offsets.append(len(kb_all))
    offsets_arr = (c.c_int64 * len(offsets))(*offsets)
    kb_arr = (c.c_int64 * max(len(kb_all), 1))(*(kb_all or [0]))
    return names, len(excluded), offsets_arr, kb_arr


def read_regions_bed_gz(path, chromosome=None, start=None, end=None, excluded=None):
    """Native twin of :func:`grid_tpu_torch.io.bed.read_regions_bed_gz`.
    Returns (starts int64, ends int64, depths float64) numpy arrays."""
    lib = native_host.require()
    c = ctypes
    chrom_filter = None
    if chromosome:
        chrom_filter = (chromosome if chromosome.startswith("chr") else f"chr{chromosome}").encode()
    has_window = int(start is not None and end is not None)
    win_start = int(start) if has_window else 0
    win_end = int(end) if has_window else 0
    names, n_mask, offsets_arr, kb_arr = _mask_args(excluded)

    p_starts = c.POINTER(c.c_int64)()
    p_ends = c.POINTER(c.c_int64)()
    p_depths = c.POINTER(c.c_double)()
    out_n = c.c_int64(0)
    rc = lib.grid_bed_read(
        str(path).encode(), chrom_filter, has_window, win_start, win_end,
        names, n_mask, offsets_arr, kb_arr,
        c.byref(p_starts), c.byref(p_ends), c.byref(p_depths), c.byref(out_n),
    )
    try:
        if rc != 0:
            raise NativeReadError("grid_bed_read", path, rc)
        n = out_n.value
        return (_array(p_starts, n, np.int64), _array(p_ends, n, np.int64),
                _array(p_depths, n, np.float64))
    finally:
        lib.grid_bed_free(p_starts, p_ends, p_depths)


def read_regions_bed_gz_grouped(path, excluded=None):
    """Native twin of :func:`grid_tpu_torch.io.bed.read_regions_bed_gz_grouped`:
    every chromosome, no window, depth > 0, the repeat mask on the
    normalised name. Returns ``(chrom, starts, ends, depths)`` segments in
    file order."""
    lib = native_host.require()
    c = ctypes
    names, n_mask, offsets_arr, kb_arr = _mask_args(excluded)
    p_starts = c.POINTER(c.c_int64)()
    p_ends = c.POINTER(c.c_int64)()
    p_depths = c.POINTER(c.c_double)()
    p_names = c.POINTER(c.c_char)()
    p_bounds = c.POINTER(c.c_int64)()
    names_len = c.c_int64(0)
    n_segs = c.c_int64(0)
    out_n = c.c_int64(0)
    rc = lib.grid_bed_read_grouped(
        str(path).encode(), names, n_mask, offsets_arr, kb_arr,
        c.byref(p_starts), c.byref(p_ends), c.byref(p_depths),
        c.byref(p_names), c.byref(names_len), c.byref(p_bounds),
        c.byref(n_segs), c.byref(out_n),
    )
    try:
        if rc != 0:
            raise NativeReadError("grid_bed_read_grouped", path, rc)
        n, k = out_n.value, n_segs.value
        starts = _array(p_starts, n, np.int64)
        ends = _array(p_ends, n, np.int64)
        depths = _array(p_depths, n, np.float64)
        bounds = _array(p_bounds, k + 1, np.int64) if k else np.zeros(1, np.int64)
        raw_names = c.string_at(p_names, names_len.value) if names_len.value else b""
    finally:
        lib.grid_bed_free(p_starts, p_ends, p_depths)
        lib.grid_bed_free_grouped(p_names, p_bounds)
    seg_names = raw_names.split(b"\0")[:k]
    return [
        (seg_names[i].decode(), starts[bounds[i]:bounds[i + 1]], ends[bounds[i]:bounds[i + 1]],
         depths[bounds[i]:bounds[i + 1]])
        for i in range(k)
    ]
