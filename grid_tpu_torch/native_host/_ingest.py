"""The ctypes calls of the one-pass ingest (port of
``grid_tpu/native/_ingest.py``): one file (``grid_bam_ingest_multi`` and
``grid_cram_ingest_multi``, which share a signature and return contract,
``csrc/host/bam.cpp``) and the whole cohort in one call
(``grid_ingest_batch``, ``csrc/host/batch.cpp``)."""

from __future__ import annotations

import ctypes as _ct
import os

import numpy as np

from grid_tpu_torch.native_host import require

_I64P = _ct.POINTER(_ct.c_int64)
_I32P = _ct.POINTER(_ct.c_int32)
_F64P = _ct.POINTER(_ct.c_double)


def _window_cap(start, end, bin_size):
    return 4 * ((int(end) - int(start)) // int(bin_size) + 2) + 1024


def _marshal_shared(flags, chrom, stage_chrom_prefix, windows):
    """The arguments the per-file and batched calls share: the sorted
    flags, the staging chromosome prefix, and the extra windows packed."""
    flag_list = sorted(int(f) for f in flags)
    prefix = stage_chrom_prefix
    if prefix is None:
        c = str(chrom)
        prefix = c if c.startswith("chr") else f"chr{c}"
    n_win = len(windows) if windows else 0
    if n_win:
        win_chroms = b"".join(str(w[0]).encode() + b"\0" for w in windows)
        win_starts = np.array([int(w[1]) for w in windows], np.int64)
        win_ends = np.array([int(w[2]) for w in windows], np.int64)
    else:
        win_chroms = win_starts = win_ends = None
    return flag_list, prefix, n_win, win_chroms, win_starts, win_ends


def ingest_call(cfn, name, path, out_bed_gz, chrom, start, end, flags, count_min_mapq=1,
                bin_size=1000, exclude_flags=1796, bin_min_mapq=0, skip_zero=False,
                stage_chrom_prefix=None, windows=None):
    """Call a ``grid_*_ingest_multi`` function; returns (count, cov100,
    starts, ends, depths, refids[, win_counts]): the window's read count,
    the coverage integer, and the staged window bins (depth > 0, rounded as
    written; refids index the file's references).

    ``windows``: optional (chrom, start, end) count-only windows, counted in
    the same scan; then ``win_counts`` (int64, one per window; -1 marks a
    chromosome the per-format sequential count would raise on, CRAM only)
    ends the tuple."""
    flag_list, prefix, n_win, win_chroms, win_starts, win_ends = (
        _marshal_shared(flags, chrom, stage_chrom_prefix, windows))
    arr = (_ct.c_int32 * max(len(flag_list), 1))(*(flag_list or [0]))
    if n_win:
        win_counts = np.zeros(n_win, np.int64)
        wargs = (win_chroms, win_starts.ctypes.data_as(_I64P), win_ends.ctypes.data_as(_I64P),
                 n_win, win_counts.ctypes.data_as(_I64P))
    else:
        win_counts = None
        wargs = (None, None, None, 0, None)

    cap = _window_cap(start, end, bin_size)
    for _ in range(3):
        refids = np.empty(cap, np.int32)
        starts = np.empty(cap, np.int64)
        ends = np.empty(cap, np.int64)
        depths = np.empty(cap, np.float64)
        count, cov100, nbins = _ct.c_int64(0), _ct.c_int64(0), _ct.c_int64(0)
        rc = cfn(
            str(path).encode(), str(out_bed_gz).encode() if out_bed_gz else b"",
            int(bin_size), int(exclude_flags), int(bin_min_mapq), int(bool(skip_zero)),
            str(chrom).encode(), int(start), int(end), arr, len(flag_list),
            int(count_min_mapq), prefix.encode(), _ct.byref(count), _ct.byref(cov100),
            refids.ctypes.data_as(_I32P), starts.ctypes.data_as(_I64P),
            ends.ctypes.data_as(_I64P), depths.ctypes.data_as(_F64P), cap, _ct.byref(nbins),
            *wargs,
        )
        if rc == -5:  # the staged bins overflowed: nbins holds the size needed
            cap = int(nbins.value) + 64
            continue
        if rc == -4:
            raise ValueError(f"{name}: chromosome {chrom!r} not found in {path}")
        if rc != 0:
            raise IOError(f"{name}({path}) failed with code {rc}")
        n = int(nbins.value)
        base = (int(count.value), int(cov100.value), starts[:n].copy(), ends[:n].copy(),
                depths[:n].copy(), refids[:n].copy())
        return base + (win_counts,) if n_win else base
    raise IOError(f"{name}({path}): staged-bin buffer kept overflowing")


def ingest_batch(entries, chrom, start, end, flags, count_min_mapq=1, bin_size=1000,
                 exclude_flags=1796, bin_min_mapq=0, skip_zero=False, stage_chrom_prefix=None,
                 windows=None, threads=0, collect_bins=True, progress=None, thread_stats=None):
    """The whole cohort's one-pass ingest in one native call
    (``grid_ingest_batch``): worker threads below the interpreter lock pull
    files off an atomic cursor and run the per-file cores.

    ``entries``: list of (path, out_bed_gz), the format picked per file by
    the ``.cram`` suffix. Returns ``(status, counts, covs, bins,
    win_counts)``: status[i] is file i's return code (0 ok; the caller
    re-runs the others through its fallback chain), bins[i] is ``(starts,
    ends, depths, refids)`` or None (``collect_bins`` off, or the file
    failed), win_counts an ``[n, n_windows]`` int64 array or None.
    ``progress``: optional int64[1] array the native side increments once
    per finished file. ``thread_stats``: optional dict, filled with
    ``{"busy_s": [...], "cpu_s": [...], "n_threads": used}``, each worker's
    wall seconds inside the decode cores and its thread CPU seconds."""
    n = len(entries)
    if n == 0:
        return np.zeros(0, np.int32), np.zeros(0, np.int64), np.zeros(0, np.int64), [], None
    cfn = require().grid_ingest_batch

    paths_buf = b"".join(str(p).encode() + b"\0" for p, _ in entries)
    beds_buf = b"".join((str(b).encode() if b else b"") + b"\0" for _, b in entries)
    is_cram = np.array([1 if str(p).endswith(".cram") else 0 for p, _ in entries], np.int32)

    flag_list, prefix, n_win, win_chroms, win_starts, win_ends = (
        _marshal_shared(flags, chrom, stage_chrom_prefix, windows))
    flag_arr = np.array(flag_list or [0], np.int32)
    if n_win:
        win_counts = np.zeros((n, n_win), np.int64)
        wargs = (win_chroms, win_starts.ctypes.data_as(_I64P), win_ends.ctypes.data_as(_I64P),
                 n_win)
        wc_ptr = win_counts.ctypes.data_as(_I64P)
    else:
        win_counts, wargs, wc_ptr = None, (None, None, None, 0), None

    cap_per = _window_cap(start, end, bin_size) if collect_bins else 0
    counts = np.zeros(n, np.int64)
    covs = np.zeros(n, np.int64)
    status = np.zeros(n, np.int32)
    nbins = np.zeros(n, np.int64)
    if cap_per:
        refids = np.empty(n * cap_per, np.int32)
        starts_a = np.empty(n * cap_per, np.int64)
        ends_a = np.empty(n * cap_per, np.int64)
        depths_a = np.empty(n * cap_per, np.float64)
        bptrs = (refids.ctypes.data_as(_I32P), starts_a.ctypes.data_as(_I64P),
                 ends_a.ctypes.data_as(_I64P), depths_a.ctypes.data_as(_F64P))
    else:
        bptrs = (None, None, None, None)

    # the thread count is decided here and the stats buffers sized to it,
    # so the C side never picks a larger count and writes past them
    eff_threads = int(threads) if int(threads) > 0 else (os.cpu_count() or 1)
    busy = np.zeros(eff_threads, np.float64)
    cpu = np.zeros(eff_threads, np.float64)
    nt_used = np.zeros(1, np.int32)
    rc = cfn(
        paths_buf, beds_buf, is_cram.ctypes.data_as(_I32P), n, eff_threads, int(bin_size),
        int(exclude_flags), int(bin_min_mapq), int(bool(skip_zero)), str(chrom).encode(),
        int(start), int(end), flag_arr.ctypes.data_as(_I32P), len(flag_list),
        int(count_min_mapq), prefix.encode(), *wargs,
        counts.ctypes.data_as(_I64P), covs.ctypes.data_as(_I64P), wc_ptr,
        status.ctypes.data_as(_I32P), *bptrs, cap_per, nbins.ctypes.data_as(_I64P),
        progress.ctypes.data_as(_I64P) if progress is not None else None,
        busy.ctypes.data_as(_F64P), cpu.ctypes.data_as(_F64P), nt_used.ctypes.data_as(_I32P),
    )
    if rc != 0:
        raise IOError(f"grid_ingest_batch failed with code {rc}")
    if thread_stats is not None:
        used = int(nt_used[0])
        thread_stats.update(busy_s=busy[:used].tolist(), cpu_s=cpu[:used].tolist(),
                            n_threads=used)

    bins = []
    for i in range(n):
        if status[i] != 0 or not cap_per:
            bins.append(None)
            continue
        off, m = i * cap_per, int(nbins[i])
        bins.append((starts_a[off:off + m].copy(), ends_a[off:off + m].copy(),
                     depths_a[off:off + m].copy(), refids[off:off + m].copy()))
    return status, counts, covs, bins, win_counts
