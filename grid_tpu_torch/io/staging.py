"""Host-side staging: per-sample region scans -> dense arrays ready for the
device (twin of ``grid_tpu/io/staging.py``, numpy only).

The reference makes TWO full gzip passes over every sample's genome-wide
bed.gz (population means, then per-sample extraction —
grid/utils/normalize_mosdepth.py:218-301 and :304-357). Since both passes
apply identical line filters, each file is scanned ONCE here, the filtered
(region, depth) arrays are kept, and the population means come from the kept
data — half the ingestion IO with bit-identical semantics.

- per-sample results are compact numpy arrays (starts, ends, depths), not
  dicts — the region universe and the matrix fill use vectorized
  ``np.unique`` / ``np.searchsorted`` instead of hash lookups;
- duplicate regions within one file follow the reference's dict semantics
  (later lines overwrite earlier ones);
- parallel scanning uses a thread pool (the native reader releases the
  GIL for the whole file; zlib releases it in the Python reader);
- before a cohort scan, glibc's trim and mmap thresholds are raised once
  per process (:func:`_bulk_alloc_mode`), so the reader's per-file scratch
  is reused instead of faulted in again for every file.

Ported: the in-memory stager and the bounded-memory streaming stager. Not
ported: the sharded stager of the JAX package (it belongs to the sharded
layer).
"""

from __future__ import annotations

import ctypes
import os
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import NamedTuple

import numpy as np

from grid_tpu_torch.io.bed import map_bed_gz_to_samples, read_regions_bed_gz
from grid_tpu_torch.utils.logging import log


class CohortStage(NamedTuple):
    """Dense staged cohort ready for device transfer.

    Attributes:
        sample_ids: N sample IDs, sorted ascending (reference row order,
            grid/utils/normalize_mosdepth.py:392-393).
        regions: [R, 2] int64 array of (start, end), sorted ascending.
        values: [N, R] float64 raw depths (0 where ~mask).
        mask: [N, R] bool.
    """

    sample_ids: list
    regions: np.ndarray
    values: np.ndarray
    mask: np.ndarray


_BULK_ALLOC_DONE = False


def _bulk_alloc_mode():
    """Raise glibc's trim and mmap thresholds to 128 MB, once per process,
    before a cohort scan (``grid_tpu/io/staging.py``). The reader's per-file
    scratch is ~100 MB of short-lived buffers; at the default thresholds
    glibc maps them and hands the pages back on free, so every file faults
    them in again. The cost: freed scratch stays resident up to the heap's
    high-water mark (one file's scratch). ``GRID_TPU_NO_MALLOPT=1`` opts
    out; a no-op off glibc."""
    global _BULK_ALLOC_DONE
    if _BULK_ALLOC_DONE:
        return
    _BULK_ALLOC_DONE = True
    if os.environ.get("GRID_TPU_NO_MALLOPT") == "1":
        return
    try:
        libc = ctypes.CDLL("libc.so.6")
    except OSError:  # not glibc
        return
    m_trim_threshold, m_mmap_threshold = -1, -3
    libc.mallopt.argtypes = [ctypes.c_int, ctypes.c_int]
    libc.mallopt(m_trim_threshold, 128 << 20)
    libc.mallopt(m_mmap_threshold, 128 << 20)


def _dedupe_last_wins(starts, ends, depths):
    """Keep the LAST occurrence of each (start, end) pair, preserving the
    reference's dict-overwrite semantics for duplicate lines.

    mosdepth beds are position-sorted, so the staged arrays are almost
    always already non-decreasing in (start, end) — that case is a single
    O(n) boundary scan. The general case uses a STABLE argsort of the
    packed uint64 keys (far cheaper than np.unique(axis=0)'s void-dtype
    argsort).

    Output order: already-sorted input keeps its file order; UNSORTED
    input comes back (start, end)-key-sorted, not in original file order
    of the kept occurrences. All current consumers (population means,
    region search, matrix fill) are order-insensitive, but don't assume
    file order downstream."""
    if len(starts) == 0:
        return starts, ends, depths
    keys = _composite(starts, ends)
    if len(keys) > 1 and not (keys[1:] >= keys[:-1]).all():
        order = np.argsort(keys, kind="stable")
        starts, ends, depths, keys = (
            starts[order], ends[order], depths[order], keys[order]
        )
    # last of each equal run (stable order preserves file order within runs)
    keep = np.empty(len(keys), dtype=bool)
    keep[-1] = True
    keep[:-1] = keys[1:] != keys[:-1]
    if keep.all():  # no duplicates (the common case): skip 3 array copies
        return starts, ends, depths
    return starts[keep], ends[keep], depths[keep]


def scan_cohort_regions(
    sample_to_bed: dict[str, Path],
    chromosome: str | None,
    start: int | None,
    end: int | None,
    excluded: dict | None,
    threads: int = 1,
    console=None,
) -> dict[str, tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Scan every sample's regions.bed.gz once, returning
    {sample: (starts, ends, depths)} after window/depth/mask filters.

    A sample whose file is missing or unreadable yields empty arrays
    (reference behavior: per-sample failure leaves the cohort running,
    grid/utils/normalize_mosdepth.py:353-355).
    """
    _bulk_alloc_mode()
    empty = (np.empty(0, np.int64), np.empty(0, np.int64), np.empty(0, np.float64))

    def _scan(item):
        sid, path = item
        try:
            if not Path(path).exists():
                return sid, empty
            s, e, d = read_regions_bed_gz(path, chromosome, start, end, excluded)
            return sid, _dedupe_last_wins(s, e, d)
        except Exception as exc:  # pragma: no cover - defensive
            log(console, f"Error reading {sid}: {exc}", style="danger")
            return sid, empty

    out = {}
    if threads <= 1:
        for item in sample_to_bed.items():
            sid, arrays = _scan(item)
            out[sid] = arrays
    else:
        with ThreadPoolExecutor(max_workers=threads) as ex:
            for sid, arrays in ex.map(_scan, sample_to_bed.items()):
                out[sid] = arrays
    return out


def population_mean_depths(per_sample):
    """Population mean depth per region over samples carrying it
    (ref: grid/utils/normalize_mosdepth.py:289-301).

    Returns (regions [M, 2] sorted, means [M]). Incremental union over
    packed uint64 keys, one sample at a time, instead of concatenating
    every sample's keys and running one global ``np.unique`` (at 100 x
    3M rows that form sorts ~300M keys); here the first sample seeds the
    sorted universe and each later sample either

    - matches it exactly (one O(n) compare + two vector adds — the
      regular-mosdepth-grid common case), or
    - splits into hits (accumulated via ``np.bincount`` on searchsorted
      positions) and misses (buffered, merged into the universe in bulk
      when the buffer grows past half the universe).

    Semantics are identical to the global-unique form, including
    duplicate keys within one sample each contributing a count (upstream
    ``_dedupe_last_wins`` means that case never arises in practice).
    """
    uniq_keys = sums = counts = None
    pend_k: list = []
    pend_d: list = []
    pending = 0

    def _flush():
        nonlocal uniq_keys, sums, counts, pend_k, pend_d, pending
        if not pend_k:
            return
        pk = np.concatenate(pend_k)
        pd = np.concatenate(pend_d)
        upk, inv = np.unique(pk, return_inverse=True)
        psums = np.bincount(inv, weights=pd, minlength=len(upk))
        pcounts = np.bincount(inv, minlength=len(upk))
        # pending keys are disjoint from uniq_keys (a key enters pending
        # only by missing the universe, which is frozen between flushes)
        merged = np.concatenate([uniq_keys, upk])
        order = np.argsort(merged, kind="stable")
        merged = merged[order]
        new_sums = np.concatenate([sums, psums])[order]
        new_counts = np.concatenate([counts, pcounts])[order]
        uniq_keys, sums, counts = merged, new_sums, new_counts
        pend_k, pend_d = [], []
        pending = 0

    for (s, e, d) in per_sample.values():
        if len(s) == 0:
            continue
        keys = _composite(s, e)
        d = np.asarray(d, np.float64)
        if uniq_keys is None:
            upk, inv = np.unique(keys, return_inverse=True)
            uniq_keys = upk
            sums = np.bincount(inv, weights=d, minlength=len(upk))
            counts = np.bincount(inv, minlength=len(upk))
            continue
        if len(keys) == len(uniq_keys) and np.array_equal(keys, uniq_keys):
            sums += d
            counts += 1
            continue
        pos = np.searchsorted(uniq_keys, keys)
        pc = pos.clip(max=len(uniq_keys) - 1)
        hit = (pos < len(uniq_keys)) & (uniq_keys[pc] == keys)
        if hit.any():
            sums += np.bincount(pc[hit], weights=d[hit], minlength=len(uniq_keys))
            counts += np.bincount(pc[hit], minlength=len(uniq_keys))
        miss = ~hit
        if miss.any():
            pend_k.append(keys[miss])
            pend_d.append(d[miss])
            pending += int(miss.sum())
            if pending >= max(len(uniq_keys) // 2, 4096):
                _flush()
    _flush()

    if uniq_keys is None:
        return np.empty((0, 2), np.int64), np.empty(0, np.float64)
    uniq = np.stack(
        [(uniq_keys >> np.uint64(32)).astype(np.int64),
         (uniq_keys & np.uint64(0xFFFFFFFF)).astype(np.int64)], axis=1
    )
    return uniq, sums / counts


def _composite(starts, ends):
    """Pack (start, end) into one sortable uint64 (genomic coordinates are
    < 2^32, so the pair fits exactly and lexicographic order is preserved)."""
    return (np.asarray(starts, np.uint64) << np.uint64(32)) | np.asarray(ends, np.uint64)


def stage_cohort(
    mosdepth_dir,
    samples,
    chromosome,
    start,
    end,
    excluded,
    min_depth: float,
    max_depth: float,
    threads: int = 1,
    console=None,
    per_sample=None,
) -> CohortStage:
    """Full staging: map files, single scan, population-mean region filter,
    dense matrix build. Mirrors the reference's region/sample semantics:

    - regions kept iff min_depth <= population mean <= max_depth
      (grid/utils/normalize_mosdepth.py:81-83);
    - samples with zero surviving regions dropped with a warning
      (filter_empty_samples, :576-600);
    - rows sorted by sample ID, columns by (start, end).

    ``per_sample``: pre-scanned {sample: (starts, ends, depths)} arrays
    (already window/mask/depth-filtered — the fused one-pass ingest hands
    them over in-process, steps/ingest.py), bypassing the bed.gz re-scan.
    """
    if per_sample is not None:
        per_sample = {
            sid: _dedupe_last_wins(*arrays) for sid, arrays in per_sample.items()
        }
    else:
        sample_to_bed = map_bed_gz_to_samples(mosdepth_dir, samples)
        if not sample_to_bed:
            raise FileNotFoundError(f"No mosdepth files found in {mosdepth_dir}")

        per_sample = scan_cohort_regions(
            sample_to_bed, chromosome, start, end, excluded, threads, console
        )

    uniq_regions, pop_means = population_mean_depths(per_sample)
    keep = (pop_means >= min_depth) & (pop_means <= max_depth)
    valid_regions = uniq_regions[keep]

    # per-sample projection onto the valid-region universe; the packed
    # region keys are hoisted out of the loop (not repacked per sample) and
    # a sample whose keys EQUAL the universe maps by identity — the regular
    # mosdepth-grid common case
    reg_keys = _composite(valid_regions[:, 0], valid_regions[:, 1])
    identity_idx = None
    projected: dict[str, tuple[np.ndarray, np.ndarray]] = {}
    for sid, (s, e, d) in per_sample.items():
        keys = _composite(s, e)
        if len(keys) == len(reg_keys) and np.array_equal(keys, reg_keys):
            if identity_idx is None:
                identity_idx = np.arange(len(reg_keys), dtype=np.int64)
            projected[sid] = (identity_idx, d)
            continue
        pos = np.searchsorted(reg_keys, keys)
        pc = pos.clip(max=max(len(reg_keys) - 1, 0))
        hit = (
            (pos < len(reg_keys)) & (reg_keys[pc] == keys)
            if len(reg_keys) else np.zeros(len(keys), bool)
        )
        projected[sid] = (pc[hit].astype(np.int64), d[hit])

    n_before = len(projected)
    projected = {sid: v for sid, v in projected.items() if len(v[0])}
    n_removed = n_before - len(projected)
    if n_removed > 0:
        log(console, f"Removed {n_removed} samples with 0 regions", style="warning")
    if not projected:
        raise ValueError("No valid samples with regions found.")

    sample_ids = sorted(projected.keys())

    # column universe: regions carried by >=1 surviving sample
    col_used = np.zeros(len(valid_regions), dtype=bool)
    for idx, _ in projected.values():
        if len(idx) == len(col_used):  # keys unique per sample => full cover
            col_used[:] = True
            break
        col_used[idx] = True
    col_map = np.full(len(valid_regions), -1, dtype=np.int64)
    col_map[col_used] = np.arange(col_used.sum())
    regions = valid_regions[col_used]

    n, r = len(sample_ids), int(col_used.sum())
    # np.empty, not zeros: fully-covered rows (the regular-grid common
    # case) are written whole, so zero-init would double the memory
    # traffic on a multi-GB matrix; partial rows zero themselves first.
    # Row ranges fill on the scan thread pool (numpy copies release the
    # GIL).
    values = np.empty((n, r), dtype=np.float64)
    mask = np.empty((n, r), dtype=bool)

    def _fill_rows(lo, hi):
        for i in range(lo, hi):
            idx, d = projected[sample_ids[i]]
            cols = col_map[idx]
            if len(cols) == r:  # sorted unique full cover == arange: memcpy
                values[i] = d
                mask[i] = True
            else:
                values[i] = 0.0
                mask[i] = False
                values[i, cols] = d
                mask[i, cols] = True

    if threads > 1 and n > 1:
        step = -(-n // threads)
        with ThreadPoolExecutor(max_workers=threads) as ex:
            list(ex.map(
                lambda t: _fill_rows(t * step, min((t + 1) * step, n)),
                range(threads),
            ))
    else:
        _fill_rows(0, n)

    return CohortStage(sample_ids=sample_ids, regions=regions, values=values, mask=mask)


# ------------------------------------------------------- streaming stager ---


def stage_cohort_streaming(
    mosdepth_dir,
    samples,
    chromosome,
    start,
    end,
    excluded,
    min_depth: float,
    max_depth: float,
    bin_size: int = 1000,
    threads: int = 1,
    console=None,
) -> CohortStage:
    """Bounded-memory staging for very large cohorts (single chromosome,
    regular mosdepth bin grid).

    Two passes over the files (like the reference, but with dense-array
    accumulators instead of locked dicts): pass 1 streams each sample once,
    folding depths into per-bin population sums/counts indexed by
    ``start // bin_size`` and DISCARDING the arrays — O(R) accumulator
    memory regardless of N; pass 2 re-scans each file and writes its matrix
    row directly. Peak memory is the final [N, R_kept] matrix plus O(R),
    instead of every sample's raw region arrays at once (the in-memory
    stager's cost). The extra IO pass mirrors the reference's own two-pass
    design (grid/utils/normalize_mosdepth.py:218-357).

    Falls back to :func:`stage_cohort` when no chromosome filter is given or
    the inputs are not a regular grid.
    """
    sample_to_bed = map_bed_gz_to_samples(mosdepth_dir, samples)
    if not sample_to_bed:
        raise FileNotFoundError(f"No mosdepth files found in {mosdepth_dir}")
    if chromosome is None:
        return stage_cohort(
            mosdepth_dir, samples, chromosome, start, end, excluded,
            min_depth, max_depth, threads, console,
        )
    _bulk_alloc_mode()

    def _scan(item):
        sid, path = item
        try:
            s_, e_, d_ = read_regions_bed_gz(path, chromosome, start, end, excluded)
            return sid, _dedupe_last_wins(s_, e_, d_)
        except Exception:
            z = np.empty(0, np.int64)
            return sid, (z, z, np.empty(0, np.float64))

    # ---- pass 1: dense per-bin population stats (arrays discarded) -----
    sums = counts = ends_arr = None
    gmin = gmax = None
    irregular = False

    def _fold(sid, arrays):
        nonlocal sums, counts, ends_arr, gmin, gmax, irregular
        s_, e_, d_ = arrays
        if len(s_) == 0 or irregular:
            return
        if np.any(s_ % bin_size != 0):
            irregular = True
            return
        lo, hi = int(s_.min()) // bin_size, int(s_.max()) // bin_size
        if gmin is None:
            gmin, gmax = lo, hi
            size = gmax - gmin + 1
            sums = np.zeros(size)
            counts = np.zeros(size, np.int64)
            ends_arr = np.zeros(size, np.int64)
        else:
            if lo < gmin:
                pad = gmin - lo
                sums = np.concatenate([np.zeros(pad), sums])
                counts = np.concatenate([np.zeros(pad, np.int64), counts])
                ends_arr = np.concatenate([np.zeros(pad, np.int64), ends_arr])
                gmin = lo
            if hi > gmax:
                pad = hi - gmax
                sums = np.concatenate([sums, np.zeros(pad)])
                counts = np.concatenate([counts, np.zeros(pad, np.int64)])
                ends_arr = np.concatenate([ends_arr, np.zeros(pad, np.int64)])
                gmax = hi
        idx = (s_ // bin_size) - gmin
        np.add.at(sums, idx, d_)
        np.add.at(counts, idx, 1)
        ends_arr[idx] = e_

    if threads <= 1:
        for item in sample_to_bed.items():
            sid, arrays = _scan(item)
            _fold(sid, arrays)
    else:
        with ThreadPoolExecutor(max_workers=threads) as ex:
            for sid, arrays in ex.map(_scan, sample_to_bed.items()):
                _fold(sid, arrays)  # folding is serial; scanning overlaps

    if irregular:
        return stage_cohort(
            mosdepth_dir, samples, chromosome, start, end, excluded,
            min_depth, max_depth, threads, console,
        )
    if gmin is None:
        raise ValueError("No valid samples with regions found.")

    with np.errstate(invalid="ignore"):
        means = np.where(counts > 0, sums / np.maximum(counts, 1), np.nan)
    keep = (counts > 0) & (means >= min_depth) & (means <= max_depth)
    col_map = np.full(len(keep), -1, np.int64)
    col_map[keep] = np.arange(int(keep.sum()))
    kept_bins = np.where(keep)[0]
    regions = np.stack(
        [(kept_bins + gmin) * bin_size, ends_arr[kept_bins]], axis=1
    ).astype(np.int64)
    r = len(regions)

    # ---- pass 2: re-scan and write matrix rows directly -----------------
    sample_ids = sorted(sample_to_bed.keys())
    row_of = {sid: i for i, sid in enumerate(sample_ids)}
    values = np.zeros((len(sample_ids), r), dtype=np.float64)
    mask = np.zeros((len(sample_ids), r), dtype=bool)

    def _fill(item):
        sid, arrays = _scan(item)
        s_, e_, d_ = arrays
        if len(s_) == 0:
            return
        cols = col_map[(s_ // bin_size) - gmin]
        hit = cols >= 0
        i = row_of[sid]
        values[i, cols[hit]] = d_[hit]
        mask[i, cols[hit]] = True

    if threads <= 1:
        for item in sample_to_bed.items():
            _fill(item)
    else:
        with ThreadPoolExecutor(max_workers=threads) as ex:
            list(ex.map(_fill, sample_to_bed.items()))

    surviving = mask.any(axis=1)
    n_removed = int((~surviving).sum())
    if n_removed > 0:
        log(console, f"Removed {n_removed} samples with 0 regions", style="warning")
    if not surviving.any():
        raise ValueError("No valid samples with regions found.")

    kept_ids = [sid for i, sid in enumerate(sample_ids) if surviving[i]]
    return CohortStage(
        sample_ids=kept_ids,
        regions=regions,
        values=values[surviving],
        mask=mask[surviving],
    )
