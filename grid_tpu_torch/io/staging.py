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

The stagers: the in-memory one (:func:`stage_cohort`), the sharded one
(:func:`stage_cohort_sharded`, run inside each rank of the sharded step:
every rank streams its own samples and holds only its block of rows, with
:func:`bed_source` over a mosdepth directory) and the bounded-memory
streaming one (:func:`stage_cohort_streaming`).
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


# --------------------------------------------------- shard-direct stager ---


class ShardedCohortStage(NamedTuple):
    """One rank's block of a cohort staged straight onto the ranks' devices.

    The [N, R] matrix is never held by one process: each rank filled a host
    buffer of [rows_per, R] with its own samples and moved it to its device,
    so a process's peak host memory is O(rows_per * R + R) (the ceiling
    beaten: grid/utils/normalize_mosdepth.py:379-416 builds the whole N x R
    matrix on one node).

    Attributes:
        sample_ids: the cohort's N IDs in row order (padding rows excluded),
            equal on every rank.
        chroms: chromosome names, index = chrom id in ``regions``.
        regions: [R, 3] int64 (chrom_id, start, end), sorted by
            (chrom name order, start).
        values / mask / row_valid: this rank's block on its device
            ([rows_per, R] dtype, [rows_per, R] bool, [rows_per] bool).
        n: the cohort's real (unpadded) row count.
        sample_rows: [N] int64, the global row of sample_ids[i]. THE
            authoritative sample<->row mapping: do NOT reconstruct it from
            row_valid, which is False both for padding rows AND for real
            samples whose regions all failed the depth filter.
        row0: the block's first global row (rank * rows_per).
    """

    sample_ids: list
    chroms: list
    regions: np.ndarray
    values: object
    mask: object
    row_valid: object
    n: int
    sample_rows: np.ndarray
    row0: int


class _PopulationAccum:
    """O(R) streaming accumulator of per-region population sums/counts.

    Regions are keyed by ``(chrom_id << 32) | start`` (one region per
    (chrom, start), matching the regular-grid reality of mosdepth output).
    A duplicate start with a DIFFERENT end would silently merge two
    distinct regions — the dense stager and the reference key by
    (start, end) — so ``add`` raises on an end mismatch rather than
    collapsing last-wins; such inputs must go through ``stage_cohort``.
    Misses are buffered and merged in bulk, so per-sample cost is
    O(R_sample log R) searchsorted, not a re-sort of the universe.
    """

    def __init__(self):
        self.keys = np.empty(0, np.uint64)
        self.sums = np.empty(0, np.float64)
        self.counts = np.empty(0, np.int64)
        self.ends = np.empty(0, np.int64)
        self._pk: list = []
        self._pd: list = []
        self._pe: list = []
        self._pending = 0

    def add(self, keys, depths, ends):
        if len(self.keys):
            pos = np.searchsorted(self.keys, keys)
            pc = pos.clip(max=len(self.keys) - 1)
            hit = (pos < len(self.keys)) & (self.keys[pc] == keys)
            if hit.any() and (self.ends[pc[hit]] != ends[hit]).any():
                raise ValueError(
                    "stage_cohort_sharded: two regions share a (chrom, start)"
                    " but differ in end — irregular grids with duplicate"
                    " starts are not representable here; use stage_cohort."
                )
            np.add.at(self.sums, pc[hit], depths[hit])
            np.add.at(self.counts, pc[hit], 1)
            miss = ~hit
        else:
            miss = np.ones(len(keys), bool)
        if miss.any():
            self._pk.append(keys[miss])
            self._pd.append(depths[miss])
            self._pe.append(ends[miss])
            self._pending += int(miss.sum())
            if self._pending >= max(len(self.keys) // 2, 4096):
                self.flush()

    def flush(self):
        if not self._pk:
            return
        pk = np.concatenate(self._pk)
        pd = np.concatenate(self._pd)
        pe = np.concatenate(self._pe)
        # end consistency across the merge: add() only guards hits against
        # the existing universe; duplicate keys INSIDE the pending window
        # (or between pending and existing) must agree on end too, or two
        # distinct regions would silently merge here
        keys_all = np.concatenate([self.keys, pk])
        ends_all = np.concatenate([self.ends, pe])
        order = np.argsort(keys_all, kind="stable")
        same = keys_all[order][1:] == keys_all[order][:-1]
        if (ends_all[order][1:][same] != ends_all[order][:-1][same]).any():
            raise ValueError(
                "stage_cohort_sharded: two regions share a (chrom, start)"
                " but differ in end — irregular grids with duplicate"
                " starts are not representable here; use stage_cohort."
            )
        uk, inv = np.unique(keys_all, return_inverse=True)
        sums = np.zeros(len(uk))
        counts = np.zeros(len(uk), np.int64)
        ends = np.zeros(len(uk), np.int64)
        old = inv[: len(self.keys)]
        sums[old] = self.sums
        counts[old] = self.counts
        ends[old] = self.ends
        new = inv[len(self.keys):]
        np.add.at(sums, new, pd)
        np.add.at(counts, new, 1)
        ends[new] = pe
        self.keys, self.sums, self.counts, self.ends = uk, sums, counts, ends
        self._pk, self._pd, self._pe = [], [], []
        self._pending = 0


def _last_wins(keys):
    """The positions of the last occurrence of each key (reference
    dict-overwrite semantics), in ascending position order."""
    _, idx = np.unique(keys[::-1], return_index=True)
    return np.sort(len(keys) - 1 - idx)


def _sample_keys(chrom_ids: dict, segments):
    """Composite keys + depths + ends for one sample's grouped segments,
    deduped last-wins within the sample; new chromosomes get the next id."""
    keys_l, depths_l, ends_l = [], [], []
    for chrom, s, e, d in segments:
        cid = chrom_ids.setdefault(chrom, len(chrom_ids))
        keys_l.append((np.uint64(cid) << np.uint64(32)) | s.astype(np.uint64))
        depths_l.append(d)
        ends_l.append(e)
    if not keys_l:
        return np.empty(0, np.uint64), np.empty(0, np.float64), np.empty(0, np.int64)
    keys = np.concatenate(keys_l)
    depths = np.concatenate(depths_l)
    ends = np.concatenate(ends_l)
    keep = _last_wins(keys)
    # duplicate keys are legal only when their ends agree (see _PopulationAccum)
    if len(keep) < len(keys):
        order = np.argsort(keys, kind="stable")
        same_key = keys[order][1:] == keys[order][:-1]
        if (ends[order][1:][same_key] != ends[order][:-1][same_key]).any():
            raise ValueError(
                "stage_cohort_sharded: duplicate (chrom, start) with differing"
                " end within one sample; use stage_cohort for irregular grids."
            )
    return keys[keep], depths[keep], ends[keep]


def _sample_keys_ranked(rank_by_name: dict, segments):
    """Like :func:`_sample_keys` but with FIXED chrom->rank ids (pass 2);
    segments on chroms unseen in pass 1 are dropped (cannot be in the
    region universe)."""
    keys_l, depths_l, ends_l = [], [], []
    for chrom, s, e, d in segments:
        rank = rank_by_name.get(chrom)
        if rank is None:
            continue
        keys_l.append((np.uint64(rank) << np.uint64(32)) | s.astype(np.uint64))
        depths_l.append(d)
        ends_l.append(e)
    if not keys_l:
        return np.empty(0, np.uint64), np.empty(0, np.float64), np.empty(0, np.int64)
    keys = np.concatenate(keys_l)
    depths = np.concatenate(depths_l)
    ends = np.concatenate(ends_l)
    keep = _last_wins(keys)
    return keys[keep], depths[keep], ends[keep]


def _allgather_bytes(group, blob: bytes) -> list[bytes]:
    """All-gather a variable-length byte string over the ranks: the lengths,
    then the pad-to-max uint8 buffer, through ``group.all_gather_rows``
    (on ``group.device`` under NCCL, on the host under gloo). Returns one
    bytes per rank, in rank order."""
    import torch

    where = group.device if group.transport == "nccl" else torch.device("cpu")
    lens = group.all_gather_rows(
        torch.tensor([len(blob)], dtype=torch.int64, device=where)).cpu().numpy()
    maxlen = max(int(lens.max()), 1)
    buf = np.zeros((1, maxlen), np.uint8)
    buf[0, : len(blob)] = np.frombuffer(blob, np.uint8)
    bufs = group.all_gather_rows(torch.from_numpy(buf).to(where)).cpu().numpy()
    return [bufs[p, : int(lens[p])].tobytes() for p in range(group.world)]


def _merge_accums_across_processes(group, chrom_ids, accum):
    """The pass-1 merge: union the chromosome-name universe and the
    per-region (sum, count, end) accumulators over the ranks, so every rank
    derives the IDENTICAL region universe even though each scanned only its
    own samples. A group of one takes the same code.

    Returns (global_chrom_names_sorted, keys, sums, counts, ends) with keys
    re-encoded against the global chrom ranks."""
    # 1) union of chromosome names
    local_names = sorted(chrom_ids, key=str)
    all_names: set = set()
    for b in _allgather_bytes(group, "\n".join(local_names).encode()):
        if b:
            all_names.update(b.decode().split("\n"))
    global_names = sorted(all_names, key=str)
    gid = {name: i for i, name in enumerate(global_names)}

    # 2) re-encode local keys onto global chrom ids
    if len(chrom_ids):
        remap = np.zeros(len(chrom_ids), np.uint64)
        for name, local_id in chrom_ids.items():
            remap[local_id] = np.uint64(gid[name])
        cid = (accum.keys >> np.uint64(32)).astype(np.int64)
        keys = (remap[cid] << np.uint64(32)) | (accum.keys & np.uint64(0xFFFFFFFF))
    else:
        keys = accum.keys

    # 3) gather + merge the accumulator arrays
    payload = np.concatenate([
        keys.view(np.float64),  # bit-transport as f64 (same width)
        accum.sums,
        accum.counts.astype(np.float64),
        accum.ends.astype(np.float64),
    ]).tobytes()
    k_l, s_l, c_l, e_l = [], [], [], []
    for b in _allgather_bytes(group, payload):
        arr = np.frombuffer(b, np.float64)
        m = len(arr) // 4
        k_l.append(arr[:m].view(np.uint64).copy())
        s_l.append(arr[m: 2 * m].copy())
        c_l.append(arr[2 * m: 3 * m].astype(np.int64))
        e_l.append(arr[3 * m: 4 * m].astype(np.int64))
    uk, inv = np.unique(np.concatenate(k_l), return_inverse=True)
    sums = np.zeros(len(uk))
    counts = np.zeros(len(uk), np.int64)
    np.add.at(sums, inv, np.concatenate(s_l))
    np.add.at(counts, inv, np.concatenate(c_l))
    ae = np.concatenate(e_l)
    # vectorized end-consistency across ranks (a Python loop here costs
    # minutes at genome-wide region counts)
    emin = np.full(len(uk), np.iinfo(np.int64).max, np.int64)
    emax = np.full(len(uk), -1, np.int64)
    np.minimum.at(emin, inv, ae)
    np.maximum.at(emax, inv, ae)
    if (emin != emax).any():
        raise ValueError(
            "stage_cohort_sharded: processes disagree on a region's end"
            " — irregular grids with duplicate starts are not supported."
        )
    return global_names, uk, sums, counts, emax


def stage_cohort_sharded(source, group, min_depth: float, max_depth: float, threads: int = 1,
                         dtype=None, console=None, timer=None) -> ShardedCohortStage:
    """Bounded-memory staging straight onto the ranks: multi-chromosome,
    irregular grids, any N. Called inside a rank of the sharded step (a
    process; ``parallel/mesh.py``).

    Two passes over the samples, like the reference's own two-pass design
    (grid/utils/normalize_mosdepth.py:218-357) but with O(R) accumulators
    and one block's row buffer instead of the global matrix:

    - pass 1 streams this rank's samples once into a population
      accumulator, discarding the arrays; the accumulators and the
      chromosome names are all-gathered and merged
      (:func:`_merge_accums_across_processes`), so every rank derives the
      same region universe;
    - regions kept iff ``min_depth <= mean <= max_depth``;
    - pass 2 streams this rank's samples again into one [rows_per, R] host
      buffer, with its mask and row validity, and moves them to
      ``group.device``.

    Row layout (the JAX package's multi-process rule, one device per rank):
    ``rows_per`` is the largest sample count of any rank, rank r's rows
    start at r * rows_per, and each rank is padded on its own
    (``row_valid`` marks the padding). ``sample_ids`` is the gathered
    global list in that row order with the padding removed. Given the
    r-th contiguous share of the sorted IDs, rank r's rows are where a
    single process puts them on a W-device mesh, the padding last.

    Args:
        source: callable returning a FRESH iterator of this rank's
            ``(sample_id, segments)``, segments a list of
            ``(chrom, starts, ends, depths)`` (see
            :func:`grid_tpu_torch.io.bed.read_regions_bed_gz_grouped`);
            called once per pass. Use :func:`bed_source` for mosdepth
            directories.
        group: this rank's ``CohortGroup``.
        threads: accepted as in the JAX package, which scans pass 2 in
            order whatever its value.
        dtype: the values' torch dtype (default float32); the buffer holds
            the depths in it, rounded once (bfloat16 as the JAX package's
            ``np.zeros(..., bfloat16)`` buffer rounds them: by way of
            float32, as ``ml_dtypes`` and PyTorch both convert float64).
        timer: an optional ``StepTimer`` for the spans ``stage.pass1``
            (with the merge) and ``stage.pass2`` (with the copy to the
            device).

    Samples whose regions all fail the filter keep their row (mask
    all-False) and are excluded via ``row_valid`` — unlike
    :func:`stage_cohort` they are not dropped from the row universe, which
    would need a third pass at this scale.
    """
    import torch

    from grid_tpu_torch.utils.timing import step_timer

    dtype = torch.float32 if dtype is None else dtype
    # ---- pass 1: population accumulation (this rank's samples) -----------
    with step_timer("stage.pass1", timer):
        chrom_ids: dict[str, int] = {}
        accum = _PopulationAccum()
        sample_ids: list = []
        for sid, segments in source():
            sample_ids.append(sid)
            keys, depths, ends = _sample_keys(chrom_ids, segments)
            if len(keys):
                accum.add(keys, depths, ends)
        accum.flush()
        chroms_sorted, all_keys, sums, counts, ends_arr = _merge_accums_across_processes(
            group, chrom_ids, accum)
        rank_of = {name: i for i, name in enumerate(chroms_sorted)}

        if len(all_keys) == 0:
            raise ValueError("No valid samples with regions found.")

        with np.errstate(invalid="ignore"):
            means = sums / np.maximum(counts, 1)
        keep = (counts > 0) & (means >= min_depth) & (means <= max_depth)
        kept_keys = all_keys[keep]
        kept_ends = ends_arr[keep]
        # column order: (chromosome rank, start) ascending — keys are
        # rank-encoded, so a plain sort is the (chrom, start) lexsort
        order = np.argsort(kept_keys, kind="stable")
        kept_keys = kept_keys[order]
        regions = np.stack([
            (kept_keys >> np.uint64(32)).astype(np.int64),
            (kept_keys & np.uint64(0xFFFFFFFF)).astype(np.int64),
            kept_ends[order],
        ], axis=1)
        r = len(regions)

        # ---- the row layout: rows_per = the most samples of any rank ------
        where = group.device if group.transport == "nccl" else torch.device("cpu")
        n_locals = group.all_gather_rows(
            torch.tensor([len(sample_ids)], dtype=torch.int64, device=where)).cpu().numpy()
        rows_per = max(int(n_locals.max()), 1)
        n = int(n_locals.sum())
        row0 = group.rank * rows_per

    # ---- pass 2: fill this rank's block ------------------------------------
    with step_timer("stage.pass2", timer):
        vbuf = torch.zeros((rows_per, r), dtype=dtype)
        mbuf = np.zeros((rows_per, r), dtype=bool)
        rvbuf = np.zeros(rows_per, bool)
        for local, (sid, segments) in enumerate(source()):
            if local >= rows_per:
                break
            keys, depths, _ = _sample_keys_ranked(rank_of, segments)
            if len(keys) and r:
                pos = np.searchsorted(kept_keys, keys)
                pc = pos.clip(max=r - 1)
                hit = (pos < r) & (kept_keys[pc] == keys)
                vbuf[local, torch.from_numpy(pc[hit])] = torch.from_numpy(depths[hit]).to(dtype)
                mbuf[local, pc[hit]] = True
            rvbuf[local] = bool(mbuf[local].any())
        values = vbuf.to(group.device)
        mask = torch.from_numpy(mbuf).to(group.device)
        row_valid = torch.from_numpy(rvbuf).to(group.device)

    # the cohort's sample IDs in row order, and the authoritative
    # sample->row mapping: rank p's samples occupy rows p * rows_per on
    ids_all, rows_l = [], []
    for p, b in enumerate(_allgather_bytes(group, "\n".join(sample_ids).encode())):
        if b:
            ids_p = b.decode().split("\n")
            ids_all.extend(ids_p)
            rows_l.append(p * rows_per + np.arange(len(ids_p), dtype=np.int64))
    sample_rows = np.concatenate(rows_l) if rows_l else np.empty(0, np.int64)

    n_empty = int((~rvbuf[: len(sample_ids)]).sum())
    if n_empty:
        log(console, f"{n_empty} local samples have 0 surviving regions", style="warning")
    return ShardedCohortStage(sample_ids=ids_all, chroms=chroms_sorted, regions=regions,
                              values=values, mask=mask, row_valid=row_valid, n=n,
                              sample_rows=sample_rows, row0=row0)


def bed_source(mosdepth_dir, samples, excluded=None, console=None):
    """A :func:`stage_cohort_sharded` source over a mosdepth directory:
    each call returns a fresh per-sample iterator of grouped segments
    (multi-chromosome, repeat-mask filtered). Sample order is sorted by ID
    (reference row order)."""
    sample_to_bed = map_bed_gz_to_samples(mosdepth_dir, samples)
    if not sample_to_bed:
        raise FileNotFoundError(f"No mosdepth files found in {mosdepth_dir}")
    return bed_files_source([(sid, sample_to_bed[sid]) for sid in sorted(sample_to_bed)],
                            excluded, console)


def bed_files_source(files, excluded=None, console=None):
    """:func:`bed_source` over given ``(sample_id, regions.bed.gz path)``
    pairs, in their order (a rank's share of a mapped directory): each
    file through the native grouped reader where the host library loads; a
    sample that cannot be read is logged and yields no segments."""
    from grid_tpu_torch.io.bed import read_regions_bed_gz_grouped

    def _iter():
        for sid, path in files:
            try:
                yield sid, read_regions_bed_gz_grouped(path, excluded)
            except Exception as exc:  # per-sample failure: cohort continues
                log(console, f"Error reading {sid}: {exc}", style="danger")
                yield sid, []

    return _iter


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
