"""BED / mosdepth regions.bed.gz reading and repeat-mask handling (twin of
``grid_tpu/io/bed.py``, numpy only).

Consumes format §2.3.4 (mosdepth per-bin depth: ``chrom start end meandepth``,
ref consumer grid/utils/normalize_mosdepth.py:262-285) and §2.3.5 (repeat
mask BED -> kb-bin exclusion sets, ref grid/utils/normalize_mosdepth.py:177-207).

Both readers take the native route first: the host library's C++ reader
(:mod:`grid_tpu_torch.native_host`, a copy of the JAX package's), as in
``grid_tpu/io/bed.py``. Where the library is not loaded (warned once, with
the compiler's error) they use their Python versions, which are kept here as
the plain versions. A file the native reader returns a non-zero code for (a
corrupt or truncated file) is read again by the Python version, which then
raises as the reference does; :data:`native_fallbacks` counts those files.
"""

from __future__ import annotations

import gzip
import threading
from collections import defaultdict
from pathlib import Path

import numpy as np

from grid_tpu_torch import native_host
from grid_tpu_torch.native_host import bedgz as native_bedgz

#: files the native reader returned a non-zero code for and the Python
#: reader read again, since the process started (a test or a run may reset it)
native_fallbacks = 0
_FALLBACK_LOCK = threading.Lock()


def _count_fallback() -> None:
    global native_fallbacks
    with _FALLBACK_LOCK:
        native_fallbacks += 1


def norm_chrom(chrom: str) -> str:
    """Normalise chromosome name to 'chrN' ('6' -> 'chr6')
    (ref: grid/utils/normalize_mosdepth.py:210-215)."""
    return chrom if chrom.startswith("chr") else f"chr{chrom}"


def load_repeat_mask(repeat_bed) -> dict[str, set[int]]:
    """Load repeat regions into {chrom: set(kb_bins)}
    (ref: grid/utils/normalize_mosdepth.py:177-207).

    Every kb bin from start//1000 to end//1000 inclusive is excluded.
    """
    excluded: dict[str, set[int]] = defaultdict(set)
    if repeat_bed is None:
        return excluded
    with open(repeat_bed) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            parts = line.strip().split()
            if len(parts) < 3:
                continue
            chrom = norm_chrom(parts[0])
            try:
                start, end = int(parts[1]), int(parts[2])
            except ValueError:
                continue
            for kb in range(start // 1000, end // 1000 + 1):
                excluded[chrom].add(kb)
    return excluded


def region_overlaps_mask(chrom: str, start: int, end: int, excluded: dict[str, set[int]]) -> bool:
    """True if any kb bin of [start, end] is in the exclusion set
    (ref kb-bin intersection, grid/utils/normalize_mosdepth.py:281-283)."""
    kb_bins = excluded.get(chrom)
    if not kb_bins:
        return False
    return any(kb in kb_bins for kb in range(start // 1000, end // 1000 + 1))


def read_regions_bed_gz(
    path,
    chromosome: str | None = None,
    start: int | None = None,
    end: int | None = None,
    excluded: dict[str, set[int]] | None = None,
):
    """Read a mosdepth regions.bed.gz with the reference's filter semantics
    (grid/utils/normalize_mosdepth.py:262-285 and :320-352):

    - keep lines whose raw text starts with the normalised chromosome (when
      ``chromosome`` given);
    - when a window [start, end] is given: keep depth > 0 AND reg_end >= start
      AND reg_start <= end; otherwise keep depth > 0;
    - drop regions intersecting the repeat mask (kb-bin overlap), when
      ``excluded`` is given.

    Returns three np.ndarrays: (starts int64, ends int64, depths float64).
    """
    if native_host.lib() is not None:
        try:
            return native_bedgz.read_regions_bed_gz(path, chromosome, start, end, excluded)
        except native_bedgz.NativeReadError:
            _count_fallback()
    return _read_regions_bed_gz_python(path, chromosome, start, end, excluded)


def _read_regions_bed_gz_python(path, chromosome=None, start=None, end=None, excluded=None):
    """The plain version of :func:`read_regions_bed_gz`: gzip and a Python
    line loop."""
    chrom_to_match = norm_chrom(chromosome) if chromosome else None
    starts: list[int] = []
    ends: list[int] = []
    depths: list[float] = []
    excluded = excluded or {}
    with gzip.open(path, "rt") as f:
        for line in f:
            if chrom_to_match and not line.startswith(chrom_to_match):
                continue
            fields = line.strip().split("\t")
            if len(fields) < 4:
                continue
            chrom_f = norm_chrom(fields[0])
            try:
                reg_start = int(fields[1])
                reg_end = int(fields[2])
                depth = float(fields[3])
            except ValueError:
                continue
            if start is not None and end is not None:
                if not (depth > 0 and reg_end >= start and reg_start <= end):
                    continue
            elif depth <= 0:
                continue
            if region_overlaps_mask(chrom_f, reg_start, reg_end, excluded):
                continue
            starts.append(reg_start)
            ends.append(reg_end)
            depths.append(depth)
    return (
        np.asarray(starts, dtype=np.int64),
        np.asarray(ends, dtype=np.int64),
        np.asarray(depths, dtype=np.float64),
    )


def read_regions_bed_gz_grouped(path, excluded=None):
    """Multi-chromosome variant of :func:`read_regions_bed_gz`: same filter
    semantics (depth > 0, repeat-mask exclusion), NO window restriction, and
    the chromosome is preserved.

    Returns a list of ``(chrom, starts, ends, depths)`` segments in file
    order — mosdepth output is grouped by chromosome, so typically one
    segment per chromosome.
    """
    if native_host.lib() is not None:
        try:
            return native_bedgz.read_regions_bed_gz_grouped(path, excluded)
        except native_bedgz.NativeReadError:
            _count_fallback()
    return _read_regions_bed_gz_grouped_python(path, excluded)


def _read_regions_bed_gz_grouped_python(path, excluded=None):
    """The plain version of :func:`read_regions_bed_gz_grouped`."""
    excluded = excluded or {}
    segments: list[tuple[str, np.ndarray, np.ndarray, np.ndarray]] = []
    cur = None
    starts: list[int] = []
    ends: list[int] = []
    depths: list[float] = []

    def _emit():
        if cur is not None and starts:
            segments.append(
                (cur, np.asarray(starts, np.int64), np.asarray(ends, np.int64),
                 np.asarray(depths, np.float64))
            )

    with gzip.open(path, "rt") as f:
        for line in f:
            fields = line.strip().split("\t")
            if len(fields) < 4:
                continue
            chrom_f = norm_chrom(fields[0])
            try:
                reg_start = int(fields[1])
                reg_end = int(fields[2])
                depth = float(fields[3])
            except ValueError:
                continue
            if depth <= 0 or region_overlaps_mask(chrom_f, reg_start, reg_end, excluded):
                continue
            if chrom_f != cur:
                _emit()
                cur, starts, ends, depths = chrom_f, [], [], []
            starts.append(reg_start)
            ends.append(reg_end)
            depths.append(depth)
    _emit()
    return segments


def find_bed_gz_for_sample(sample_id: str, mosdepth_dir) -> Path:
    """Locate ``*{sample_id}*regions.bed.gz``
    (ref: grid/utils/normalize_mosdepth.py:557-573)."""
    mosdepth_dir = Path(mosdepth_dir)
    matches = sorted(mosdepth_dir.glob(f"*{sample_id}*regions.bed.gz"))
    if matches:
        return matches[0]
    return mosdepth_dir / f"{sample_id}.regions.bed.gz"


def map_bed_gz_to_samples(mosdepth_dir, samples) -> dict[str, Path]:
    """Map sample IDs to their regions.bed.gz files, handling
    ``{sample}_{region}.regions.bed.gz`` names by trying progressively
    shorter underscore-joined prefixes
    (ref: grid/utils/normalize_mosdepth.py:148-174)."""
    mosdepth_dir = Path(mosdepth_dir)
    sample_set = set(samples)
    result: dict[str, Path] = {}
    for f in sorted(mosdepth_dir.glob("*.regions.bed.gz")):
        name_part = f.name.split(".")[0]
        parts = name_part.split("_")
        for i in range(len(parts), 0, -1):
            candidate = "_".join(parts[:i])
            if candidate in sample_set:
                result[candidate] = f
                break
    return result
