"""CRAM/BAM alignment reading for steps 1-3 (port of
``grid_tpu/ingest/alignments.py``).

The backend chain is the JAX package's:

1. **native** — the host library's C++ BAM and CRAM readers
   (:mod:`grid_tpu_torch.native_host`): BGZF and CRAM block decoding with
   zlib (bzip2 and lzma opened at run time), BAI/CRAI queries and the
   region read-count filter, without htslib;
2. **pysam** — where it is installed;
3. **cramlite** — the pure-Python CRAM 3.0 reader and writer
   (:mod:`grid_tpu_torch.io.cramlite`), the plain version of the native
   CRAM reader.

A CRAM file the native reader fails on (a block codec the machine lacks)
takes the next backend; each such file adds one to
``native_host.fallbacks["alignment_reader"]``.

The counting filter is the reference's exactly
(grid/utils/count_reads.py:96-107): flag in ``proper_flags``, mapq >=
min_mapq, mate on the same reference, not duplicate (0x400), not secondary
(0x100), and ``start <= read.reference_start < end``.
"""

from __future__ import annotations

import glob
import os

from grid_tpu_torch import native_host

try:
    import pysam  # type: ignore

    _HAVE_PYSAM = True
except ImportError:
    pysam = None
    _HAVE_PYSAM = False


def _native():
    """The native BAM wrappers, or None where the host library did not load."""
    if native_host.lib() is None:
        return None
    from grid_tpu_torch.native_host import bam

    return bam


def _native_cram():
    """The native CRAM wrappers, or None where the host library did not load."""
    if native_host.lib() is None:
        return None
    from grid_tpu_torch.native_host import cram

    return cram


def _cramlite():
    from grid_tpu_torch.io import cramlite

    return cramlite


def available_backends() -> list[str]:
    out = []
    if _native() is not None:
        out.append("native")
    if _HAVE_PYSAM:
        out.append("pysam")
    out.append("cramlite")
    return out


def find_file(directory_loc, sample, expected_type=None):
    """Glob ``*{sample}*.{type}`` in a directory; first match or None
    (ref: grid/utils/utils.py:46-53)."""
    if expected_type:
        pattern = os.path.join(directory_loc, f"*{sample}*.{expected_type}")
        matches = sorted(glob.glob(pattern))
        if matches:
            return matches[0]
    return None


def find_files(directory_loc, samples, expected_type=None):
    """:func:`find_file` for many samples in one directory scan: the same
    match per sample (the lexicographically first ``*{sample}*.{type}``, or
    None), at the cost of string searches instead of a glob per sample."""
    samples = list(samples)
    if not expected_type:
        return {s: None for s in samples}
    try:
        names = sorted(e.name for e in os.scandir(directory_loc) if not e.name.startswith("."))
    except OSError:
        return {s: None for s in samples}
    suffix = f".{expected_type}"
    cands = [n for n in names if n.endswith(suffix)]
    out = {}
    for s in samples:
        s_str = str(s)
        if any(ch in s_str for ch in "*?["):
            # glob metacharacters in the sample id: keep exact glob semantics
            out[s] = find_file(directory_loc, s, expected_type)
            continue
        # ``*{s}*{suffix}`` (s literal) matches n iff n ends with suffix and
        # s occurs entirely within n[:-len(suffix)]
        hit = next((n for n in cands if s_str in n[: -len(suffix)]), None)
        out[s] = os.path.join(directory_loc, hit) if hit else None
    return out


def has_index(file_path, file_type) -> bool:
    """Check for .crai/.bai next to the file (ref: grid/utils/utils.py:56-73)."""
    allowed = {"CRAM": "crai", "BAM": "bai"}
    ft = str(file_type).upper()
    if ft not in allowed:
        return False
    if ft == "CRAM":
        return os.path.exists(file_path + ".crai") or os.path.exists(
            file_path.replace(".cram", ".crai"))
    return os.path.exists(file_path + ".bai") or os.path.exists(file_path.replace(".bam", ".bai"))


def create_index_for_file(file_path, file_type, reference_genome) -> None:
    """Create a CRAI/BAI index (ref: grid/utils/utils.py:85-89): pysam where
    it is installed, else the native BAI builder for BAM and cramlite's
    CRAI builder for CRAM."""
    ft = str(file_type).upper()
    if _HAVE_PYSAM:
        if ft == "CRAM":
            pysam.index(file_path, file_path + ".crai", reference_filename=reference_genome)
        elif ft == "BAM":
            pysam.index(file_path, file_path + ".bai", reference_filename=reference_genome)
        return
    native = _native()
    if native is not None and ft == "BAM":
        native.build_bai(file_path, file_path + ".bai")
        return
    if ft == "CRAM":
        _cramlite().build_crai(file_path, file_path + ".crai")
        return
    raise RuntimeError(
        f"No backend available to index {ft} files "
        f"(native supports BAM; pysam or cramlite handle CRAM).")


def count_reads_in_region(aln_file, ref_fasta, chrom: str, start: int, end: int, proper_flags,
                          min_mapq: int = 1) -> int:
    """Count reads passing the reference filter in [start, end): native
    first, then pysam, then cramlite for CRAM."""
    path = str(aln_file)
    flags = set(int(f) for f in proper_flags)

    native = _native()
    if native is not None and path.endswith(".bam"):
        return native.count_reads_region(path, chrom, start, end, flags, min_mapq)
    if path.endswith(".cram"):
        ncram = _native_cram()
        if ncram is not None:
            try:
                return ncram.count_reads_region(path, chrom, start, end, flags, min_mapq)
            except IOError:
                # e.g. bzip2/lzma blocks: the next backend reads the file
                native_host.count_fallback("alignment_reader")

    if _HAVE_PYSAM:
        count = 0
        mode = "rc" if path.endswith(".cram") else "rb"
        with pysam.AlignmentFile(path, mode, reference_filename=ref_fasta) as bam_f:
            for read in bam_f.fetch(chrom, start, end):
                if (read.flag in flags and read.mapq >= min_mapq
                        and read.reference_id == read.next_reference_id
                        and not read.is_duplicate and not read.is_secondary
                        and start <= read.reference_start < end):
                    count += 1
        return count

    if path.endswith(".cram"):
        return _cramlite().count_reads_region(path, ref_fasta, chrom, start, end, flags, min_mapq)

    raise RuntimeError(
        "No alignment backend available: native reader supports .bam; "
        "CRAM uses pysam or cramlite. Backends found: " + ", ".join(available_backends()))


def fetch_reads_region(aln_file, ref_fasta, chrom: str, start: int, end: int,
                       exclude_flags: int = 1796, min_mapq: int = 0):
    """Reads STARTING in [start, end): (positions, flags, mapqs, seqs).
    Native for BAM, then pysam, then cramlite for CRAM."""
    import numpy as np

    path = str(aln_file)
    native = _native()
    if native is not None and path.endswith(".bam"):
        return native.fetch_reads(path, chrom, start, end, exclude_flags, min_mapq)

    if _HAVE_PYSAM:
        mode = "rc" if path.endswith(".cram") else "rb"
        positions, flags, mapqs, seqs = [], [], [], []
        with pysam.AlignmentFile(path, mode, reference_filename=ref_fasta) as f:
            for read in f.fetch(chrom, start, end):
                if read.flag & exclude_flags or read.mapq < min_mapq:
                    continue
                if not (start <= read.reference_start < end):
                    continue
                positions.append(read.reference_start)
                flags.append(read.flag)
                mapqs.append(read.mapq)
                seqs.append(read.query_sequence or "")
        return (np.asarray(positions, np.int64), np.asarray(flags, np.int32),
                np.asarray(mapqs, np.int32), seqs)

    if path.endswith(".cram"):
        return _cramlite().fetch_reads_region(path, ref_fasta, chrom, start, end, exclude_flags,
                                              min_mapq)

    raise RuntimeError(
        "No alignment backend available to fetch reads: native reader "
        "supports .bam; CRAM uses pysam or cramlite.")
