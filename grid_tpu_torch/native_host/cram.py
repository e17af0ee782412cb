"""ctypes wrappers of the host library's CRAM reader (port of
``grid_tpu/native/cram.py`` but for its writer; the C++ twin of
:mod:`grid_tpu_torch.io.cramlite`'s reading): region read counts
(CRAI-indexed where the index exists), binned depth, the header's
references, every record's fields for tests, and the one-pass ingest. A
file whose blocks need bzip2 or lzma, where the machine lacks those
libraries, fails with ``IOError`` and its callers take ``cramlite``."""

from __future__ import annotations

import ctypes

import numpy as np

from grid_tpu_torch.native_host import require
from grid_tpu_torch.native_host.bam import _flag_array, _names


def count_reads_region(path, chrom, start, end, flags, min_mapq=1) -> int:
    """Region read count with the reference filter semantics (CRAI-indexed
    when present; full scan otherwise)."""
    arr, n_flags = _flag_array(flags)
    rc = require().grid_cram_count(str(path).encode(), str(chrom).encode(), int(start),
                                   int(end), arr, n_flags, int(min_mapq))
    if rc == -4:
        raise ValueError(f"chromosome {chrom!r} not found in {path}")
    if rc < 0:
        raise IOError(f"grid_cram_count({path}) failed with code {rc}")
    return int(rc)


def binned_depth(path, out_bed_gz, bin_size=1000, exclude_flags=1796, min_mapq=0,
                 skip_zero=False) -> None:
    """mosdepth-fast-mode binned depth -> regions.bed.gz (``skip_zero``
    omits zero-depth bins; downstream readers drop them anyway)."""
    rc = require().grid_cram_binned_depth(str(path).encode(), str(out_bed_gz).encode(),
                                          int(bin_size), int(exclude_flags), int(min_mapq),
                                          int(bool(skip_zero)))
    if rc != 0:
        raise IOError(f"grid_cram_binned_depth({path}) failed with code {rc}")


def dump_records(path, cap=1_000_000):
    """All records as an int64 array [n, 6]: (ref_id, pos, flag, mapq,
    mate_ref, ref_len)."""
    out = np.zeros((cap, 6), dtype=np.int64)
    n = require().grid_cram_dump(str(path).encode(),
                                 out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), int(cap))
    if n < 0:
        raise IOError(f"grid_cram_dump({path}) failed with code {n}")
    return out[: min(n, cap)].copy()


def references(path, max_refs=4096):
    """[(name, length)] from the CRAM SAM header."""
    cap = 1 << 20
    names_buf = ctypes.create_string_buffer(cap)
    lens = (ctypes.c_int64 * max_refs)()
    n = require().grid_cram_refs(str(path).encode(), names_buf, cap, lens, max_refs)
    if n < 0:
        raise IOError(f"grid_cram_refs({path}) failed with code {n}")
    return [(name, int(lens[i])) for i, name in enumerate(_names(names_buf.raw, n))]


def ingest(path, out_bed_gz, chrom, start, end, flags, count_min_mapq=1, bin_size=1000,
           exclude_flags=1796, bin_min_mapq=0, skip_zero=False, stage_chrom_prefix=None,
           windows=None):
    """The one-pass ingest of one CRAM (``grid_cram_ingest_multi``): as
    :func:`grid_tpu_torch.native_host.bam.ingest`; a window count of -1
    marks a chromosome the file lacks (an Error row, as the sequential CRAM
    count writes)."""
    from grid_tpu_torch.native_host._ingest import ingest_call

    return ingest_call(require().grid_cram_ingest_multi, "grid_cram_ingest_multi", path,
                       out_bed_gz, chrom, start, end, flags, count_min_mapq, bin_size,
                       exclude_flags, bin_min_mapq, skip_zero, stage_chrom_prefix,
                       windows=windows)
