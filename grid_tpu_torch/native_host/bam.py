"""ctypes wrappers of the host library's BAM reader (port of
``grid_tpu/native/bam.py``): region read counts (BAI-indexed where the index
exists), mosdepth-fast-mode binned depth, BAI construction, the header's
references, the reads of a region, the region subset written as a new BAM,
and the one-pass ingest. Each raises
``IOError`` on a negative return code, and RuntimeError when the host
library is not loaded."""

from __future__ import annotations

import ctypes

import numpy as np

from grid_tpu_torch.native_host import require


def _flag_array(flags):
    flag_list = sorted(int(f) for f in flags)
    return (ctypes.c_int32 * max(len(flag_list), 1))(*(flag_list or [0])), len(flag_list)


def count_reads_region(path, chrom, start, end, flags, min_mapq=1) -> int:
    """Count reads in [start, end) with the reference filter semantics
    (BAI-indexed when an index is present; full scan otherwise)."""
    arr, n_flags = _flag_array(flags)
    rc = require().grid_bam_count(str(path).encode(), str(chrom).encode(), int(start), int(end),
                                  arr, n_flags, int(min_mapq))
    if rc < 0:
        raise IOError(f"grid_bam_count({path}) failed with code {rc}")
    return int(rc)


def binned_depth(path, out_bed_gz, bin_size=1000, exclude_flags=1796, min_mapq=0,
                 skip_zero=False) -> None:
    """mosdepth-fast-mode binned depth -> regions.bed.gz. ``skip_zero``
    omits zero-depth bins (downstream readers drop them anyway)."""
    rc = require().grid_bam_binned_depth(str(path).encode(), str(out_bed_gz).encode(),
                                         int(bin_size), int(exclude_flags), int(min_mapq),
                                         int(bool(skip_zero)))
    if rc != 0:
        raise IOError(f"grid_bam_binned_depth({path}) failed with code {rc}")


def build_bai(path, out_path=None) -> str:
    """Build a BAI index for a coordinate-sorted BAM."""
    out_path = out_path or (str(path) + ".bai")
    rc = require().grid_bam_build_bai(str(path).encode(), str(out_path).encode())
    if rc != 0:
        raise IOError(f"grid_bam_build_bai({path}) failed with code {rc}")
    return str(out_path)


def _names(raw: bytes, n: int) -> list:
    out, off = [], 0
    for _ in range(n):
        end = raw.index(b"\0", off)
        out.append(raw[off:end].decode())
        off = end + 1
    return out


def references(path, max_refs=1024):
    """[(name, length)] from the BAM header."""
    cap = 1 << 20
    names_buf = ctypes.create_string_buffer(cap)
    lens = (ctypes.c_int32 * max_refs)()
    n = require().grid_bam_refs(str(path).encode(), names_buf, cap, lens, max_refs)
    if n < 0:
        raise IOError(f"grid_bam_refs({path}) failed with code {n}")
    return [(name, int(lens[i])) for i, name in enumerate(_names(names_buf.raw, n))]


def subset_region(path, chrom, start, end, out_path) -> int:
    """Write the records overlapping [start, end) to a new BAM (the native
    BGZF writer, the header kept verbatim). Returns the number of records
    written."""
    rc = require().grid_bam_subset(str(path).encode(), str(chrom).encode(), int(start), int(end),
                                   str(out_path).encode())
    if rc == -4:
        raise ValueError(f"chromosome {chrom!r} not found in {path}")
    if rc < 0:
        raise IOError(f"grid_bam_subset({path}) failed with code {rc}")
    return int(rc)


def fetch_reads(path, chrom, start, end, exclude_flags=1796, min_mapq=0):
    """Reads with pos in [start, end): (positions int64, flags int32, mapqs
    int32, seqs list[str])."""
    c = ctypes
    lib = require()
    p_pos, p_flag = c.POINTER(c.c_int64)(), c.POINTER(c.c_int32)()
    p_mapq, p_seq, p_off = c.POINTER(c.c_int32)(), c.c_char_p(), c.POINTER(c.c_int64)()
    n = lib.grid_bam_fetch(str(path).encode(), str(chrom).encode(), int(start), int(end),
                           int(exclude_flags), int(min_mapq), c.byref(p_pos), c.byref(p_flag),
                           c.byref(p_mapq), c.byref(p_seq), c.byref(p_off))
    if n < 0:
        raise IOError(f"grid_bam_fetch({path}) failed with code {n}")
    try:
        pos = np.ctypeslib.as_array(p_pos, shape=(n,)).copy() if n else np.empty(0, np.int64)
        flags = np.ctypeslib.as_array(p_flag, shape=(n,)).copy() if n else np.empty(0, np.int32)
        mapqs = np.ctypeslib.as_array(p_mapq, shape=(n,)).copy() if n else np.empty(0, np.int32)
        offs = np.ctypeslib.as_array(p_off, shape=(n + 1,)).copy()
        total = int(offs[-1])
        raw = c.string_at(p_seq, total) if total else b""
        seqs = [raw[offs[i]:offs[i + 1]].decode() for i in range(n)]
    finally:
        lib.grid_bam_fetch_free(p_pos, p_flag, p_mapq, p_seq, p_off)
    return pos, flags, mapqs, seqs


def ingest(path, out_bed_gz, chrom, start, end, flags, count_min_mapq=1, bin_size=1000,
           exclude_flags=1796, bin_min_mapq=0, skip_zero=False, stage_chrom_prefix=None,
           windows=None):
    """The one-pass ingest of one BAM (``grid_bam_ingest_multi``): returns
    (count, cov100, starts, ends, depths, refids[, win_counts]), see
    :func:`grid_tpu_torch.native_host._ingest.ingest_call`."""
    from grid_tpu_torch.native_host._ingest import ingest_call

    return ingest_call(require().grid_bam_ingest_multi, "grid_bam_ingest_multi", path,
                       out_bed_gz, chrom, start, end, flags, count_min_mapq, bin_size,
                       exclude_flags, bin_min_mapq, skip_zero, stage_chrom_prefix,
                       windows=windows)
