"""ctypes wrappers of the host library's CRAM reader and writer (port of
``grid_tpu/native/cram.py``; the C++ twin of :mod:`grid_tpu_torch.io.cramlite`'s
reading and of its writer's verbatim mode): region read counts
(CRAI-indexed where the index exists), binned depth, the header's
references, every record's fields for tests, the one-pass ingest, and
:func:`write_cram`. A file whose blocks need bzip2 or lzma, where the
machine lacks those libraries, fails with ``IOError`` and its callers take
``cramlite``."""

from __future__ import annotations

import ctypes
import operator

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


# BAM's CIGAR operation codes (SAM spec 4.2)
_CIGAR_OPS = {"M": 0, "I": 1, "D": 2, "N": 3, "S": 4, "H": 5, "P": 6, "=": 7, "X": 8}


def _packed(parts: list) -> tuple:
    """Byte strings as one uint8 array and their int64 offsets [n + 1]."""
    off = np.zeros(len(parts) + 1, np.int64)
    np.cumsum([len(p) for p in parts], out=off[1:])
    return np.frombuffer(b"".join(parts), dtype=np.uint8).copy(), off


def write_cram(path, references, records, slice_records=10_000, build_index=True,
               sam_header=None):
    """Native CRAM 3.0 writer (the C++ twin of cramlite.write_cram's verbatim
    mode): packs the records into column arrays and makes one ctypes call.
    Non-trivial CIGARs are kept as CRAM features (D/N/I/S/H/P); match runs
    store verbatim base stretches. No reference-based compression (the
    Python writer with a FASTA does substitution features and embedded
    references).

    Args:
        references: [(name, length)].
        records: iterable of cramlite.CramRecord (or anything with the same
            fields).
    """
    lib = require()
    recs = list(records)
    n = len(recs)
    if sam_header is None:
        sam_header = "@HD\tVN:1.6\tSO:coordinate\n" + "".join(
            f"@SQ\tSN:{name}\tLN:{length}\n" for name, length in references)
    hdr = np.frombuffer(sam_header.encode(), dtype=np.uint8).copy()

    # one attribute-extraction pass (attrgetter returns the whole tuple in C)
    get = operator.attrgetter("flag", "ref_id", "pos", "mapq", "rl", "mate_ref_id", "mate_pos",
                              "tlen", "seq")
    rows = [get(r) for r in recs]
    flag_t, ref_t, pos_t, mapq_t, rl_t, mref_t, mpos_t, tlen_t, seq_t = (
        zip(*rows) if rows else ((),) * 9)
    flag = np.array(flag_t, np.int32)
    ref_id = np.array(ref_t, np.int32)
    pos = np.array(pos_t, np.int64)
    mapq = np.array(mapq_t, np.int32)
    rl = np.array([r or (len(s) if s else 0) for r, s in zip(rl_t, seq_t)], np.int32)
    mate_ref = np.array(mref_t, np.int32)
    mate_pos = np.array(mpos_t, np.int64)
    tlen = np.array(tlen_t, np.int32)
    names, name_off = _packed([r.name.encode() for r in recs])
    seqs, seq_off = _packed([(s or "").encode() for s in seq_t])
    quals, qual_off = _packed([bytes(r.qual) if r.qual is not None else b"" for r in recs])

    # BAM-packed CIGARs (len << 4 | op); a record without one gets no ops
    # (written all-match)
    cig_parts = [[(int(length) << 4) | _CIGAR_OPS[op]
                  for op, length in (getattr(r, "cigar", None) or [])] for r in recs]
    cig_off = np.zeros(n + 1, np.int64)
    np.cumsum([len(p) for p in cig_parts], out=cig_off[1:])
    cig_flat = np.array([v for p in cig_parts for v in p] or [0], dtype=np.uint32)

    c = ctypes

    def p8(a):
        return a.ctypes.data_as(c.POINTER(c.c_uint8))

    def p32(a):
        return a.ctypes.data_as(c.POINTER(c.c_int32))

    def p64(a):
        return a.ctypes.data_as(c.POINTER(c.c_int64))

    crai = (str(path) + ".crai").encode() if build_index else b""
    rc = lib.grid_cram_write(
        str(path).encode(), p8(hdr), len(hdr), n,
        p32(flag), p32(ref_id), p64(pos), p32(mapq), p32(rl),
        p32(mate_ref), p64(mate_pos), p32(tlen),
        p8(names), p64(name_off), p8(seqs), p64(seq_off), p8(quals), p64(qual_off),
        cig_flat.ctypes.data_as(c.POINTER(c.c_uint32)), p64(cig_off),
        int(slice_records), crai,
    )
    if rc != 0:
        raise IOError(f"grid_cram_write({path}) failed with code {rc}")
    return path
