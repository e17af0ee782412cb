"""Phased-genotype panel I/O for the native IBS engine (copy of
``grid_tpu/io/phased.py``).

The reference's IBS workflow requires phased input in BGEN v1.2 prepared
via qctool from a phased VCF (ref examples/IBS_example.sh:102-134,
docs/source/ibs_ibd.rst:96-140). grid_tpu reads BOTH formats directly —
a phased VCF needs no qctool round-trip — plus the Oxford .sample file
and the Eagle genetic-map table used for cM interpolation.

Panels load as ``(sample_ids, H, positions)`` with ``H`` a uint8
``[2N, M]`` matrix: sample ``i``'s two haplotypes are rows ``2i`` (first
allele of the GT / first stored haplotype) and ``2i+1``. Alleles are
0-based indices into the site's (REF, ALT) pair. Sites with any missing
or unphased call are dropped (the PBWT match semantics need complete
phased data); multi-allelic sites are dropped.
"""

from __future__ import annotations

import gzip
import struct
import zlib
from pathlib import Path

import numpy as np

from grid_tpu_torch.io.formats import open_maybe_gz

__all__ = [
    "read_phased_vcf",
    "read_phased_bgen",
    "write_phased_bgen",
    "read_sample_file",
    "write_sample_file",
    "read_genetic_map",
    "interpolate_cm",
]


def read_phased_vcf(path, chrom=None):
    """Load a phased VCF (.vcf / .vcf.gz) into a haplotype panel.

    Keeps biallelic, fully-called, fully-phased diploid sites (optionally
    restricted to ``chrom``). Returns ``(sample_ids, H, positions)``;
    ``positions`` is int64 ascending (input order preserved; VCFs are
    positionally sorted per contig).
    """
    sample_ids: list[str] = []
    rows: list[np.ndarray] = []
    positions: list[int] = []
    with open_maybe_gz(path) as f:
        for line in f:
            if line.startswith("##"):
                continue
            if line.startswith("#CHROM"):
                sample_ids = line.rstrip("\n").split("\t")[9:]
                continue
            if not sample_ids:
                raise ValueError(f"{path}: no #CHROM header before records")
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 10:
                continue
            if chrom is not None and parts[0] != str(chrom) and parts[0] != f"chr{chrom}":
                continue
            alt = parts[4]
            if "," in alt or alt.startswith("<") or alt in (".", ""):
                continue  # multi-allelic / symbolic / no ALT
            fmt = parts[8].split(":")
            try:
                gt_i = fmt.index("GT")
            except ValueError:
                continue
            alleles = np.empty(2 * len(sample_ids), dtype=np.uint8)
            ok = True
            for s, field in enumerate(parts[9:]):
                gt = field.split(":")[gt_i] if ":" in field else field
                if "|" not in gt:
                    ok = False  # unphased or haploid call
                    break
                a, _, b = gt.partition("|")
                if a not in ("0", "1") or b not in ("0", "1"):
                    ok = False  # missing or multi-allelic index
                    break
                alleles[2 * s] = a == "1"
                alleles[2 * s + 1] = b == "1"
            if not ok:
                continue
            positions.append(int(parts[1]))
            rows.append(alleles)
    if not rows:
        return sample_ids, np.zeros((2 * len(sample_ids), 0), dtype=np.uint8), np.zeros(
            0, dtype=np.int64
        )
    H = np.stack(rows, axis=1)
    pos = np.asarray(positions, dtype=np.int64)
    order = np.argsort(pos, kind="stable")
    return sample_ids, np.ascontiguousarray(H[:, order]), pos[order]


def read_sample_file(path):
    """Sample IDs (column ``ID_1``) from an Oxford .sample file: two header
    lines then one row per individual (ref docs/source/ibs_ibd.rst:146-158)."""
    ids = []
    with open_maybe_gz(path) as f:
        header = f.readline().split()
        if not header or header[0] != "ID_1":
            raise ValueError(f"{path}: not an Oxford sample file (missing ID_1)")
        f.readline()  # type row ("0 0 0")
        for line in f:
            parts = line.split()
            if parts:
                ids.append(parts[0])
    return ids


def write_sample_file(path, sample_ids):
    """Write a minimal Oxford .sample file."""
    with open(path, "w") as f:
        f.write("ID_1 ID_2 missing\n0 0 0\n")
        for s in sample_ids:
            f.write(f"{s} {s} 0\n")
    return Path(path)


# ---------------------------------------------------------------------------
# BGEN v1.2 (layout 2, phased, biallelic) — the format the reference's
# external IBS tool consumes (docs/source/ibs_ibd.rst:128-140: layout 2,
# CompressedSNPBlocks=1, Phased=1, bgenBits=16, K=2).


def _read_exact(f, n):
    b = f.read(n)
    if len(b) != n:
        raise ValueError("bgen: truncated file")
    return b


def read_phased_bgen(path, sample_file=None, chrom=None):
    """Load a phased BGEN v1.2 panel.

    Supports layout 2, zlib or uncompressed genotype blocks, phased data,
    biallelic variants, diploid samples, any probability bit width. Sample
    IDs come from the embedded sample-identifier block when present, else
    from ``sample_file``. Sites with any missing haplotype are dropped.
    Returns ``(sample_ids, H, positions)``.
    """
    with open(path, "rb") as f:
        (offset,) = struct.unpack("<I", _read_exact(f, 4))
        (lh,) = struct.unpack("<I", _read_exact(f, 4))
        m_variants, n_samples = struct.unpack("<II", _read_exact(f, 8))
        _read_exact(f, 4)  # magic ("bgen" or zeros)
        if lh > 20:
            _read_exact(f, lh - 20)  # free data area
        (flags,) = struct.unpack("<I", _read_exact(f, 4))
        compression = flags & 0x3
        layout = (flags >> 2) & 0xF
        has_ids = (flags >> 31) & 0x1
        if layout != 2:
            raise ValueError(f"bgen: layout {layout} unsupported (need 2)")
        if compression not in (0, 1):
            raise ValueError(f"bgen: compression {compression} unsupported (0/1)")

        sample_ids = None
        if has_ids:
            _read_exact(f, 4)  # sample block length
            (n_in_block,) = struct.unpack("<I", _read_exact(f, 4))
            if n_in_block != n_samples:
                raise ValueError("bgen: sample block count mismatch")
            sample_ids = []
            for _ in range(n_samples):
                (ln,) = struct.unpack("<H", _read_exact(f, 2))
                sample_ids.append(_read_exact(f, ln).decode())
        if sample_ids is None:
            if sample_file is None:
                raise ValueError(
                    f"{path}: no embedded sample IDs; pass an Oxford sample file"
                )
            sample_ids = read_sample_file(sample_file)
            if len(sample_ids) != n_samples:
                raise ValueError(
                    f"sample file has {len(sample_ids)} IDs, bgen has {n_samples}"
                )

        # Variant data starts offset+4 bytes from the start of the file.
        f.seek(offset + 4)
        rows = []
        positions = []
        for _ in range(m_variants):
            (lid,) = struct.unpack("<H", _read_exact(f, 2))
            _read_exact(f, lid)
            (lrs,) = struct.unpack("<H", _read_exact(f, 2))
            _read_exact(f, lrs)
            (lchr,) = struct.unpack("<H", _read_exact(f, 2))
            var_chrom = _read_exact(f, lchr).decode()
            (pos,) = struct.unpack("<I", _read_exact(f, 4))
            (n_alleles,) = struct.unpack("<H", _read_exact(f, 2))
            for _ in range(n_alleles):
                (la,) = struct.unpack("<I", _read_exact(f, 4))
                _read_exact(f, la)
            (clen,) = struct.unpack("<I", _read_exact(f, 4))
            if compression == 1:
                (dlen,) = struct.unpack("<I", _read_exact(f, 4))
                data = zlib.decompress(_read_exact(f, clen - 4))
                if len(data) != dlen:
                    raise ValueError("bgen: bad uncompressed length")
            else:
                data = _read_exact(f, clen)
            if chrom is not None and var_chrom not in (str(chrom), f"chr{chrom}"):
                continue
            if n_alleles != 2:
                continue
            alleles = _decode_phased_probs(data, n_samples)
            if alleles is None:
                continue
            rows.append(alleles)
            positions.append(pos)

    if not rows:
        return sample_ids, np.zeros((2 * len(sample_ids), 0), dtype=np.uint8), np.zeros(
            0, dtype=np.int64
        )
    H = np.stack(rows, axis=1)
    pos = np.asarray(positions, dtype=np.int64)
    order = np.argsort(pos, kind="stable")
    return sample_ids, np.ascontiguousarray(H[:, order]), pos[order]


def _decode_phased_probs(data, n_samples):
    """Genotype block (already decompressed) -> per-hap 0/1 alleles, or
    None when the site has missing haplotypes / isn't phased diploid.

    Layout-2 phased storage: per haplotype, K-1 probabilities of B bits,
    little-endian bit stream; the stored value is P(allele 1), so the
    haplotype carries allele 2 (index 1) when the value is below half.
    """
    n, k, min_pl, max_pl = struct.unpack("<IHBB", data[:8])
    if n != n_samples or k != 2:
        return None
    ploidy = np.frombuffer(data, dtype=np.uint8, count=n, offset=8)
    phased, bits = struct.unpack("<BB", data[8 + n : 10 + n])
    if phased != 1:
        raise ValueError("bgen: genotype block is unphased (need Phased=1)")
    if min_pl != 2 or max_pl != 2 or not np.all((ploidy & 0x3F) == 2):
        return None  # non-diploid site
    if np.any(ploidy & 0x80):
        return None  # missing haplotypes
    probs = data[10 + n :]
    n_vals = 2 * n  # ploidy 2 x (K-1) values per sample
    if bits == 8:
        vals = np.frombuffer(probs, dtype=np.uint8, count=n_vals).astype(np.uint32)
    elif bits == 16:
        vals = np.frombuffer(probs, dtype="<u2", count=n_vals).astype(np.uint32)
    elif bits == 32:
        vals = np.frombuffer(probs, dtype="<u4", count=n_vals)
    else:
        raw = np.frombuffer(probs, dtype=np.uint8, count=(n_vals * bits + 7) // 8)
        bit_arr = np.unpackbits(raw, bitorder="little")[: n_vals * bits]
        weights = (1 << np.arange(bits, dtype=np.uint64))
        vals = (bit_arr.reshape(n_vals, bits).astype(np.uint64) * weights).sum(axis=1)
    half = float((1 << bits) - 1) / 2.0
    return (vals < half).astype(np.uint8)


def write_phased_bgen(path, sample_ids, H, positions, chrom="1", bits=16):
    """Write a phased, zlib-compressed BGEN v1.2 (layout 2, K=2, embedded
    sample IDs) — the exact flavor the reference workflow prepares with
    qctool. Used by tests/examples and as an interop export."""
    H = np.asarray(H, dtype=np.uint8)
    n = len(sample_ids)
    if H.shape[0] != 2 * n:
        raise ValueError("H must have 2*len(sample_ids) rows")
    m = H.shape[1]
    sample_block = b"".join(
        struct.pack("<H", len(s.encode())) + s.encode() for s in sample_ids
    )
    sample_block = struct.pack("<II", 8 + len(sample_block), n) + sample_block
    header = struct.pack("<IIII", 20, m, n, 0) + struct.pack(
        "<I", (1) | (2 << 2) | (1 << 31)
    )
    offset = len(header) + len(sample_block)
    max_val = (1 << bits) - 1
    with open(path, "wb") as f:
        f.write(struct.pack("<I", offset))
        f.write(header)
        f.write(sample_block)
        for j in range(m):
            vid = f"var{j + 1}".encode()
            chrom_b = str(chrom).encode()
            f.write(struct.pack("<H", len(vid)) + vid)
            f.write(struct.pack("<H", len(vid)) + vid)
            f.write(struct.pack("<H", len(chrom_b)) + chrom_b)
            f.write(struct.pack("<I", int(positions[j])))
            f.write(struct.pack("<H", 2))
            for allele in (b"A", b"G"):
                f.write(struct.pack("<I", len(allele)) + allele)
            # P(allele 1) per haplotype: 0 when the hap carries allele 2.
            vals = np.where(H[:, j] == 0, max_val, 0)
            if bits == 16:
                probs = vals.astype("<u2").tobytes()
            elif bits == 8:
                probs = vals.astype(np.uint8).tobytes()
            elif bits == 32:
                probs = vals.astype("<u4").tobytes()
            else:
                bit_arr = (
                    (vals[:, None] >> np.arange(bits)) & 1
                ).astype(np.uint8).reshape(-1)
                probs = np.packbits(bit_arr, bitorder="little").tobytes()
            block = (
                struct.pack("<IHBB", n, 2, 2, 2)
                + bytes([2]) * n
                + struct.pack("<BB", 1, bits)
                + probs
            )
            comp = zlib.compress(block)
            f.write(struct.pack("<II", len(comp) + 4, len(block)))
            f.write(comp)
    return Path(path)


# ---------------------------------------------------------------------------
# Genetic map (Eagle table format; ref helper add_gen_mapping.py and
# docs/source/ibs_ibd.rst:160-171).


def read_genetic_map(path):
    """(positions, cM) arrays from an Eagle genetic-map table — whitespace-
    separated with 'position' and 'Genetic_Map(cM)' header columns."""
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rt") as f:
        header = f.readline().split()
        pos_i = header.index("position")
        cm_i = header.index("Genetic_Map(cM)")
        gpos, gcm = [], []
        for line in f:
            parts = line.split()
            if len(parts) <= max(pos_i, cm_i) or parts[0].startswith("#"):
                continue
            gpos.append(float(parts[pos_i]))
            gcm.append(float(parts[cm_i]))
    return np.asarray(gpos), np.asarray(gcm)


def interpolate_cm(positions, gpos, gcm):
    """Linear cM interpolation (clamped beyond the map ends, matching
    np.interp / the add-gen-map tool)."""
    return np.interp(np.asarray(positions, dtype=np.float64), gpos, gcm)
