"""Minimal pure-Python BAM writer (BGZF + alignment records).

Write-only companion to the native C++ reader: lets grid_tpu fabricate
coordinate-sorted BAM cohorts (synthetic data, tests, examples) without
pysam/htslib. Implements the BGZF container (gzip members with the BC
size subfield + EOF marker) and the BAM record layout from the SAM spec.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

_BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)

_SEQ_NIBBLE = {"=": 0, "A": 1, "C": 2, "M": 3, "G": 4, "T": 8, "N": 15}
_CIGAR_OPS = {"M": 0, "I": 1, "D": 2, "N": 3, "S": 4, "H": 5, "P": 6, "=": 7, "X": 8}


def _bgzf_block(data: bytes) -> bytes:
    co = zlib.compressobj(6, zlib.DEFLATED, -15)
    cdata = co.compress(data) + co.flush()
    bsize = len(cdata) + 25 + 1  # header(12) + extra(6) + cdata + crc(4) + isize(4)
    header = struct.pack(
        "<BBBBIBBHBBHH",
        0x1F, 0x8B, 8, 4,  # magic, deflate, FEXTRA
        0, 0, 0xFF,  # mtime, xfl, os
        6,  # xlen
        ord("B"), ord("C"), 2, bsize - 1,
    )
    tail = struct.pack("<II", zlib.crc32(data) & 0xFFFFFFFF, len(data))
    return header + cdata + tail


def bgzf_compress(data: bytes, block_size: int = 0xFF00) -> bytes:
    out = bytearray()
    for i in range(0, len(data), block_size):
        out += _bgzf_block(data[i : i + block_size])
    out += _BGZF_EOF
    return bytes(out)


def _reg2bin(beg: int, end: int) -> int:
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


def encode_record(
    refid: int,
    pos: int,
    flag: int,
    mapq: int = 60,
    read_name: str = "r",
    cigar: list[tuple[int, str]] | None = None,
    seq_len: int = 0,
    seq: str | None = None,
    next_refid: int | None = None,
    next_pos: int | None = None,
    tlen: int = 0,
) -> bytes:
    """One BAM alignment record. cigar: [(length, op), ...]. Pass ``seq`` for
    real bases (overrides seq_len); otherwise poly-A filler of seq_len."""
    if seq is not None:
        seq_len = len(seq)
    cigar = cigar or ([(seq_len, "M")] if seq_len else [])
    next_refid = refid if next_refid is None else next_refid
    next_pos = pos if next_pos is None else next_pos

    ref_span = sum(ln for ln, op in cigar if op in "MDN=X")
    name_b = read_name.encode() + b"\0"
    cigar_b = b"".join(struct.pack("<I", (ln << 4) | _CIGAR_OPS[op]) for ln, op in cigar)
    bases = seq if seq is not None else "A" * seq_len
    nib = [_SEQ_NIBBLE.get(b.upper(), 15) for b in bases]
    seq_b = bytes(
        (nib[2 * i] << 4) | (nib[2 * i + 1] if 2 * i + 1 < seq_len else 0)
        for i in range((seq_len + 1) // 2)
    )
    qual_b = b"\xff" * seq_len

    body = struct.pack(
        "<iiBBHHHiiii",
        refid,
        pos,
        len(name_b),
        mapq,
        _reg2bin(pos, pos + max(ref_span, 1)),
        len(cigar),
        flag,
        seq_len,
        next_refid,
        next_pos,
        tlen,
    ) + name_b + cigar_b + seq_b + qual_b
    return struct.pack("<i", len(body)) + body


def write_bam(path, references: list[tuple[str, int]], records: list[bytes]) -> Path:
    """Write a BAM file: references = [(name, length)], records pre-encoded
    with :func:`encode_record` (must be coordinate-sorted by caller)."""
    text = "@HD\tVN:1.6\tSO:coordinate\n" + "".join(
        f"@SQ\tSN:{name}\tLN:{length}\n" for name, length in references
    )
    payload = bytearray()
    payload += b"BAM\1"
    payload += struct.pack("<i", len(text))
    payload += text.encode()
    payload += struct.pack("<i", len(references))
    for name, length in references:
        name_b = name.encode() + b"\0"
        payload += struct.pack("<i", len(name_b)) + name_b + struct.pack("<i", length)
    for rec in records:
        payload += rec

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(bgzf_compress(bytes(payload)))
    return path
