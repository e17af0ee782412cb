"""cramlite: a from-scratch CRAM 3.0 reader/writer (pure Python, stdlib only).

The reference handles CRAM exclusively through pysam/htslib
(grid/utils/count_reads.py:95, grid/utils/utils.py:87). grid_tpu's native
layer covers BAM without htslib; this module extends the same
self-containment to CRAM — the 1000G distribution format — implementing
the CRAM 3.0 container format from the public specification:

- ITF8/LTF8 varints, containers, blocks (raw/gzip/bzip2/lzma/rANS-4x8),
  CRC32 trailers;
- the rANS 4x8 entropy codec (order-0 and order-1, encode AND decode);
- codecs EXTERNAL, HUFFMAN (canonical), BETA, GAMMA, BYTE_ARRAY_STOP,
  BYTE_ARRAY_LEN over core/external bitstreams;
- the full record decode loop (mate info, tag dictionaries, read
  features) with reference-based sequence reconstruction (substitution
  matrix) when a FASTA is supplied;
- CRAI index write/read and region queries;
- a conformant writer (one slice per container, detached mates,
  qualities stored, bases as verbatim feature stretches) used by the
  synthetic-cohort generator and the round-trip tests.

The native C++ twin (grid_tpu/native/src/cram.cpp) implements the read
path at speed; this module is the debuggable fallback and the writer.
A pysam installation remains a supported backend but is no longer
required for CRAM cohorts.

Limitations (documented, checked): no lossy quality modes; reference MD5s
are written but not verified. Embedded-reference slices are supported on
BOTH sides (read always; write via ``write_cram(embed_reference=True)``).
"""

from __future__ import annotations

import bz2
import gzip
import lzma
import struct
import zlib
from dataclasses import dataclass, field
from pathlib import Path

CRAM_MAGIC = b"CRAM"
VERSION = (3, 0)

# block compression methods
RAW, GZIP, BZIP2, LZMA, RANS = 0, 1, 2, 3, 4
# block content types
CT_FILE_HEADER, CT_COMPRESSION_HEADER, CT_SLICE_HEADER, CT_RESERVED, CT_EXTERNAL, CT_CORE = (
    0, 1, 2, 3, 4, 5,
)
# codec ids
C_NULL, C_EXTERNAL, C_GOLOMB, C_HUFFMAN, C_BYTE_ARRAY_LEN, C_BYTE_ARRAY_STOP, C_BETA, C_SUBEXP, C_GOLOMB_RICE, C_GAMMA = range(10)

# BAM flag bits reconstructed from CRAM mate flags (spec §10.2: MF bit 1 =
# mate reverse strand -> 0x20, bit 2 = mate unmapped -> 0x8).
MATE_REVERSE, MATE_UNMAPPED = 0x20, 0x8
# CF bits
CF_QS_STORED, CF_DETACHED, CF_MATE_DOWNSTREAM, CF_NO_SEQ = 1, 2, 4, 8


# ---------------------------------------------------------------------------
# varints


def itf8_encode(v: int) -> bytes:
    v &= 0xFFFFFFFF
    if v < 0x80:
        return bytes([v])
    if v < 0x4000:
        return bytes([0x80 | (v >> 8), v & 0xFF])
    if v < 0x200000:
        return bytes([0xC0 | (v >> 16), (v >> 8) & 0xFF, v & 0xFF])
    if v < 0x10000000:
        return bytes([0xE0 | (v >> 24), (v >> 16) & 0xFF, (v >> 8) & 0xFF, v & 0xFF])
    return bytes([0xF0 | (v >> 28), (v >> 20) & 0xFF, (v >> 12) & 0xFF, (v >> 4) & 0xFF, v & 0x0F])


def ltf8_encode(v: int) -> bytes:
    v &= 0xFFFFFFFFFFFFFFFF
    if v < 0x80:
        return bytes([v])
    if v < 0x4000:
        return bytes([0x80 | (v >> 8), v & 0xFF])
    if v < 0x200000:
        return bytes([0xC0 | (v >> 16), (v >> 8) & 0xFF, v & 0xFF])
    if v < 0x10000000:
        return bytes([0xE0 | (v >> 24), (v >> 16) & 0xFF, (v >> 8) & 0xFF, v & 0xFF])
    if v < 0x800000000:
        return bytes([0xF0 | (v >> 32)]) + v.to_bytes(5, "big")[1:]
    if v < 0x40000000000:
        return bytes([0xF8 | (v >> 40)]) + v.to_bytes(6, "big")[1:]
    if v < 0x2000000000000:
        return bytes([0xFC | (v >> 48)]) + v.to_bytes(7, "big")[1:]
    if v < 0x100000000000000:
        return bytes([0xFE]) + v.to_bytes(7, "big")
    return bytes([0xFF]) + v.to_bytes(8, "big")


class ByteCursor:
    """Sequential reader over bytes with varint helpers."""

    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes, pos: int = 0):
        self.buf = buf
        self.pos = pos

    def read(self, n: int) -> bytes:
        b = self.buf[self.pos : self.pos + n]
        if len(b) != n:
            raise ValueError("cram: truncated stream")
        self.pos += n
        return b

    def byte(self) -> int:
        b = self.buf[self.pos]
        self.pos += 1
        return b

    def itf8(self) -> int:
        b0 = self.byte()
        if b0 < 0x80:
            return b0
        if b0 < 0xC0:
            v = ((b0 & 0x7F) << 8) | self.byte()
        elif b0 < 0xE0:
            v = ((b0 & 0x3F) << 16) | (self.byte() << 8) | self.byte()
        elif b0 < 0xF0:
            v = ((b0 & 0x1F) << 24) | (self.byte() << 16) | (self.byte() << 8) | self.byte()
        else:
            v = ((b0 & 0x0F) << 28) | (self.byte() << 20) | (self.byte() << 12) | (self.byte() << 4)
            v |= self.byte() & 0x0F
        if v >= 0x80000000:
            v -= 0x100000000
        return v

    def ltf8(self) -> int:
        b0 = self.byte()
        # number of extra bytes = count of leading 1 bits in b0
        lead = 0
        for bit in range(7, -1, -1):
            if b0 & (1 << bit):
                lead += 1
            else:
                break
        v = b0 & (0xFF >> (lead + 1)) if lead < 8 else 0
        for _ in range(lead):
            v = (v << 8) | self.byte()
        if v >= 0x8000000000000000:
            v -= 0x10000000000000000
        return v

    def itf8_array(self) -> list[int]:
        return [self.itf8() for _ in range(self.itf8())]


class BitReader:
    """MSB-first bit reader over the core block."""

    __slots__ = ("buf", "pos", "bit")

    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0
        self.bit = 0

    def read_bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            byte = self.buf[self.pos]
            v = (v << 1) | ((byte >> (7 - self.bit)) & 1)
            self.bit += 1
            if self.bit == 8:
                self.bit = 0
                self.pos += 1
        return v


class BitWriter:
    __slots__ = ("out", "acc", "nbits")

    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.nbits = 0

    def write_bits(self, v: int, n: int):
        for i in range(n - 1, -1, -1):
            self.acc = (self.acc << 1) | ((v >> i) & 1)
            self.nbits += 1
            if self.nbits == 8:
                self.out.append(self.acc)
                self.acc = 0
                self.nbits = 0

    def getvalue(self) -> bytes:
        if self.nbits:
            return bytes(self.out) + bytes([self.acc << (8 - self.nbits)])
        return bytes(self.out)


# ---------------------------------------------------------------------------
# rANS 4x8 (CRAM 3.0 entropy codec; spec: CRAM codecs document §2).
# 12-bit normalized frequencies, 4 interleaved states, byte renormalization.

_TF_SHIFT = 12
_TOTFREQ = 1 << _TF_SHIFT
_RANS_L = 1 << 23


def _rans_write_freq(out: bytearray, f: int):
    if f < 128:
        out.append(f)
    else:
        out.append(0x80 | (f >> 8))
        out.append(f & 0xFF)


def _rans_read_freq(c: ByteCursor) -> int:
    f = c.byte()
    if f >= 0x80:
        f = ((f & 0x7F) << 8) | c.byte()
    return f


def _normalize_freqs(counts: list[int], total_target: int) -> list[int]:
    total = sum(counts)
    if total == 0:
        return counts
    freqs = [0] * len(counts)
    # Floor-with-minimum normalization; the most frequent symbol absorbs
    # the rounding residue so the total is exact and every present symbol
    # keeps a nonzero frequency.
    assigned = 0
    for i, cnt in enumerate(counts):
        if cnt == 0:
            continue
        f = max(1, (cnt * total_target) // total)
        freqs[i] = f
        assigned += f
    max_sym = max(range(len(freqs)), key=freqs.__getitem__)
    diff = total_target - assigned
    if freqs[max_sym] + diff <= 0:
        raise ValueError("rans: cannot normalize frequencies")
    freqs[max_sym] += diff
    return freqs


def _write_sym_freqs(out: bytearray, freqs: list[int], write_inner):
    """Symbol table with the spec's ascending-run RLE: a symbol equal to
    prev+1 after another prev+1 triggers an explicit run-length byte."""
    syms = [i for i, f in enumerate(freqs) if f > 0]
    rle = 0
    for j, s in enumerate(syms):
        if rle > 0:
            rle -= 1
        else:
            out.append(s)
            if j > 0 and s == syms[j - 1] + 1:
                # count how many further consecutive symbols follow
                rle = 0
                t = j
                while t + 1 < len(syms) and syms[t + 1] == syms[t] + 1:
                    rle += 1
                    t += 1
                out.append(rle)
        write_inner(out, s)
    out.append(0)


def _read_sym_freqs(c: ByteCursor, read_inner):
    """Read the ascending symbol list with run-length shorthand (htslib
    rANS_static table format): a symbol byte equal to prev+1 is followed by
    a count of FURTHER consecutive symbols; the list ends with a 0 byte
    (symbol 0, being ascending, can only appear first)."""
    sym = c.byte()
    rle = 0
    while True:
        read_inner(c, sym)
        last = sym
        if rle > 0:
            rle -= 1
            sym = last + 1
            if sym > 255:
                raise ValueError("rans: corrupt symbol run")
        else:
            sym = c.byte()
            if sym == 0:
                break
            if sym == last + 1:
                rle = c.byte()


def rans_encode(data: bytes, order: int) -> bytes:
    """rANS 4x8 compress (order 0 or 1). Returns the full codec payload
    (header + frequency table + interleaved states + stream)."""
    if order not in (0, 1):
        raise ValueError("rans: order must be 0 or 1")
    if order == 1 and len(data) < 4:
        order = 0  # tiny inputs: order-1 needs 4 quarters
    n = len(data)
    comp = bytearray()
    if order == 0:
        counts = [0] * 256
        for b in data:
            counts[b] += 1
        if n == 0:
            freqs = [0] * 256
        else:
            freqs = _normalize_freqs(counts, _TOTFREQ)
        cum = [0] * 257
        for i in range(256):
            cum[i + 1] = cum[i] + freqs[i]
        table = bytearray()
        _write_sym_freqs(table, freqs, lambda o, s: _rans_write_freq(o, freqs[s]))
        # encode back-to-front, 4 interleaved states (byte i -> state i%4)
        states = [_RANS_L] * 4
        stream = bytearray()
        for i in range(n - 1, -1, -1):
            s = data[i]
            x = states[i % 4]
            f = freqs[s]
            x_max = ((_RANS_L >> _TF_SHIFT) << 8) * f
            while x >= x_max:
                stream.append(x & 0xFF)
                x >>= 8
            states[i % 4] = ((x // f) << _TF_SHIFT) + (x % f) + cum[s]
        body = b"".join(struct.pack("<I", st) for st in states) + bytes(reversed(stream))
        comp += table + body
    else:
        # order-1: output split into 4 quarters, each encoded with
        # previous-byte context by its own state; quarter starts use ctx 0.
        q = n >> 2
        counts = [[0] * 256 for _ in range(256)]
        for j in range(4):
            lo = j * q
            hi = (j + 1) * q if j < 3 else n
            last = 0
            for i in range(lo, hi):
                counts[last][data[i]] += 1
                last = data[i]
        freqs = [None] * 256
        cums = [None] * 256
        present_ctx = [0] * 256
        for ctx in range(256):
            if sum(counts[ctx]) == 0:
                continue
            present_ctx[ctx] = 1
            f = _normalize_freqs(counts[ctx], _TOTFREQ)
            freqs[ctx] = f
            cum = [0] * 257
            for i in range(256):
                cum[i + 1] = cum[i] + f[i]
            cums[ctx] = cum
        table = bytearray()

        def write_inner(out, ctx):
            _write_sym_freqs(out, freqs[ctx], lambda o, s: _rans_write_freq(o, freqs[ctx][s]))

        _write_sym_freqs(table, present_ctx, write_inner)
        # encode each quarter back-to-front
        states = [_RANS_L] * 4
        stream = bytearray()
        bounds = [(j * q, (j + 1) * q if j < 3 else n) for j in range(4)]
        # interleave: emit renorm bytes into one stream in reverse order of
        # (position, state). Encode globally back-to-front by position index
        # across quarters: process i from max_len-1 down, each quarter's own
        # sequence. Simpler: encode quarters independently back-to-front but
        # interleaved per-position like the reference implementation:
        maxlen = max(hi - lo for lo, hi in bounds)
        for step in range(maxlen - 1, -1, -1):
            for j in range(3, -1, -1):
                lo, hi = bounds[j]
                if step >= hi - lo:
                    continue
                i = lo + step
                last = data[i - 1] if i > lo else 0
                s = data[i]
                f = freqs[last][s]
                x = states[j]
                x_max = ((_RANS_L >> _TF_SHIFT) << 8) * f
                while x >= x_max:
                    stream.append(x & 0xFF)
                    x >>= 8
                states[j] = ((x // f) << _TF_SHIFT) + (x % f) + cums[last][s]
        body = b"".join(struct.pack("<I", st) for st in states) + bytes(reversed(stream))
        comp += table + body
    header = bytes([order]) + struct.pack("<II", len(comp), n)
    return header + bytes(comp)


def rans_decode(payload: bytes) -> bytes:
    c = ByteCursor(payload)
    order = c.byte()
    _comp_sz = struct.unpack("<I", c.read(4))[0]
    out_sz = struct.unpack("<I", c.read(4))[0]
    if out_sz > _MAX_BLOCK:
        raise ValueError("rans: implausible output size")
    if out_sz == 0:
        return b""
    if order == 0:
        freqs = [0] * 256
        cum = [0] * 257

        def inner0(cc, s):
            freqs[s] = _rans_read_freq(cc)

        _read_sym_freqs(c, inner0)
        for i in range(256):
            cum[i + 1] = cum[i] + freqs[i]
        lookup = [0] * _TOTFREQ
        for s in range(256):
            for m in range(cum[s], cum[s + 1]):
                lookup[m] = s
        states = [struct.unpack("<I", c.read(4))[0] for _ in range(4)]
        out = bytearray(out_sz)
        pos = c.pos
        buf = c.buf
        for i in range(out_sz):
            j = i & 3
            x = states[j]
            m = x & (_TOTFREQ - 1)
            s = lookup[m]
            out[i] = s
            x = freqs[s] * (x >> _TF_SHIFT) + m - cum[s]
            while x < _RANS_L and pos < len(buf):
                x = (x << 8) | buf[pos]
                pos += 1
            states[j] = x
        return bytes(out)
    if order == 1:
        freqs = {}
        cums = {}
        lookups = {}

        def inner1(cc, ctx):
            f = [0] * 256

            def leaf(cc2, s):
                f[s] = _rans_read_freq(cc2)

            _read_sym_freqs(cc, leaf)
            cum = [0] * 257
            for i in range(256):
                cum[i + 1] = cum[i] + f[i]
            lut = [0] * _TOTFREQ
            for s in range(256):
                for m in range(cum[s], cum[s + 1]):
                    lut[m] = s
            freqs[ctx] = f
            cums[ctx] = cum
            lookups[ctx] = lut

        _read_sym_freqs(c, inner1)
        states = [struct.unpack("<I", c.read(4))[0] for _ in range(4)]
        out = bytearray(out_sz)
        pos = c.pos
        buf = c.buf
        q = out_sz >> 2
        bounds = [(j * q, (j + 1) * q if j < 3 else out_sz) for j in range(4)]
        lasts = [0, 0, 0, 0]
        maxlen = max(hi - lo for lo, hi in bounds)
        for step in range(maxlen):
            for j in range(4):
                lo, hi = bounds[j]
                if step >= hi - lo:
                    continue
                i = lo + step
                ctx = lasts[j]
                x = states[j]
                m = x & (_TOTFREQ - 1)
                s = lookups[ctx][m]
                out[i] = s
                x = freqs[ctx][s] * (x >> _TF_SHIFT) + m - cums[ctx][s]
                while x < _RANS_L and pos < len(buf):
                    x = (x << 8) | buf[pos]
                    pos += 1
                states[j] = x
                lasts[j] = s
        return bytes(out)
    raise ValueError(f"rans: unknown order {order}")


# ---------------------------------------------------------------------------
# blocks and containers


def _compress(data: bytes, method: int) -> bytes:
    if method == RAW:
        return data
    if method == GZIP:
        return gzip.compress(data)
    if method == RANS:
        return rans_encode(data, 0 if len(data) < 4096 else 1)
    if method == BZIP2:
        return bz2.compress(data)
    if method == LZMA:
        return lzma.compress(data)
    raise ValueError(f"cram: unknown compression method {method}")


def _decompress(data: bytes, method: int, raw_size: int) -> bytes:
    if method == RAW:
        return data
    if method == GZIP:
        return gzip.decompress(data)
    if method == RANS:
        return rans_decode(data)
    if method == BZIP2:
        return bz2.decompress(data)
    if method == LZMA:
        return lzma.decompress(data)
    raise ValueError(f"cram: unknown compression method {method}")


def write_block(out: bytearray, ctype: int, content_id: int, data: bytes,
                method: int = GZIP) -> None:
    comp = _compress(data, method)
    if len(comp) >= len(data):
        method, comp = RAW, data
    blk = bytearray()
    blk.append(method)
    blk.append(ctype)
    blk += itf8_encode(content_id)
    blk += itf8_encode(len(comp))
    blk += itf8_encode(len(data))
    blk += comp
    out += blk
    out += struct.pack("<I", zlib.crc32(bytes(blk)) & 0xFFFFFFFF)


_MAX_BLOCK = 1 << 30  # allocation guard against corrupt size fields


def read_block(c: ByteCursor):
    """-> (content_type, content_id, raw_data)."""
    start = c.pos
    method = c.byte()
    ctype = c.byte()
    content_id = c.itf8()
    comp_size = c.itf8()
    raw_size = c.itf8()
    if not (0 <= comp_size <= _MAX_BLOCK and 0 <= raw_size <= _MAX_BLOCK):
        raise ValueError("cram: implausible block size (corrupt stream)")
    comp = c.read(comp_size)
    stored_crc = struct.unpack("<I", c.read(4))[0]
    actual_crc = zlib.crc32(c.buf[start : c.pos - 4]) & 0xFFFFFFFF
    if stored_crc != actual_crc:
        raise ValueError(f"cram: block CRC mismatch (content type {ctype})")
    data = _decompress(comp, method, raw_size)
    if len(data) != raw_size:
        raise ValueError("cram: block raw-size mismatch")
    return ctype, content_id, data


@dataclass
class ContainerHeader:
    length: int
    ref_id: int
    start: int
    span: int
    n_records: int
    record_counter: int
    n_bases: int
    n_blocks: int
    landmarks: list
    header_size: int = 0  # bytes consumed by the header itself


def write_container_header(ref_id, start, span, n_records, record_counter,
                           n_bases, n_blocks, landmarks, body_length) -> bytes:
    h = bytearray()
    h += struct.pack("<i", body_length)
    h += itf8_encode(ref_id)
    h += itf8_encode(start)
    h += itf8_encode(span)
    h += itf8_encode(n_records)
    h += ltf8_encode(record_counter)
    h += ltf8_encode(n_bases)
    h += itf8_encode(n_blocks)
    h += itf8_encode(len(landmarks))
    for lm in landmarks:
        h += itf8_encode(lm)
    h += struct.pack("<I", zlib.crc32(bytes(h)) & 0xFFFFFFFF)
    return bytes(h)


def read_container_header(c: ByteCursor) -> ContainerHeader:
    start_pos = c.pos
    (length,) = struct.unpack("<i", c.read(4))
    ref_id = c.itf8()
    start = c.itf8()
    span = c.itf8()
    n_records = c.itf8()
    record_counter = c.ltf8()
    n_bases = c.ltf8()
    n_blocks = c.itf8()
    landmarks = c.itf8_array()
    stored_crc = struct.unpack("<I", c.read(4))[0]
    actual = zlib.crc32(c.buf[start_pos : c.pos - 4]) & 0xFFFFFFFF
    if stored_crc != actual:
        raise ValueError("cram: container header CRC mismatch")
    return ContainerHeader(length, ref_id, start, span, n_records,
                           record_counter, n_bases, n_blocks, landmarks,
                           header_size=c.pos - start_pos)


# ---------------------------------------------------------------------------
# encodings / codecs


@dataclass
class Encoding:
    codec: int
    params: bytes

    def to_bytes(self) -> bytes:
        return itf8_encode(self.codec) + itf8_encode(len(self.params)) + self.params

    @staticmethod
    def parse(c: ByteCursor) -> "Encoding":
        codec = c.itf8()
        n = c.itf8()
        return Encoding(codec, c.read(n))


def enc_external(content_id: int) -> Encoding:
    return Encoding(C_EXTERNAL, itf8_encode(content_id))


def enc_huffman_const(value: int) -> Encoding:
    # single-symbol canonical Huffman: zero bits consumed per read
    return Encoding(C_HUFFMAN, itf8_encode(1) + itf8_encode(value) + itf8_encode(1) + itf8_encode(0))


def enc_byte_array_stop(stop: int, content_id: int) -> Encoding:
    return Encoding(C_BYTE_ARRAY_STOP, bytes([stop]) + itf8_encode(content_id))


def enc_byte_array_len(len_enc: Encoding, val_enc: Encoding) -> Encoding:
    return Encoding(C_BYTE_ARRAY_LEN, len_enc.to_bytes() + val_enc.to_bytes())


class Codec:
    """Decoder for one data series, reading from the core bitstream and/or
    external block cursors."""

    def __init__(self, enc: Encoding):
        self.codec = enc.codec
        c = ByteCursor(enc.params)
        if enc.codec == C_EXTERNAL:
            self.content_id = c.itf8()
        elif enc.codec == C_HUFFMAN:
            alphabet = c.itf8_array()
            lengths = c.itf8_array()
            order = sorted(range(len(alphabet)), key=lambda i: (lengths[i], alphabet[i]))
            self.table = []  # (length, code, symbol), canonical ascending
            code = 0
            prev_len = 0
            for i in order:
                ln = lengths[i]
                code <<= ln - prev_len
                prev_len = ln
                self.table.append((ln, code, alphabet[i]))
                code += 1
            self.const = alphabet[order[0]] if len(alphabet) == 1 and lengths[order[0]] == 0 else None
        elif enc.codec == C_BETA:
            self.offset = c.itf8()
            self.nbits = c.itf8()
        elif enc.codec == C_GAMMA:
            self.offset = c.itf8()
        elif enc.codec == C_SUBEXP:
            self.offset = c.itf8()
            self.k = c.itf8()
        elif enc.codec == C_BYTE_ARRAY_STOP:
            self.stop = c.byte()
            self.content_id = c.itf8()
        elif enc.codec == C_BYTE_ARRAY_LEN:
            self.len_codec = Codec(Encoding.parse(c))
            self.val_codec = Codec(Encoding.parse(c))
        elif enc.codec == C_NULL:
            pass
        else:
            raise ValueError(f"cram: unsupported codec id {enc.codec}")

    def read_int(self, core, ext) -> int:
        if self.codec == C_EXTERNAL:
            return ext[self.content_id].itf8()
        if self.codec == C_HUFFMAN:
            if self.const is not None:
                return self.const
            code = 0
            ln = 0
            for length, want, sym in self.table:
                code = (code << (length - ln)) | core.read_bits(length - ln)
                ln = length
                if code == want:
                    return sym
            raise ValueError("cram: bad huffman code")
        if self.codec == C_BETA:
            return core.read_bits(self.nbits) - self.offset
        if self.codec == C_GAMMA:
            z = 0
            while core.read_bits(1) == 0:
                z += 1
            v = (1 << z) | core.read_bits(z) if z else 1
            return v - self.offset
        if self.codec == C_SUBEXP:
            u = 0
            while core.read_bits(1) == 1:
                u += 1
            if u == 0:
                v = core.read_bits(self.k)
            else:
                n = u + self.k - 1
                v = core.read_bits(n) + (1 << n)
            return v - self.offset
        raise ValueError(f"cram: codec {self.codec} cannot read ints")

    def read_byte(self, core, ext) -> int:
        if self.codec == C_EXTERNAL:
            return ext[self.content_id].byte()
        return self.read_int(core, ext)

    def read_bytes(self, core, ext, n: int = -1) -> bytes:
        if self.codec == C_BYTE_ARRAY_STOP:
            cur = ext[self.content_id]
            end = cur.buf.index(bytes([self.stop]), cur.pos)
            out = cur.buf[cur.pos : end]
            cur.pos = end + 1
            return out
        if self.codec == C_BYTE_ARRAY_LEN:
            n = self.len_codec.read_int(core, ext)
            return self.val_codec.read_bytes(core, ext, n)
        if self.codec == C_EXTERNAL:
            if n < 0:
                raise ValueError("cram: EXTERNAL byte array needs a length")
            return ext[self.content_id].read(n)
        if n < 0:
            raise ValueError(f"cram: codec {self.codec} cannot read byte arrays")
        return bytes(self.read_byte(core, ext) for _ in range(n))


# ---------------------------------------------------------------------------
# compression header


@dataclass
class CompressionHeader:
    preservation: dict = field(default_factory=dict)
    series: dict = field(default_factory=dict)       # "BF" -> Encoding
    tag_encodings: dict = field(default_factory=dict)  # int key -> Encoding
    tag_dict: list = field(default_factory=list)     # TL -> [(tag2, type1), ...]

    @property
    def ap_delta(self) -> bool:
        return bool(self.preservation.get("AP", True))

    @property
    def rn_preserved(self) -> bool:
        return bool(self.preservation.get("RN", True))

    def substitution_code_table(self):
        """[5][4] table: ref-base index (ACGTN) x 2-bit code -> read base."""
        sm = self.preservation.get("SM", bytes([0x1B] * 5))
        bases = b"ACGTN"
        table = []
        for ri in range(5):
            alts = [b for b in bases if b != bases[ri]]
            row = [0] * 4
            for t in range(4):
                code = (sm[ri] >> (6 - 2 * t)) & 3
                row[code] = alts[t]
            table.append(row)
        return table

    def to_bytes(self) -> bytes:
        pres = bytearray()
        entries = 0
        for key in ("RN", "AP", "RR"):
            if key in self.preservation:
                pres += key.encode()
                pres.append(1 if self.preservation[key] else 0)
                entries += 1
        if "SM" in self.preservation:
            pres += b"SM" + self.preservation["SM"]
            entries += 1
        td = b"\x00".join(
            b"".join(tag.encode() + typ.encode() for tag, typ in line)
            for line in self.tag_dict
        ) + b"\x00"
        pres += b"TD" + itf8_encode(len(td)) + td
        entries += 1
        pres_map = itf8_encode(entries) + bytes(pres)

        ser = bytearray()
        for key, enc in self.series.items():
            ser += key.encode() + enc.to_bytes()
        ser_map = itf8_encode(len(self.series)) + bytes(ser)

        tags = bytearray()
        for key, enc in self.tag_encodings.items():
            tags += itf8_encode(key) + enc.to_bytes()
        tag_map = itf8_encode(len(self.tag_encodings)) + bytes(tags)

        out = bytearray()
        for m in (pres_map, ser_map, tag_map):
            out += itf8_encode(len(m)) + m
        return bytes(out)

    @staticmethod
    def parse(data: bytes) -> "CompressionHeader":
        h = CompressionHeader()
        c = ByteCursor(data)
        # preservation map
        c.itf8()  # byte size (redundant)
        for _ in range(c.itf8()):
            key = c.read(2).decode()
            if key in ("RN", "AP", "RR"):
                h.preservation[key] = bool(c.byte())
            elif key == "SM":
                h.preservation[key] = c.read(5)
            elif key == "TD":
                n = c.itf8()
                raw = c.read(n)
                lines = raw.split(b"\x00")[:-1]
                h.tag_dict = [
                    [(line[i : i + 2].decode(), chr(line[i + 2])) for i in range(0, len(line), 3)]
                    for line in lines
                ]
            else:
                raise ValueError(f"cram: unknown preservation key {key}")
        c.itf8()
        for _ in range(c.itf8()):
            key = c.read(2).decode()
            h.series[key] = Encoding.parse(c)
        c.itf8()
        for _ in range(c.itf8()):
            key = c.itf8()
            h.tag_encodings[key] = Encoding.parse(c)
        if not h.tag_dict:
            h.tag_dict = [[]]
        return h


# ---------------------------------------------------------------------------
# slice header


@dataclass
class SliceHeader:
    ref_id: int
    start: int
    span: int
    n_records: int
    record_counter: int
    n_blocks: int
    content_ids: list
    embedded_ref_id: int = -1
    ref_md5: bytes = b"\x00" * 16
    tags: bytes = b""

    def to_bytes(self) -> bytes:
        out = bytearray()
        out += itf8_encode(self.ref_id)
        out += itf8_encode(self.start)
        out += itf8_encode(self.span)
        out += itf8_encode(self.n_records)
        out += ltf8_encode(self.record_counter)
        out += itf8_encode(self.n_blocks)
        out += itf8_encode(len(self.content_ids))
        for cid in self.content_ids:
            out += itf8_encode(cid)
        out += itf8_encode(self.embedded_ref_id)
        out += self.ref_md5
        out += self.tags
        return bytes(out)

    @staticmethod
    def parse(data: bytes) -> "SliceHeader":
        c = ByteCursor(data)
        ref_id = c.itf8()
        start = c.itf8()
        span = c.itf8()
        n_records = c.itf8()
        record_counter = c.ltf8()
        n_blocks = c.itf8()
        content_ids = c.itf8_array()
        embedded = c.itf8()
        md5 = c.read(16)
        return SliceHeader(ref_id, start, span, n_records, record_counter,
                           n_blocks, content_ids, embedded, md5,
                           data[c.pos:])


# ---------------------------------------------------------------------------
# records


@dataclass
class CramRecord:
    name: str = ""
    flag: int = 0
    ref_id: int = -1
    pos: int = -1          # 0-based leftmost position
    mapq: int = 0
    rl: int = 0
    seq: str | None = None
    qual: bytes | None = None
    mate_ref_id: int = -1
    mate_pos: int = -1
    tlen: int = 0
    tags: list = field(default_factory=list)  # (tag, type, raw bytes)
    ref_len: int = 0       # reference bases consumed
    # [(op, length)] SAM CIGAR, reconstructed from the record's features on
    # read and re-encoded as features on write (D/N/I/S/H/P preserved).
    # None = unknown (treated as all-M by writers, the pre-round-3 behavior).
    cigar: list | None = None


_BASES = b"ACGTN"
_BASE_INDEX = {b: i for i, b in enumerate(_BASES)}


def _decode_slice_records(comp: CompressionHeader, sh: SliceHeader, core: BitReader,
                          ext: dict, ref_fetch=None):
    """The CRAM 3.0 record decode loop (spec §10; field order as in the
    reference htslib implementation)."""
    codecs: dict[str, Codec] = {}

    def codec(key: str) -> Codec:
        cd = codecs.get(key)
        if cd is None:
            enc = comp.series.get(key)
            if enc is None:
                raise ValueError(f"cram: data series {key} required but not encoded")
            cd = codecs[key] = Codec(enc)
        return cd

    tag_codecs: dict[int, Codec] = {}
    sub_table = comp.substitution_code_table()
    records: list[CramRecord] = []
    downstream: list[tuple[int, int]] = []  # (record index, NF)
    prev_ap = sh.start

    for _ in range(sh.n_records):
        r = CramRecord()
        bf = codec("BF").read_int(core, ext)
        cf = codec("CF").read_int(core, ext)
        r.ref_id = sh.ref_id if sh.ref_id != -2 else codec("RI").read_int(core, ext)
        r.rl = codec("RL").read_int(core, ext)
        if comp.ap_delta:
            ap = prev_ap + codec("AP").read_int(core, ext)
            prev_ap = ap
        else:
            ap = codec("AP").read_int(core, ext)
        r.pos = ap - 1
        codec("RG").read_int(core, ext)  # read group (unused downstream)
        if comp.rn_preserved:
            r.name = codec("RN").read_bytes(core, ext).decode()
        mf = 0
        if cf & CF_DETACHED:
            mf = codec("MF").read_int(core, ext)
            if not comp.rn_preserved:
                r.name = codec("RN").read_bytes(core, ext).decode()
            r.mate_ref_id = codec("NS").read_int(core, ext)
            r.mate_pos = codec("NP").read_int(core, ext) - 1
            r.tlen = codec("TS").read_int(core, ext)
        elif cf & CF_MATE_DOWNSTREAM:
            downstream.append((len(records), codec("NF").read_int(core, ext)))
        tl = codec("TL").read_int(core, ext)
        for tag, typ in comp.tag_dict[tl]:
            key = (ord(tag[0]) << 16) | (ord(tag[1]) << 8) | ord(typ)
            tc = tag_codecs.get(key)
            if tc is None:
                enc = comp.tag_encodings.get(key)
                if enc is None:
                    raise ValueError(f"cram: tag {tag}:{typ} has no encoding")
                tc = tag_codecs[key] = Codec(enc)
            r.tags.append((tag, typ, tc.read_bytes(core, ext)))

        if not (bf & 0x4):  # mapped
            fn = codec("FN").read_int(core, ext)
            feats = []
            fpos = 0
            for _f in range(fn):
                fc = chr(codec("FC").read_byte(core, ext))
                fpos += codec("FP").read_int(core, ext)
                if fc == "B":
                    op = (codec("BA").read_byte(core, ext), codec("QS").read_byte(core, ext))
                elif fc == "X":
                    op = codec("BS").read_byte(core, ext)
                elif fc == "I":
                    op = codec("IN").read_bytes(core, ext)
                elif fc == "S":
                    op = codec("SC").read_bytes(core, ext)
                elif fc == "b":
                    op = codec("BB").read_bytes(core, ext)
                elif fc == "q":
                    op = codec("QQ").read_bytes(core, ext)
                elif fc == "D":
                    op = codec("DL").read_int(core, ext)
                elif fc == "N":
                    op = codec("RS").read_int(core, ext)
                elif fc == "P":
                    op = codec("PD").read_int(core, ext)
                elif fc == "H":
                    op = codec("HC").read_int(core, ext)
                elif fc == "i":
                    op = codec("BA").read_byte(core, ext)
                elif fc == "Q":
                    op = codec("QS").read_byte(core, ext)
                else:
                    raise ValueError(f"cram: unknown feature code {fc!r}")
                feats.append((fc, fpos, op))
            r.mapq = codec("MQ").read_int(core, ext)
            qual = bytearray(b"\xff" * r.rl)
            if cf & CF_QS_STORED:
                qual = bytearray(codec("QS").read_bytes(core, ext, r.rl))
            r.ref_len = _ref_len_from_features(feats, r.rl)
            r.cigar = _cigar_from_features(feats, r.rl)
            if cf & CF_NO_SEQ:
                r.seq = None
            else:
                r.seq = _reconstruct_seq(feats, r.rl, r.ref_id, r.pos, sub_table,
                                         ref_fetch, qual)
            r.qual = bytes(qual)
        else:  # unmapped
            r.mapq = 0
            r.ref_len = 0
            if not (cf & CF_NO_SEQ):
                r.seq = codec("BA").read_bytes(core, ext, r.rl).decode("ascii", "replace")
            if cf & CF_QS_STORED:
                r.qual = codec("QS").read_bytes(core, ext, r.rl)

        r.flag = bf | (MATE_REVERSE if (mf & 1) else 0) | (MATE_UNMAPPED if (mf & 2) else 0)
        records.append(r)

    # Resolve mate-downstream pairs (NF = records between this and its mate).
    for i, nf in downstream:
        j = i + nf + 1
        if j >= len(records):
            continue
        a, b = records[i], records[j]
        a.mate_ref_id, a.mate_pos = b.ref_id, b.pos
        b.mate_ref_id, b.mate_pos = a.ref_id, a.pos
        a.flag |= (MATE_REVERSE if (b.flag & 0x10) else 0) | (MATE_UNMAPPED if (b.flag & 0x4) else 0)
        b.flag |= (MATE_REVERSE if (a.flag & 0x10) else 0) | (MATE_UNMAPPED if (a.flag & 0x4) else 0)
        left = min(a.pos, b.pos)
        right = max(a.pos + max(a.ref_len, 1), b.pos + max(b.ref_len, 1))
        tlen = right - left
        a.tlen = tlen if a.pos <= b.pos else -tlen
        b.tlen = -a.tlen
    return records


def _ref_len_from_features(feats, rl: int) -> int:
    ref_len = rl
    for fc, _fpos, op in feats:
        if fc == "D":
            ref_len += op
        elif fc == "N":
            ref_len += op
        elif fc == "I":
            ref_len -= len(op)
        elif fc == "S":
            ref_len -= len(op)
        elif fc == "i":
            ref_len -= 1
        elif fc == "H" or fc == "P":
            pass
    return max(ref_len, 0)


def _cigar_from_features(feats, rl: int):
    """SAM CIGAR from a record's feature list (spec §10.4 semantics: FP is
    the 1-based read position of the feature; read positions not covered by
    a read-consuming feature are matches). X/B single-base features and 'b'
    stretches reconstruct as M — htslib does the same."""
    ops: list[list] = []

    def add(op, n):
        if n <= 0:
            return
        if ops and ops[-1][0] == op:
            ops[-1][1] += n
        else:
            ops.append([op, n])

    rp = 1  # next unconsumed read base, 1-based
    for fc, fpos, op in feats:
        if fc in ("q", "Q"):  # quality-only features: no CIGAR effect
            continue
        add("M", fpos - rp)
        rp = max(rp, fpos)
        if fc == "S":
            add("S", len(op))
            rp += len(op)
        elif fc == "I":
            add("I", len(op))
            rp += len(op)
        elif fc == "i":
            add("I", 1)
            rp += 1
        elif fc == "b":
            add("M", len(op))
            rp += len(op)
        elif fc in ("B", "X"):
            add("M", 1)
            rp += 1
        elif fc == "D":
            add("D", op)
        elif fc == "N":
            add("N", op)
        elif fc == "P":
            add("P", op)
        elif fc == "H":
            add("H", op)
    add("M", rl - rp + 1)
    return [(op, n) for op, n in ops]


def _cigar_ref_len(cigar) -> int:
    """Reference bases consumed by a CIGAR (M/D/N/=/X)."""
    return sum(n for op, n in cigar if op in "MDN=X")


def _cigar_read_len(cigar) -> int:
    """Read bases consumed by a CIGAR (M/I/S/=/X)."""
    return sum(n for op, n in cigar if op in "MIS=X")


def _cigar_is_trivial(cigar) -> bool:
    """True when the CIGAR is absent or pure match — the verbatim
    base-stretch encoding already represents it exactly."""
    return cigar is None or all(op in "M=X" for op, _n in cigar)


def _features_from_cigar(cigar, seq: bytes, ref_fetch, ref_id, pos0,
                         skip_match: bool = False):
    """Feature list [(fc, fpos, payload)] encoding a read with the given
    CIGAR. M/=/X segments become substitution features when a reference is
    at hand and the segment matches it ACGTN-wise (same rule as
    _substitution_features), else verbatim 'b' stretches; S/I/D/N/H/P map
    to their CRAM feature codes. ``skip_match`` emits no feature for M
    segments at all (the CF_NO_SEQ path: bases are unknown, only the
    alignment geometry matters)."""
    feats = []
    rp = 1          # 1-based read cursor
    roff = pos0     # 0-based reference cursor
    for op, n in cigar:
        if op in "M=X":
            if skip_match:
                rp += n
                roff += n
                continue
            seg = seq[rp - 1 : rp - 1 + n]
            subs = None
            if ref_fetch is not None and ref_id >= 0:
                ref = ref_fetch(ref_id, roff, roff + n)
                if ref:
                    subs = _substitution_features(seg.decode("ascii"), ref)
            if subs is not None:
                for j, code in subs:
                    feats.append(("X", rp + j - 1, code))
            else:
                feats.append(("b", rp, seg))
            rp += n
            roff += n
        elif op == "I":
            feats.append(("I", rp, seq[rp - 1 : rp - 1 + n]))
            rp += n
        elif op == "S":
            feats.append(("S", rp, seq[rp - 1 : rp - 1 + n]))
            rp += n
        elif op == "D":
            feats.append(("D", rp, n))
            roff += n
        elif op == "N":
            feats.append(("N", rp, n))
            roff += n
        elif op == "H":
            feats.append(("H", rp, n))
        elif op == "P":
            feats.append(("P", rp, n))
        else:
            raise ValueError(f"cram: unsupported CIGAR op {op!r}")
    return feats


def _reconstruct_seq(feats, rl, ref_id, pos0, sub_table, ref_fetch, qual):
    """Rebuild SEQ from reference bases + features. Without a reference,
    match stretches become 'N' (positions/flags stay exact)."""
    seq = bytearray(b"N" * rl)
    ref = None
    if ref_fetch is not None and ref_id >= 0:
        span = _ref_len_from_features(feats, rl)
        ref = ref_fetch(ref_id, pos0, pos0 + span)

    def ref_base(roff):
        if ref is None or roff < 0 or roff >= len(ref):
            return ord("N")
        return ref[roff]

    rpos = 0  # read cursor (0-based)
    roff = 0  # reference offset from pos0

    def fill_match(upto):
        nonlocal rpos, roff
        while rpos < upto:
            seq[rpos] = ref_base(roff)
            rpos += 1
            roff += 1

    for fc, fpos, op in feats:
        fill_match(fpos - 1)
        if fc == "B":
            seq[rpos] = op[0]
            qual[rpos] = op[1]
            rpos += 1
            roff += 1
        elif fc == "X":
            rb = ref_base(roff)
            ri = _BASE_INDEX.get(rb, 4)
            seq[rpos] = sub_table[ri][op]
            rpos += 1
            roff += 1
        elif fc == "I":
            seq[rpos : rpos + len(op)] = op
            rpos += len(op)
        elif fc == "S":
            seq[rpos : rpos + len(op)] = op
            rpos += len(op)
        elif fc == "i":
            seq[rpos] = op
            rpos += 1
        elif fc == "b":
            seq[rpos : rpos + len(op)] = op
            rpos += len(op)
            roff += len(op)
        elif fc == "q":
            qual[rpos : rpos + len(op)] = op
        elif fc == "Q":
            qual[fpos - 1] = op
        elif fc == "D":
            roff += op
        elif fc == "N":
            roff += op
        elif fc in ("P", "H"):
            pass
    fill_match(rl)
    return seq.decode("ascii", "replace")


# ---------------------------------------------------------------------------
# writer


_SERIES_IDS = {
    "BF": 1, "CF": 2, "RL": 3, "AP": 4, "MF": 5, "NS": 6, "NP": 7, "TS": 8,
    "RN": 9, "FN": 10, "FC": 11, "FP": 12, "BB_len": 13, "BB_val": 14,
    "QS": 15, "MQ": 16, "BA": 17, "RI": 18, "BS": 19,
    # 20 is _EMBEDDED_REF_ID; CIGAR-feature series (round 3):
    "SC": 21, "IN": 22, "DL": 23, "RS": 24, "PD": 25, "HC": 26,
}


def _writer_compression_header(multi_ref: bool) -> CompressionHeader:
    ids = _SERIES_IDS
    h = CompressionHeader()
    h.preservation = {"RN": True, "AP": True, "RR": True, "SM": bytes([0x1B] * 5)}
    h.tag_dict = [[]]
    series = {
        "BF": enc_external(ids["BF"]),
        "CF": enc_external(ids["CF"]),
        "RL": enc_external(ids["RL"]),
        "AP": enc_external(ids["AP"]),
        "RG": enc_huffman_const(-1),
        "RN": enc_byte_array_stop(0, ids["RN"]),
        "MF": enc_external(ids["MF"]),
        "NS": enc_external(ids["NS"]),
        "NP": enc_external(ids["NP"]),
        "TS": enc_external(ids["TS"]),
        "TL": enc_huffman_const(0),
        "FN": enc_external(ids["FN"]),
        "FC": enc_external(ids["FC"]),
        "FP": enc_external(ids["FP"]),
        "BB": enc_byte_array_len(enc_external(ids["BB_len"]), enc_external(ids["BB_val"])),
        "QS": enc_external(ids["QS"]),
        "MQ": enc_external(ids["MQ"]),
        "BA": enc_external(ids["BA"]),
        "BS": enc_external(ids["BS"]),
        # CIGAR-feature series; declared-but-absent blocks are fine (readers
        # instantiate codecs lazily, exactly as BA already behaves for
        # all-mapped slices)
        "SC": enc_byte_array_stop(0, ids["SC"]),
        "IN": enc_byte_array_stop(0, ids["IN"]),
        "DL": enc_external(ids["DL"]),
        "RS": enc_external(ids["RS"]),
        "PD": enc_external(ids["PD"]),
        "HC": enc_external(ids["HC"]),
    }
    if multi_ref:
        series["RI"] = enc_external(ids["RI"])
    h.series = series
    return h


def _substitution_features(seq: str, ref: bytes):
    """Encode a read as X substitution features against the reference
    (writer-side SM = identity code table: code = rank of the read base
    among the ref base's alternatives in ACGTN order). Returns None when
    the read can't be expressed that way (off-reference, non-ACGTN)."""
    if len(ref) != len(seq):
        return None
    feats = []
    for j, (sb, rb) in enumerate(zip(seq.encode(), ref)):
        if sb == rb:
            continue
        ri = _BASE_INDEX.get(rb)
        if ri is None:
            return None
        alts = [b for b in _BASES if b != rb]
        if sb not in alts:
            return None
        feats.append((j + 1, alts.index(sb)))
    return feats


_EMBEDDED_REF_ID = 20  # external content id for embedded-reference blocks


def _encode_slice(records: list[CramRecord], record_counter: int, method: int,
                  ref_fetch=None, embed_ref: bool = False):
    """-> (container_body_bytes, slice_meta) for one slice-per-container."""
    ids = _SERIES_IDS
    bufs = {key: bytearray() for key in ids}
    ref_ids = {r.ref_id for r in records}
    multi_ref = len(ref_ids) != 1
    slice_ref = records[0].ref_id if not multi_ref else -2
    mapped = [r for r in records if r.ref_id >= 0 and r.pos >= 0]
    if mapped and not multi_ref:
        s_start = min(r.pos for r in mapped) + 1
        s_span = max(r.pos + max(r.ref_len or r.rl, 1) for r in mapped) - s_start + 1
    else:
        s_start, s_span = 0, 0

    # Embedded-reference slice (spec §8.5): store the slice's reference
    # window as an external block and encode reads against it — the file
    # then decodes without any FASTA at hand (the read side already
    # consumes these, _decode_body). Requires a single-ref mapped slice
    # and a complete reference window.
    embedded_seq = None
    if embed_ref and ref_fetch is not None and not multi_ref and s_span > 0 \
            and slice_ref >= 0:
        window = ref_fetch(slice_ref, s_start - 1, s_start - 1 + s_span)
        if window and len(window) == s_span:
            embedded_seq = bytes(window)

            def ref_fetch(rid, s, e, _w=embedded_seq, _r0=s_start - 1):  # noqa: ANN001
                return _w[s - _r0:e - _r0]

    prev_ap = s_start
    n_bases = 0

    for r in records:
        rl = r.rl or (len(r.seq) if r.seq else 0)
        n_bases += rl
        cf = CF_DETACHED
        if r.qual is not None:
            cf |= CF_QS_STORED
        if r.seq is None:
            cf |= CF_NO_SEQ
        bufs["BF"] += itf8_encode(r.flag & ~(MATE_REVERSE | MATE_UNMAPPED))
        bufs["CF"] += itf8_encode(cf)
        if multi_ref:
            bufs["RI"] += itf8_encode(r.ref_id)
        bufs["RL"] += itf8_encode(rl)
        ap = r.pos + 1
        bufs["AP"] += itf8_encode(ap - prev_ap)
        prev_ap = ap
        bufs["RN"] += r.name.encode() + b"\x00"
        mf = (1 if (r.flag & MATE_REVERSE) else 0) | (2 if (r.flag & MATE_UNMAPPED) else 0)
        bufs["MF"] += itf8_encode(mf)
        bufs["NS"] += itf8_encode(r.mate_ref_id)
        bufs["NP"] += itf8_encode(r.mate_pos + 1)
        bufs["TS"] += itf8_encode(r.tlen)
        if not (r.flag & 0x4):  # mapped
            if r.seq is None:
                # SEQ "*" but a real CIGAR (CF_NO_SEQ is set above): emit
                # the positional features so the alignment geometry
                # survives the round trip — S/I carry placeholder 'N'
                # stretches (the reader ignores bases under CF_NO_SEQ and
                # rebuilds the CIGAR from the feature lengths); M segments
                # need no feature at all.
                feats = (
                    []
                    if _cigar_is_trivial(r.cigar)
                    else _features_from_cigar(
                        r.cigar, b"N" * rl, None, r.ref_id, r.pos,
                        skip_match=True,
                    )
                )
                bufs["FN"] += itf8_encode(len(feats))
                prev_fp = 0
                for fc, fpos, payload in feats:
                    bufs["FC"].append(ord(fc))
                    bufs["FP"] += itf8_encode(fpos - prev_fp)
                    prev_fp = fpos
                    if fc == "S":
                        bufs["SC"] += payload + b"\x00"
                    elif fc == "I":
                        bufs["IN"] += payload + b"\x00"
                    elif fc == "D":
                        bufs["DL"] += itf8_encode(payload)
                    elif fc == "N":
                        bufs["RS"] += itf8_encode(payload)
                    elif fc == "P":
                        bufs["PD"] += itf8_encode(payload)
                    elif fc == "H":
                        bufs["HC"] += itf8_encode(payload)
            elif not _cigar_is_trivial(r.cigar):
                # CIGAR-preserving encode: S/I/D/N/H/P become their CRAM
                # feature codes; M segments substitution-encode vs the
                # reference when one is at hand, else verbatim stretches.
                feats = _features_from_cigar(r.cigar, r.seq.encode(),
                                             ref_fetch, r.ref_id, r.pos)
                bufs["FN"] += itf8_encode(len(feats))
                prev_fp = 0
                for fc, fpos, payload in feats:
                    bufs["FC"].append(ord(fc))
                    bufs["FP"] += itf8_encode(fpos - prev_fp)
                    prev_fp = fpos
                    if fc == "b":
                        bufs["BB_len"] += itf8_encode(len(payload))
                        bufs["BB_val"] += payload
                    elif fc == "X":
                        bufs["BS"].append(payload)
                    elif fc == "S":
                        bufs["SC"] += payload + b"\x00"
                    elif fc == "I":
                        bufs["IN"] += payload + b"\x00"
                    elif fc == "D":
                        bufs["DL"] += itf8_encode(payload)
                    elif fc == "N":
                        bufs["RS"] += itf8_encode(payload)
                    elif fc == "P":
                        bufs["PD"] += itf8_encode(payload)
                    elif fc == "H":
                        bufs["HC"] += itf8_encode(payload)
            else:
                feats = None
                if ref_fetch is not None:
                    ref = ref_fetch(r.ref_id, r.pos, r.pos + rl)
                    if ref:
                        feats = _substitution_features(r.seq, ref)
                if feats is not None:
                    bufs["FN"] += itf8_encode(len(feats))
                    prev_fp = 0
                    for fpos, code in feats:
                        bufs["FC"].append(ord("X"))
                        bufs["FP"] += itf8_encode(fpos - prev_fp)
                        prev_fp = fpos
                        bufs["BS"].append(code)
                else:
                    seq = r.seq.encode()
                    bufs["FN"] += itf8_encode(1)
                    bufs["FC"].append(ord("b"))
                    bufs["FP"] += itf8_encode(1)
                    bufs["BB_len"] += itf8_encode(len(seq))
                    bufs["BB_val"] += seq
            bufs["MQ"] += itf8_encode(r.mapq)
            if r.qual is not None:
                if len(r.qual) != rl:
                    raise ValueError("cram: qual length != read length")
                bufs["QS"] += r.qual
        else:
            if r.seq is not None:
                bufs["BA"] += r.seq.encode()
            if r.qual is not None:
                bufs["QS"] += r.qual

    comp = _writer_compression_header(multi_ref)
    used = [(key, bytes(b)) for key, b in bufs.items() if b]
    content_ids = [ids[key] for key, _ in used]
    if embedded_seq is not None:
        content_ids = content_ids + [_EMBEDDED_REF_ID]

    body = bytearray()
    write_block(body, CT_COMPRESSION_HEADER, 0, comp.to_bytes(), method=GZIP)
    landmark = len(body)
    n_data_blocks = 1 + len(used) + (1 if embedded_seq is not None else 0)
    sh = SliceHeader(
        ref_id=slice_ref, start=s_start, span=s_span, n_records=len(records),
        record_counter=record_counter, n_blocks=n_data_blocks,
        content_ids=content_ids,
        embedded_ref_id=_EMBEDDED_REF_ID if embedded_seq is not None else -1,
    )
    write_block(body, CT_SLICE_HEADER, 0, sh.to_bytes(), method=RAW)
    write_block(body, CT_CORE, 0, b"", method=RAW)
    for key, data in used:
        write_block(body, CT_EXTERNAL, ids[key], data, method=method)
    if embedded_seq is not None:
        write_block(body, CT_EXTERNAL, _EMBEDDED_REF_ID, embedded_seq, method=method)
    # container block count: compression header + slice header + data blocks
    meta = dict(ref_id=slice_ref, start=s_start, span=s_span, landmark=landmark,
                n_records=len(records), n_bases=n_bases,
                n_blocks=2 + n_data_blocks)
    return bytes(body), meta


def write_cram(path, references, records, slice_records: int = 10_000,
               method: int = GZIP, build_index: bool = True,
               sam_header: str | None = None, reference=None,
               embed_reference: bool = False):
    """Write a CRAM 3.0 file (one slice per container, detached mates).

    Args:
      references: [(name, length)] reference dictionary.
      records: iterable of :class:`CramRecord` (or dicts with its fields).
      method: block compression for data series (GZIP or RANS).
      build_index: also write ``{path}.crai``.
      reference: optional FASTA path — mapped reads are then stored as
        substitution features against it (real CRAM reference-based
        compression) instead of verbatim base stretches.
      embed_reference: with ``reference``, additionally store each slice's
        reference window as an embedded block (spec §8.5) — the output then
        decodes WITHOUT the FASTA (the portable-archive mode; costs the
        compressed window per slice).
    """
    path = Path(path)
    ref_fetch = None
    if reference is not None:
        fasta = reference if isinstance(reference, FastaReference) else FastaReference(reference)
        names = [name for name, _ in references]

        def ref_fetch(rid, s, e):  # noqa: ANN001
            return fasta.fetch(names[rid], s, e) if 0 <= rid < len(names) else b""

    recs = [r if isinstance(r, CramRecord) else CramRecord(**r) for r in records]
    for r in recs:
        if r.rl == 0 and r.seq:
            r.rl = len(r.seq)
        if r.cigar and r.seq is None and r.rl == 0 and not _cigar_is_trivial(r.cigar):
            # SEQ "*" with an unknown length: the CIGAR is the only
            # read-length carrier — heal rl so the S/I placeholder
            # payloads are cut to the right size
            r.rl = _cigar_read_len(r.cigar)
        if r.cigar and _cigar_read_len(r.cigar) != r.rl:
            # applies to seq-less records too: a short rl would silently
            # truncate the S/I placeholder payloads and corrupt the
            # round-tripped CIGAR (and diverge from the C twin, which
            # sizes payloads from the CIGAR)
            raise ValueError(
                f"cram: CIGAR read length {_cigar_read_len(r.cigar)} != "
                f"rl {r.rl} for {r.name!r}"
            )
        if r.ref_len == 0 and not (r.flag & 0x4):
            # verbatim stretches consume ref 1:1; a CIGAR knows better
            r.ref_len = _cigar_ref_len(r.cigar) if r.cigar else r.rl
    if sam_header is None:
        sam_header = "@HD\tVN:1.6\tSO:coordinate\n" + "".join(
            f"@SQ\tSN:{name}\tLN:{length}\n" for name, length in references
        )
    crai_entries = []
    with open(path, "wb") as f:
        f.write(CRAM_MAGIC + bytes(VERSION))
        file_id = path.name.encode()[:20]
        f.write(file_id + b"\x00" * (20 - len(file_id)))

        # SAM header container
        hdr_text = sam_header.encode()
        hdr_data = struct.pack("<i", len(hdr_text)) + hdr_text
        body = bytearray()
        write_block(body, CT_FILE_HEADER, 0, hdr_data, method=RAW)
        f.write(write_container_header(0, 0, 0, 0, 0, 0, 1, [0], len(body)))
        f.write(body)

        counter = 0
        for lo in range(0, len(recs), slice_records):
            chunk = recs[lo : lo + slice_records]
            body, meta = _encode_slice(chunk, counter, method, ref_fetch,
                                       embed_ref=embed_reference)
            hdr = write_container_header(
                meta["ref_id"], meta["start"], meta["span"], meta["n_records"],
                counter, meta["n_bases"], meta["n_blocks"], [meta["landmark"]],
                len(body),
            )
            c_off = f.tell()
            f.write(hdr)
            f.write(body)
            counter += meta["n_records"]
            crai_entries.append((
                meta["ref_id"], meta["start"], meta["span"], c_off,
                meta["landmark"], len(body) - meta["landmark"],
            ))

        # EOF container (spec §9: empty compression-header container at
        # "EOF" = position 4542278).
        eof_body = bytearray()
        write_block(eof_body, CT_COMPRESSION_HEADER, 0, b"\x01\x00\x01\x00\x01\x00",
                    method=RAW)
        f.write(write_container_header(-1, 4_542_278, 0, 0, 0, 0, 1, [], len(eof_body)))
        f.write(eof_body)

    if build_index:
        write_crai(str(path) + ".crai", crai_entries)
    return path


def write_crai(path, entries):
    """CRAI: gzipped text, one line per slice
    (seq_id, start, span, container_offset, slice_offset, slice_size)."""
    with gzip.open(path, "wt") as f:
        for e in entries:
            f.write("\t".join(str(int(v)) for v in e) + "\n")
    return Path(path)


def read_crai(path):
    out = []
    with gzip.open(path, "rt") as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 6:
                out.append(tuple(int(v) for v in parts[:6]))
    return out


# ---------------------------------------------------------------------------
# FASTA (reference for sequence reconstruction)


class FastaReference:
    """Windowed FASTA fetch; uses .fai when present, else loads in memory."""

    def __init__(self, path):
        self.path = str(path)
        self._fai = {}
        self._mem = None
        fai = self.path + ".fai"
        import os

        if os.path.exists(fai):
            with open(fai) as f:
                for line in f:
                    parts = line.split("\t")
                    if len(parts) >= 5:
                        self._fai[parts[0]] = (
                            int(parts[1]), int(parts[2]), int(parts[3]), int(parts[4])
                        )
            self._f = open(self.path, "rb")
        else:
            self._mem = {}
            name = None
            chunks: list[str] = []
            with open(self.path) as f:
                for line in f:
                    line = line.strip()
                    if line.startswith(">"):
                        if name is not None:
                            self._mem[name] = "".join(chunks).upper().encode()
                        name = line[1:].split()[0]
                        chunks = []
                    else:
                        chunks.append(line)
            if name is not None:
                self._mem[name] = "".join(chunks).upper().encode()

    def close(self):
        f = getattr(self, "_f", None)
        if f is not None and not f.closed:
            f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def fetch(self, name, start, end) -> bytes:
        start, end = max(0, int(start)), int(end)
        if self._mem is not None:
            seq = self._mem.get(name, b"")
            return seq[start:end]
        ent = self._fai.get(name)
        if ent is None:
            return b""
        length, offset, linebases, linewidth = ent
        end = min(end, length)
        if end <= start:
            return b""
        out = bytearray()
        pos = start
        while pos < end:
            line_i, line_o = divmod(pos, linebases)
            self._f.seek(offset + line_i * linewidth + line_o)
            take = min(linebases - line_o, end - pos)
            out += self._f.read(take)
            pos += take
        return bytes(out).upper()


# ---------------------------------------------------------------------------
# reader


class FileCursor:
    """ByteCursor interface over an open binary file."""

    def __init__(self, f):
        self.f = f

    def read(self, n):
        b = self.f.read(n)
        if len(b) != n:
            raise EOFError("cram: truncated file")
        return b

    def byte(self):
        return self.read(1)[0]

    itf8 = ByteCursor.itf8
    ltf8 = ByteCursor.ltf8
    itf8_array = ByteCursor.itf8_array


def _read_container_header_file(f) -> ContainerHeader | None:
    start = f.tell()
    peek = f.read(4)
    if len(peek) < 4:
        return None
    f.seek(start)
    raw_start = f.tell()
    fc = FileCursor(f)
    (length,) = struct.unpack("<i", fc.read(4))
    ref_id = fc.itf8()
    cstart = fc.itf8()
    span = fc.itf8()
    n_records = fc.itf8()
    record_counter = fc.ltf8()
    n_bases = fc.ltf8()
    n_blocks = fc.itf8()
    landmarks = fc.itf8_array()
    fc.read(4)  # CRC (validated on the byte path; skipped when streaming)
    return ContainerHeader(length, ref_id, cstart, span, n_records,
                           record_counter, n_bases, n_blocks, landmarks,
                           header_size=f.tell() - raw_start)


class CramReader:
    """CRAM 3.x reader: sequential iteration and CRAI region queries."""

    def __init__(self, path, reference=None):
        self.path = str(path)
        self.f = open(self.path, "rb")
        magic = self.f.read(4)
        if magic != CRAM_MAGIC:
            raise ValueError(f"{path}: not a CRAM file")
        self.version = tuple(self.f.read(2))
        if self.version[0] not in (2, 3):
            raise ValueError(f"{path}: unsupported CRAM major version {self.version[0]}")
        self.f.read(20)  # file id
        hdr = _read_container_header_file(self.f)
        body = self.f.read(hdr.length)
        ctype, _, data = read_block(ByteCursor(body))
        if ctype != CT_FILE_HEADER:
            raise ValueError("cram: first container is not the SAM header")
        (text_len,) = struct.unpack("<i", data[:4])
        self.sam_header = data[4 : 4 + text_len].decode("ascii", "replace")
        self.references: list[tuple[str, int]] = []
        for line in self.sam_header.splitlines():
            if line.startswith("@SQ"):
                name, ln = None, 0
                for fieldv in line.split("\t")[1:]:
                    if fieldv.startswith("SN:"):
                        name = fieldv[3:]
                    elif fieldv.startswith("LN:"):
                        ln = int(fieldv[3:])
                if name:
                    self.references.append((name, ln))
        self.ref_index = {name: i for i, (name, _) in enumerate(self.references)}
        self._data_start = self.f.tell()
        self._fasta = FastaReference(reference) if reference else None

    def _ref_fetch(self, ref_id, start, end):
        if self._fasta is None or not (0 <= ref_id < len(self.references)):
            return None
        return self._fasta.fetch(self.references[ref_id][0], start, end)

    def close(self):
        self.f.close()
        if self._fasta is not None:
            self._fasta.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _decode_body(self, body, hdr, landmarks=None, decode_seq=True):
        c = ByteCursor(body)
        ctype, _, data = read_block(c)
        if ctype != CT_COMPRESSION_HEADER:
            raise ValueError("cram: container does not start with a compression header")
        comp = CompressionHeader.parse(data)
        records = []
        for lm in (landmarks if landmarks is not None else hdr.landmarks):
            cc = ByteCursor(body, lm)
            st, _, shdata = read_block(cc)
            if st != CT_SLICE_HEADER:
                raise ValueError("cram: landmark does not point at a slice header")
            sh = SliceHeader.parse(shdata)
            core = BitReader(b"")
            ext = {}
            for _ in range(sh.n_blocks):
                bt, cid, bdata = read_block(cc)
                if bt == CT_CORE:
                    core = BitReader(bdata)
                elif bt == CT_EXTERNAL:
                    ext[cid] = ByteCursor(bdata)
            fetch = self._ref_fetch if decode_seq else None
            if sh.embedded_ref_id >= 0 and sh.embedded_ref_id in ext and decode_seq:
                emb = ext[sh.embedded_ref_id].buf
                ref0 = sh.start - 1

                def fetch(rid, s, e, _emb=emb, _r0=ref0):  # noqa: ANN001
                    return _emb[s - _r0 : e - _r0]

            if not decode_seq:
                fetch = None
            records.extend(_decode_slice_records(comp, sh, core, ext, fetch))
        return records

    def iter_records(self, chrom=None, start=None, end=None, decode_seq=True):
        """Yield :class:`CramRecord`. With a region, uses the .crai when
        present (else scans); yields records OVERLAPPING [start, end)."""
        if chrom is not None:
            ref_id = self.ref_index.get(str(chrom))
            if ref_id is None:
                raise ValueError(f"{self.path}: unknown chromosome {chrom!r}")
            start = 0 if start is None else int(start)
            end = (1 << 62) if end is None else int(end)
            import os

            crai = self.path + ".crai"
            if not os.path.exists(crai) and self.path.endswith(".cram"):
                crai = self.path[: -len(".cram")] + ".crai"
            if os.path.exists(crai):
                yield from self._iter_indexed(crai, ref_id, start, end, decode_seq)
                return
            for r in self._iter_all(decode_seq):
                if r.ref_id == ref_id and r.pos < end and r.pos + max(r.ref_len, 1) > start:
                    yield r
            return
        yield from self._iter_all(decode_seq)

    def _iter_all(self, decode_seq=True):
        self.f.seek(self._data_start)
        while True:
            hdr = _read_container_header_file(self.f)
            if hdr is None:
                return
            body = self.f.read(hdr.length)
            if hdr.n_records == 0:
                if hdr.ref_id == -1 and hdr.start == 4_542_278:
                    return  # EOF container
                continue
            yield from self._decode_body(body, hdr, decode_seq=decode_seq)

    def _iter_indexed(self, crai, ref_id, start, end, decode_seq=True):
        entries = read_crai(crai)
        hits: dict[int, list[int]] = {}
        for (sid, sstart, sspan, c_off, s_off, _s_len) in entries:
            if sid == -2 or (sid == ref_id and sstart <= end and sstart + sspan > start):
                hits.setdefault(c_off, []).append(s_off)
        for c_off in sorted(hits):
            self.f.seek(c_off)
            hdr = _read_container_header_file(self.f)
            body = self.f.read(hdr.length)
            for r in self._decode_body(body, hdr, landmarks=sorted(set(hits[c_off])),
                                       decode_seq=decode_seq):
                if r.ref_id == ref_id and r.pos < end and r.pos + max(r.ref_len, 1) > start:
                    yield r


def build_crai(cram_path, out_path=None):
    """Build a .crai by scanning container + slice headers (no record
    decode)."""
    out_path = out_path or str(cram_path) + ".crai"
    entries = []
    with CramReader(cram_path) as rd:
        rd.f.seek(rd._data_start)
        while True:
            c_off = rd.f.tell()
            hdr = _read_container_header_file(rd.f)
            if hdr is None:
                break
            body = rd.f.read(hdr.length)
            if hdr.n_records == 0:
                continue
            lms = list(hdr.landmarks)
            for i, lm in enumerate(lms):
                cc = ByteCursor(body, lm)
                st, _, shdata = read_block(cc)
                if st != CT_SLICE_HEADER:
                    continue
                sh = SliceHeader.parse(shdata)
                size = (lms[i + 1] if i + 1 < len(lms) else len(body)) - lm
                entries.append((sh.ref_id, sh.start, sh.span, c_off, lm, size))
    return write_crai(out_path, entries)


# ---------------------------------------------------------------------------
# pipeline-facing helpers (the CRAM counterparts of grid_tpu.native.bam)


def count_reads_region(path, ref_fasta, chrom, start, end, proper_flags,
                       min_mapq: int = 1) -> int:
    """Reference filter semantics (grid/utils/count_reads.py:96-107): flag
    in set, mapq >= min_mapq, mate on same chromosome, not dup/secondary,
    start <= pos < end."""
    flags = set(int(f) for f in proper_flags)
    n = 0
    with CramReader(path, reference=None) as rd:
        for r in rd.iter_records(chrom, start, end, decode_seq=False):
            if (
                r.flag in flags
                and r.mapq >= min_mapq
                and r.ref_id == r.mate_ref_id
                and not (r.flag & 0x400)
                and not (r.flag & 0x100)
                and start <= r.pos < end
            ):
                n += 1
    return n


def fetch_reads_region(path, ref_fasta, chrom, start, end,
                       exclude_flags: int = 1796, min_mapq: int = 0):
    """(positions, flags, mapqs, seqs) for reads STARTING in [start, end)."""
    import numpy as np

    positions, flags_l, mapqs, seqs = [], [], [], []
    with CramReader(path, reference=ref_fasta) as rd:
        for r in rd.iter_records(chrom, start, end):
            if r.flag & exclude_flags or r.mapq < min_mapq:
                continue
            if not (start <= r.pos < end):
                continue
            positions.append(r.pos)
            flags_l.append(r.flag)
            mapqs.append(r.mapq)
            seqs.append(r.seq or "")
    return (
        np.asarray(positions, dtype="int64"),
        np.asarray(flags_l, dtype="int32"),
        np.asarray(mapqs, dtype="int32"),
        seqs,
    )


def binned_depth(path, out_bed_gz, bin_size: int = 1000,
                 exclude_flags: int = 1796, min_mapq: int = 0,
                 ref_fasta=None, skip_zero: bool = False) -> None:
    """mosdepth-fast-mode binned depth -> regions.bed.gz (same math as
    native/src/bam.cpp:grid_bam_binned_depth: per-bin overlap sum / bin
    width). ``skip_zero`` omits zero-depth bins, except each contig's
    final bin (always written so the sparse file records the contig
    extent for exact window-coverage denominators)."""
    with CramReader(path, reference=None) as rd:
        refs = rd.references
        overlap = [
            [0] * ((length + bin_size - 1) // bin_size) for _, length in refs
        ]
        for r in rd.iter_records(decode_seq=False):
            if r.ref_id < 0 or r.ref_id >= len(refs):
                continue
            if r.flag & exclude_flags or r.mapq < min_mapq:
                continue
            beg = r.pos
            endp = r.pos + max(r.ref_len, 0)
            if endp <= beg:
                continue
            bins = overlap[r.ref_id]
            b = beg // bin_size
            while b <= (endp - 1) // bin_size and b < len(bins):
                bs = b * bin_size
                o = min(endp, bs + bin_size) - max(beg, bs)
                if o > 0:
                    bins[b] += o
                b += 1
    with gzip.open(out_bed_gz, "wt") as out:
        for (name, length), bins in zip(refs, overlap):
            for b, val in enumerate(bins):
                if skip_zero and val == 0 and b + 1 < len(bins):
                    continue
                bs = b * bin_size
                be = min(bs + bin_size, length)
                out.write(f"{name}\t{bs}\t{be}\t{val / (be - bs):.2f}\n")
