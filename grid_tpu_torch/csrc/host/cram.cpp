// Native CRAM 3.0 read path: region read counting and binned depth.
//
// C++ twin of grid_tpu/io/cramlite.py's reader (see its docstring for the
// format scope) — cross-checked record-for-record against the Python
// implementation in tests/test_cramlite_native.py. Implements containers,
// gzip + rANS-4x8 (order 0/1) blocks, the codec suite (EXTERNAL, canonical
// HUFFMAN, BETA, GAMMA, SUBEXP, BYTE_ARRAY_STOP/LEN), the record decode
// loop (features consumed, sequences skipped — counting and depth need
// positions, flags, mapq, mate refs and reference spans only), and CRAI
// region queries. zlib is the only dependency.

#include <zlib.h>

#include <algorithm>
#include <array>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <dlfcn.h>

#include <condition_variable>
#include <deque>
#include <functional>
#include <map>
#include <memory>
#include <mutex>
#include <set>
#include <string>
#include <thread>
#include <vector>

#include "bedwrite.h"
#include "windows.h"

namespace {

// ---------------------------------------------------------------- cursors

struct Cursor {
  const uint8_t* p;
  const uint8_t* end;
  bool ok = true;

  Cursor(const uint8_t* data, size_t n) : p(data), end(data + n) {}

  uint8_t byte() {
    if (p >= end) {
      ok = false;
      return 0;
    }
    return *p++;
  }

  bool read(void* dst, size_t n) {
    if (n > (size_t)(end - p)) {  // remaining-based: no pointer overflow
      ok = false;
      return false;
    }
    memcpy(dst, p, n);
    p += n;
    return true;
  }

  bool skip(size_t n) {
    if (n > (size_t)(end - p)) {
      ok = false;
      return false;
    }
    p += n;
    return true;
  }

  int32_t itf8() {
    uint8_t b0 = byte();
    uint32_t v;
    if (b0 < 0x80) return (int32_t)b0;
    if (b0 < 0xC0) {
      v = ((uint32_t)(b0 & 0x7F) << 8) | byte();
    } else if (b0 < 0xE0) {
      v = ((uint32_t)(b0 & 0x3F) << 16) | ((uint32_t)byte() << 8) | byte();
    } else if (b0 < 0xF0) {
      v = ((uint32_t)(b0 & 0x1F) << 24) | ((uint32_t)byte() << 16) |
          ((uint32_t)byte() << 8) | byte();
    } else {
      v = ((uint32_t)(b0 & 0x0F) << 28) | ((uint32_t)byte() << 20) |
          ((uint32_t)byte() << 12) | ((uint32_t)byte() << 4) | (byte() & 0x0F);
    }
    return (int32_t)v;
  }

  int64_t ltf8() {
    uint8_t b0 = byte();
    int lead = 0;
    for (int bit = 7; bit >= 0; --bit) {
      if (b0 & (1 << bit))
        ++lead;
      else
        break;
    }
    uint64_t v = lead < 8 ? (uint64_t)(b0 & (0xFF >> (lead + 1))) : 0;
    for (int i = 0; i < lead; ++i) v = (v << 8) | byte();
    return (int64_t)v;
  }
};

struct BitReader {
  const uint8_t* p = nullptr;
  const uint8_t* end = nullptr;
  int bit = 0;

  void init(const uint8_t* data, size_t n) {
    p = data;
    end = data + n;
    bit = 0;
  }

  uint32_t read_bits(int n) {
    uint32_t v = 0;
    for (int i = 0; i < n; ++i) {
      uint8_t b = p < end ? *p : 0;
      v = (v << 1) | ((b >> (7 - bit)) & 1);
      if (++bit == 8) {
        bit = 0;
        ++p;
      }
    }
    return v;
  }
};

// ------------------------------------------------------------- decompress

bool inflate_buf(const uint8_t* src, size_t n, std::vector<uint8_t>& out,
                 size_t raw_size) {
  out.resize(raw_size);
  // libdeflate when present (~2x zlib); auto-detect gzip vs zlib wrapping
  // like inflateInit2(15+32) does below.
  const gridtpu::LibDeflateApi& a = gridtpu::libdeflate_api();
  void* d = gridtpu::libdeflate_decompressor();
  if (d) {
    size_t actual = 0;
    int rc = (n >= 2 && src[0] == 0x1f && src[1] == 0x8b)
                 ? a.gzip_decompress(d, src, n, out.data(), raw_size, &actual)
                 : a.zlib_decompress(d, src, n, out.data(), raw_size, &actual);
    return rc == 0 && actual == raw_size;
  }
  z_stream zs;
  memset(&zs, 0, sizeof(zs));
  if (inflateInit2(&zs, 15 + 32) != Z_OK) return false;  // gzip or zlib
  zs.next_in = const_cast<uint8_t*>(src);
  zs.avail_in = (uInt)n;
  zs.next_out = out.data();
  zs.avail_out = (uInt)raw_size;
  int rc = inflate(&zs, Z_FINISH);
  inflateEnd(&zs);
  return rc == Z_STREAM_END && zs.total_out == raw_size;
}

// rANS 4x8 decode (CRAM codecs spec; twin of cramlite.rans_decode).

constexpr int kTFShift = 12;
constexpr uint32_t kTotFreq = 1u << kTFShift;
constexpr uint32_t kRansL = 1u << 23;

int read_freq(Cursor& c) {
  int f = c.byte();
  if (f >= 0x80) f = ((f & 0x7F) << 8) | c.byte();
  return f;
}

// Ascending symbol list with run-length shorthand; calls fn(sym).
template <typename Fn>
bool read_sym_list(Cursor& c, Fn fn) {
  int sym = c.byte();
  int rle = 0;
  while (c.ok) {
    fn(sym);
    int last = sym;
    if (rle > 0) {
      --rle;
      sym = last + 1;
      if (sym > 255) return false;  // corrupt run crossing the alphabet end
    } else {
      sym = c.byte();
      if (sym == 0) return true;
      if (sym == last + 1) rle = c.byte();
    }
  }
  return false;
}

// Packed decode-table entry: sym | (freq-1)<<8 | cum<<20 — one 32-bit load
// replaces the three lookups (lookup[m], freq[s], cum[s]) of the naive
// form. freq in [1, 4096] and cum in [0, 4095] both fit 12 bits.
inline void build_packed_table(const uint32_t* freq, const uint32_t* cum,
                               uint32_t* tbl) {
  for (int s = 0; s < 256; ++s)
    for (uint32_t m = cum[s]; m < cum[s + 1]; ++m)
      tbl[m] = (uint32_t)s | ((freq[s] - 1) << 8) | (cum[s] << 20);
}

// One rANS decode step against a packed table. The renorm is at most two
// bytes: post-step x >= (x_prev >> 12) >= 2^11, so two <<8 shifts reach
// the 2^23 lower bound. `checked` guards the input tail.
template <bool checked>
inline uint8_t rans_step(uint32_t& x, const uint32_t* tbl, const uint8_t*& p,
                         const uint8_t* pend) {
  uint32_t m = x & (kTotFreq - 1);
  uint32_t e = tbl[m];
  x = (((e >> 8) & 0xFFF) + 1) * (x >> kTFShift) + m - (e >> 20);
  if (checked) {
    if (x < kRansL && p < pend) x = (x << 8) | *p++;
    if (x < kRansL && p < pend) x = (x << 8) | *p++;
  } else {
    if (x < kRansL) {
      x = (x << 8) | *p++;
      if (x < kRansL) x = (x << 8) | *p++;
    }
  }
  return (uint8_t)e;
}

bool rans_decode(const uint8_t* src, size_t n, std::vector<uint8_t>& out) {
  Cursor c(src, n);
  int order = c.byte();
  uint32_t comp_sz, out_sz;
  if (!c.read(&comp_sz, 4) || !c.read(&out_sz, 4)) return false;
  if (out_sz > (1u << 30)) return false;
  out.resize(out_sz);
  if (out_sz == 0) return true;

  if (order == 0) {
    uint32_t freq[256] = {0}, cum[257] = {0};
    if (!read_sym_list(c, [&](int s) { freq[s] = read_freq(c); })) return false;
    for (int i = 0; i < 256; ++i) cum[i + 1] = cum[i] + freq[i];
    if (cum[256] != kTotFreq) return false;
    std::vector<uint32_t> tbl(kTotFreq);
    build_packed_table(freq, cum, tbl.data());
    uint32_t st[4];
    for (auto& x : st)
      if (!c.read(&x, 4)) return false;
    const uint32_t* t = tbl.data();
    const uint8_t* p = c.p;
    const uint8_t* pend = c.end;
    uint8_t* o = out.data();
    uint32_t x0 = st[0], x1 = st[1], x2 = st[2], x3 = st[3];
    // Four independent state chains; the unchecked quad loop lets the CPU
    // pipeline them (each state renorms <= 2 bytes, so 8 bytes of input
    // slack covers a full quad).
    uint32_t i = 0;
    uint32_t quads = out_sz / 4;
    while (i < quads && (size_t)(pend - p) >= 8) {
      uint8_t* q = o + i * 4;
      q[0] = rans_step<false>(x0, t, p, pend);
      q[1] = rans_step<false>(x1, t, p, pend);
      q[2] = rans_step<false>(x2, t, p, pend);
      q[3] = rans_step<false>(x3, t, p, pend);
      ++i;
    }
    st[0] = x0; st[1] = x1; st[2] = x2; st[3] = x3;
    for (uint32_t k = i * 4; k < out_sz; ++k)
      o[k] = rans_step<true>(st[k & 3], t, p, pend);
    return true;
  }
  if (order == 1) {
    // per-context packed tables in one contiguous buffer + a flat pointer
    // table — the inner loop does ptrs[last] with no vector indirection
    std::vector<uint32_t> storage;
    int slot_of[256];
    for (auto& s : slot_of) s = -1;
    int n_ctx = 0;
    bool bad = false;
    bool okl = read_sym_list(c, [&](int ctx) {
      slot_of[ctx] = n_ctx++;
      uint32_t freq[256] = {0}, cum[257] = {0};
      read_sym_list(c, [&](int s) { freq[s] = read_freq(c); });
      for (int i = 0; i < 256; ++i) cum[i + 1] = cum[i] + freq[i];
      if (cum[256] != kTotFreq) {
        bad = true;
        return;
      }
      storage.resize((size_t)n_ctx * kTotFreq);
      build_packed_table(freq, cum,
                         storage.data() + (size_t)(n_ctx - 1) * kTotFreq);
    });
    if (!okl || bad) return false;
    const uint32_t* ptrs[256];
    for (int ctx = 0; ctx < 256; ++ctx)
      ptrs[ctx] = slot_of[ctx] < 0
                      ? nullptr
                      : storage.data() + (size_t)slot_of[ctx] * kTotFreq;
    uint32_t st[4];
    for (auto& x : st)
      if (!c.read(&x, 4)) return false;
    const uint8_t* p = c.p;
    const uint8_t* pend = c.end;
    uint8_t* o = out.data();
    uint32_t q = out_sz >> 2;
    uint8_t l0 = 0, l1 = 0, l2 = 0, l3 = 0;
    uint32_t x0 = st[0], x1 = st[1], x2 = st[2], x3 = st[3];
    uint8_t *o0 = o, *o1 = o + q, *o2 = o + 2 * q, *o3 = o + 3 * q;
    // quarters 0-2 have length q; quarter 3 is the longest (out_sz - 3q)
    uint32_t step = 0;
    while (step < q && (size_t)(pend - p) >= 8) {
      const uint32_t *t0 = ptrs[l0], *t1 = ptrs[l1], *t2 = ptrs[l2],
                     *t3 = ptrs[l3];
      if (!t0 || !t1 || !t2 || !t3) return false;
      o0[step] = l0 = rans_step<false>(x0, t0, p, pend);
      o1[step] = l1 = rans_step<false>(x1, t1, p, pend);
      o2[step] = l2 = rans_step<false>(x2, t2, p, pend);
      o3[step] = l3 = rans_step<false>(x3, t3, p, pend);
      ++step;
    }
    for (; step < q; ++step) {
      const uint32_t *t0 = ptrs[l0], *t1 = ptrs[l1], *t2 = ptrs[l2],
                     *t3 = ptrs[l3];
      if (!t0 || !t1 || !t2 || !t3) return false;
      o0[step] = l0 = rans_step<true>(x0, t0, p, pend);
      o1[step] = l1 = rans_step<true>(x1, t1, p, pend);
      o2[step] = l2 = rans_step<true>(x2, t2, p, pend);
      o3[step] = l3 = rans_step<true>(x3, t3, p, pend);
    }
    for (uint32_t i = 3 * q + step; i < out_sz; ++i) {  // state 3 remainder
      const uint32_t* t = ptrs[l3];
      if (!t) return false;
      o[i] = l3 = rans_step<true>(x3, t, p, pend);
    }
    return true;
  }
  return false;
}

// ----------------------------------------------------------------- blocks

enum { M_RAW = 0, M_GZIP = 1, M_BZIP2 = 2, M_LZMA = 3, M_RANS = 4 };

// xz-container LZMA block decode via a runtime-loaded liblzma (htslib
// writes CRAM LZMA blocks as xz streams; so does Python's lzma.compress
// default). dlopen'd like bzip2 below so the native library keeps its
// zlib-only BUILD dependency — a host without liblzma still builds and
// runs every BAM path, and LZMA-block CRAMs fall back to the Python
// reader (which carries its own lzma via the stdlib).
typedef int (*lzma_decode_fn)(uint64_t*, uint32_t, void*, const uint8_t*,
                              size_t*, size_t, uint8_t*, size_t*, size_t);

lzma_decode_fn load_lzma() {
  static lzma_decode_fn fn = [] {
    void* h = dlopen("liblzma.so.5", RTLD_NOW | RTLD_GLOBAL);
    if (!h) h = dlopen("liblzma.so", RTLD_NOW | RTLD_GLOBAL);
    return h ? (lzma_decode_fn)dlsym(h, "lzma_stream_buffer_decode")
             : (lzma_decode_fn) nullptr;
  }();
  return fn;
}

bool lzma_buf(const uint8_t* in, size_t in_len, std::vector<uint8_t>& out,
              int32_t raw_size) {
  lzma_decode_fn fn = load_lzma();
  if (!fn) return false;
  out.resize((size_t)raw_size);
  uint64_t memlimit = UINT64_MAX;
  size_t in_pos = 0, out_pos = 0;
  if (fn(&memlimit, 0, nullptr, in, &in_pos, in_len, out.data(), &out_pos,
         out.size()) != 0)
    return false;
  out.resize(out_pos);
  return true;
}

// bzip2 block decode via a runtime-loaded libbz2.so.1 (this toolchain has
// the runtime library but no dev package, so the one function needed is
// declared here and resolved with dlopen — absent library => decode fails
// and the caller falls back to the Python reader, which carries its own
// bz2 implementation).
typedef int (*bz2_decomp_fn)(char*, unsigned*, char*, unsigned, int, int);

bz2_decomp_fn load_bz2() {
  static bz2_decomp_fn fn = [] {
    void* h = dlopen("libbz2.so.1", RTLD_NOW | RTLD_GLOBAL);
    if (!h) h = dlopen("libbz2.so", RTLD_NOW | RTLD_GLOBAL);
    return h ? (bz2_decomp_fn)dlsym(h, "BZ2_bzBuffToBuffDecompress")
             : (bz2_decomp_fn) nullptr;
  }();
  return fn;
}

bool bzip2_buf(const uint8_t* in, size_t in_len, std::vector<uint8_t>& out,
               int32_t raw_size) {
  bz2_decomp_fn fn = load_bz2();
  if (!fn) return false;
  out.resize((size_t)raw_size);
  unsigned out_len = (unsigned)out.size();
  int rc = fn((char*)out.data(), &out_len, (char*)in, (unsigned)in_len, 0, 0);
  if (rc != 0) return false;
  out.resize(out_len);
  return true;
}
enum {
  CT_FILE_HEADER = 0,
  CT_COMP_HEADER = 1,
  CT_SLICE_HEADER = 2,
  CT_EXTERNAL = 4,
  CT_CORE = 5,
};

struct Block {
  int ctype = -1;
  int content_id = 0;
  std::vector<uint8_t> data;
};

// Block header + a pointer to the still-compressed payload (which aliases
// the container body, so the body must outlive any deferred decode).
struct RawBlock {
  int method = M_RAW;
  int ctype = -1;
  int content_id = 0;
  const uint8_t* payload = nullptr;
  int32_t comp_size = 0;
  int32_t raw_size = 0;
};

bool parse_block(Cursor& c, RawBlock* b) {
  b->method = c.byte();
  b->ctype = c.byte();
  b->content_id = c.itf8();
  b->comp_size = c.itf8();
  b->raw_size = c.itf8();
  if (!c.ok || b->comp_size < 0 || b->raw_size < 0 ||
      b->raw_size > (1 << 30))  // allocation guard vs corrupt size fields
    return false;
  b->payload = c.p;
  if (!c.skip(b->comp_size)) return false;
  c.skip(4);  // CRC32 (validated by the Python twin; skipped here for speed)
  return true;
}

bool materialize_block(const RawBlock& rb, std::vector<uint8_t>& out) {
  switch (rb.method) {
    case M_RAW:
      out.assign(rb.payload, rb.payload + rb.comp_size);
      break;
    case M_GZIP:
      if (!inflate_buf(rb.payload, rb.comp_size, out, rb.raw_size))
        return false;
      break;
    case M_RANS:
      if (!rans_decode(rb.payload, rb.comp_size, out)) return false;
      break;
    case M_BZIP2:
      if (!bzip2_buf(rb.payload, rb.comp_size, out, rb.raw_size)) return false;
      break;
    case M_LZMA:
      if (!lzma_buf(rb.payload, rb.comp_size, out, rb.raw_size)) return false;
      break;
    default:
      return false;
  }
  return (int32_t)out.size() == rb.raw_size;
}

bool read_block(Cursor& c, Block* b) {
  RawBlock rb;
  if (!parse_block(c, &rb)) return false;
  b->ctype = rb.ctype;
  b->content_id = rb.content_id;
  return materialize_block(rb, b->data);
}

// External data stream with DEFERRED decompression: the record decode loop
// only ever *skips* the big streams (QS quality bytes, BB/BA base
// stretches — their lengths come from other series), so those blocks are
// never inflated at all unless a codec actually reads their bytes. skip()
// advances a virtual offset while unmaterialized; the first content access
// (byte/read/itf8/memchr) decompresses and re-applies the offset. This is
// most of the CRAM-vs-BAM full-scan gap: quality + base blocks are ~70% of
// a real file's compressed payload.
struct ExtStream {
  RawBlock rb;
  std::vector<uint8_t> buf;
  const uint8_t* p = nullptr;
  const uint8_t* end = nullptr;
  size_t vpos = 0;  // virtual offset while unmaterialized
  bool mat = false;
  bool ok = true;

  void init(const RawBlock& b) {
    rb = b;
    mat = false;
    ok = true;
    vpos = 0;
  }

  bool ensure() {
    if (mat) return ok;
    mat = true;
    if (rb.method == M_RAW) {
      // zero-copy: point straight into the container body
      if (rb.comp_size != rb.raw_size) {
        ok = false;
        return false;
      }
      p = rb.payload;
      end = rb.payload + rb.comp_size;
    } else {
      if (!materialize_block(rb, buf)) {
        ok = false;
        p = end = nullptr;
        return false;
      }
      p = buf.data();
      end = buf.data() + buf.size();
    }
    p += vpos;  // skip() bounds-checked vpos <= raw_size already
    return true;
  }

  uint8_t byte() {
    if (!mat && !ensure()) return 0;
    if (p >= end) {
      ok = false;
      return 0;
    }
    return *p++;
  }

  bool read(void* dst, size_t n) {
    if (!mat && !ensure()) return false;
    if (n > (size_t)(end - p)) {
      ok = false;
      return false;
    }
    memcpy(dst, p, n);
    p += n;
    return true;
  }

  bool skip(size_t n) {
    if (!mat) {
      if (vpos + n > (size_t)rb.raw_size) {
        ok = false;
        return false;
      }
      vpos += n;
      return true;
    }
    if (n > (size_t)(end - p)) {
      ok = false;
      return false;
    }
    p += n;
    return true;
  }

  int32_t itf8() {
    // fast path: one bounds check covers the worst-case 5-byte encoding
    if (mat && (size_t)(end - p) >= 5) {
      const uint8_t* q = p;
      uint8_t b0 = *q++;
      uint32_t v;
      if (b0 < 0x80) {
        p = q;
        return (int32_t)b0;
      }
      if (b0 < 0xC0) {
        v = ((uint32_t)(b0 & 0x7F) << 8) | *q++;
      } else if (b0 < 0xE0) {
        v = ((uint32_t)(b0 & 0x3F) << 16) | ((uint32_t)q[0] << 8) | q[1];
        q += 2;
      } else if (b0 < 0xF0) {
        v = ((uint32_t)(b0 & 0x1F) << 24) | ((uint32_t)q[0] << 16) |
            ((uint32_t)q[1] << 8) | q[2];
        q += 3;
      } else {
        v = ((uint32_t)(b0 & 0x0F) << 28) | ((uint32_t)q[0] << 20) |
            ((uint32_t)q[1] << 12) | ((uint32_t)q[2] << 4) | (q[3] & 0x0F);
        q += 4;
      }
      p = q;
      return (int32_t)v;
    }
    uint8_t b0 = byte();
    uint32_t v;
    if (b0 < 0x80) return (int32_t)b0;
    if (b0 < 0xC0) {
      v = ((uint32_t)(b0 & 0x7F) << 8) | byte();
    } else if (b0 < 0xE0) {
      v = ((uint32_t)(b0 & 0x3F) << 16) | ((uint32_t)byte() << 8) | byte();
    } else if (b0 < 0xF0) {
      v = ((uint32_t)(b0 & 0x1F) << 24) | ((uint32_t)byte() << 16) |
          ((uint32_t)byte() << 8) | byte();
    } else {
      v = ((uint32_t)(b0 & 0x0F) << 28) | ((uint32_t)byte() << 20) |
          ((uint32_t)byte() << 12) | ((uint32_t)byte() << 4) | (byte() & 0x0F);
    }
    return (int32_t)v;
  }
};

struct ContainerHeader {
  int32_t length = 0;
  int32_t ref_id = 0;
  int32_t start = 0;
  int32_t span = 0;
  int32_t n_records = 0;
  int64_t record_counter = 0;
  int64_t n_bases = 0;
  int32_t n_blocks = 0;
  std::vector<int32_t> landmarks;
};

bool read_container_header(FILE* f, ContainerHeader* h) {
  // headers are small; buffer generously and parse with a Cursor
  uint8_t buf[1 << 14];
  long pos = ftell(f);
  size_t n = fread(buf, 1, sizeof(buf), f);
  if (n < 4) return false;
  Cursor c(buf, n);
  if (!c.read(&h->length, 4)) return false;
  if (h->length < 0 || h->length > (1 << 30)) return false;  // corrupt size
  h->ref_id = c.itf8();
  h->start = c.itf8();
  h->span = c.itf8();
  h->n_records = c.itf8();
  h->record_counter = c.ltf8();
  h->n_bases = c.ltf8();
  h->n_blocks = c.itf8();
  int32_t nl = c.itf8();
  if (!c.ok || nl < 0 || nl > 1'000'000) return false;
  h->landmarks.resize(nl);
  for (auto& lm : h->landmarks) lm = c.itf8();
  c.skip(4);  // CRC
  if (!c.ok) return false;
  fseek(f, pos + (long)(c.p - buf), SEEK_SET);
  return true;
}

// -------------------------------------------------------------- encodings

enum {
  E_NULL = 0,
  E_EXTERNAL = 1,
  E_HUFFMAN = 3,
  E_BYTE_ARRAY_LEN = 4,
  E_BYTE_ARRAY_STOP = 5,
  E_BETA = 6,
  E_SUBEXP = 7,
  E_GAMMA = 9,
};

struct Encoding {
  int codec = E_NULL;
  std::vector<uint8_t> params;

  bool parse(Cursor& c) {
    codec = c.itf8();
    int32_t n = c.itf8();
    if (!c.ok || n < 0) return false;
    params.assign(c.p, c.p + n);
    return c.skip(n);
  }
};

struct ExtMap {
  std::map<int, ExtStream> streams;

  ExtStream* get(int id) {
    auto it = streams.find(id);
    return it == streams.end() ? nullptr : &it->second;
  }
};

struct Codec {
  int codec = E_NULL;
  int content_id = 0;
  // huffman
  struct HuffEntry {
    int len, code, sym;
  };
  std::vector<HuffEntry> huff;
  bool is_const = false;
  int const_val = 0;
  // beta/gamma/subexp
  int offset = 0, nbits = 0, k = 0;
  // byte array
  uint8_t stop = 0;
  std::vector<Codec> nested;   // [len, val] for BYTE_ARRAY_LEN
  ExtStream* stream = nullptr;  // bound external stream (bind())

  bool init(const Encoding& e) {
    codec = e.codec;
    Cursor c(e.params.data(), e.params.size());
    switch (e.codec) {
      case E_EXTERNAL:
        content_id = c.itf8();
        break;
      case E_HUFFMAN: {
        int32_t na = c.itf8();
        std::vector<int> alphabet(na);
        for (auto& a : alphabet) a = c.itf8();
        int32_t nl = c.itf8();
        if (nl != na) return false;
        std::vector<int> lens(nl);
        for (auto& l : lens) l = c.itf8();
        std::vector<int> order(na);
        for (int i = 0; i < na; ++i) order[i] = i;
        std::sort(order.begin(), order.end(), [&](int a, int b) {
          if (lens[a] != lens[b]) return lens[a] < lens[b];
          return alphabet[a] < alphabet[b];
        });
        int code = 0, prev_len = 0;
        for (int i : order) {
          code <<= (lens[i] - prev_len);
          prev_len = lens[i];
          huff.push_back({lens[i], code, alphabet[i]});
          ++code;
        }
        if (na == 1 && lens[order[0]] == 0) {
          is_const = true;
          const_val = alphabet[order[0]];
        }
        break;
      }
      case E_BETA:
        offset = c.itf8();
        nbits = c.itf8();
        break;
      case E_GAMMA:
        offset = c.itf8();
        break;
      case E_SUBEXP:
        offset = c.itf8();
        k = c.itf8();
        break;
      case E_BYTE_ARRAY_STOP:
        stop = c.byte();
        content_id = c.itf8();
        break;
      case E_BYTE_ARRAY_LEN: {
        nested.resize(2);
        Encoding len_e, val_e;
        if (!len_e.parse(c) || !val_e.parse(c)) return false;
        if (!nested[0].init(len_e) || !nested[1].init(val_e)) return false;
        break;
      }
      case E_NULL:
        break;
      default:
        return false;
    }
    return c.ok;
  }

  // Resolve the external stream pointer once per slice so the per-record
  // hot path does no map lookups.
  bool bind(ExtMap& ext) {
    if (codec == E_EXTERNAL || codec == E_BYTE_ARRAY_STOP) {
      stream = ext.get(content_id);
      if (!stream) return false;
    }
    for (auto& n : nested)
      if (!n.bind(ext)) return false;
    return true;
  }

  bool read_int(BitReader& core, int32_t* out) const {
    switch (codec) {
      case E_EXTERNAL: {
        *out = stream->itf8();
        return stream->ok;
      }
      case E_HUFFMAN: {
        if (is_const) {
          *out = const_val;
          return true;
        }
        int code = 0, ln = 0;
        for (const auto& h : huff) {
          code = (code << (h.len - ln)) | (int)core.read_bits(h.len - ln);
          ln = h.len;
          if (code == h.code) {
            *out = h.sym;
            return true;
          }
        }
        return false;
      }
      case E_BETA:
        *out = (int32_t)core.read_bits(nbits) - offset;
        return true;
      case E_GAMMA: {
        int z = 0;
        while (core.read_bits(1) == 0 && z < 32) ++z;
        int v = z ? (int)((1u << z) | core.read_bits(z)) : 1;
        *out = v - offset;
        return true;
      }
      case E_SUBEXP: {
        int u = 0;
        while (core.read_bits(1) == 1 && u < 32) ++u;
        int v;
        if (u == 0) {
          v = (int)core.read_bits(k);
        } else {
          int n = u + k - 1;
          v = (int)core.read_bits(n) + (1 << n);
        }
        *out = v - offset;
        return true;
      }
      default:
        return false;
    }
  }

  bool read_byte(BitReader& core, uint8_t* out) const {
    if (codec == E_EXTERNAL) {
      *out = stream->byte();
      return stream->ok;
    }
    int32_t v;
    if (!read_int(core, &v)) return false;
    *out = (uint8_t)v;
    return true;
  }

  // Consume a byte array (content discarded); returns length or -1.
  int skip_bytes(BitReader& core, int n = -1) const {
    if (codec == E_BYTE_ARRAY_STOP) {
      ExtStream* s = stream;
      if (!s->mat && !s->ensure()) return -1;  // stop-scan needs the bytes
      const uint8_t* q =
          (const uint8_t*)memchr(s->p, stop, (size_t)(s->end - s->p));
      if (!q) return -1;
      int len = (int)(q - s->p);
      s->p = q + 1;
      return len;
    }
    if (codec == E_BYTE_ARRAY_LEN) {
      int32_t len;
      if (!nested[0].read_int(core, &len) || len < 0) return -1;
      return nested[1].skip_bytes(core, len) < 0 ? -1 : len;
    }
    if (codec == E_EXTERNAL) {
      if (n < 0) return -1;
      if (!stream->skip(n)) return -1;
      return n;
    }
    if (n < 0) return -1;
    uint8_t b;
    for (int i = 0; i < n; ++i)
      if (!read_byte(core, &b)) return -1;
    return n;
  }
};

// ------------------------------------------------------ compression header

struct CompHeader {
  bool ap_delta = true;
  bool rn_preserved = true;
  std::map<std::string, Encoding> series;
  std::map<int, Encoding> tag_enc;
  std::vector<std::vector<int>> tag_dict;  // TL -> list of tag keys

  bool parse(const std::vector<uint8_t>& data) {
    Cursor c(data.data(), data.size());
    c.itf8();  // preservation map byte size
    int32_t n = c.itf8();
    for (int i = 0; i < n && c.ok; ++i) {
      char k0 = (char)c.byte(), k1 = (char)c.byte();
      std::string key{k0, k1};
      if (key == "RN")
        rn_preserved = c.byte() != 0;
      else if (key == "AP")
        ap_delta = c.byte() != 0;
      else if (key == "RR")
        c.byte();
      else if (key == "SM")
        c.skip(5);
      else if (key == "TD") {
        int32_t len = c.itf8();
        const uint8_t* td = c.p;
        if (!c.skip(len)) return false;
        std::vector<int> line;
        for (int32_t j = 0; j < len;) {
          if (td[j] == 0) {
            tag_dict.push_back(line);
            line.clear();
            ++j;
          } else {
            if (j + 3 > len) return false;
            line.push_back(((int)td[j] << 16) | ((int)td[j + 1] << 8) |
                           (int)td[j + 2]);
            j += 3;
          }
        }
      } else {
        return false;
      }
    }
    c.itf8();
    n = c.itf8();
    for (int i = 0; i < n && c.ok; ++i) {
      char k0 = (char)c.byte(), k1 = (char)c.byte();
      Encoding e;
      if (!e.parse(c)) return false;
      series[std::string{k0, k1}] = e;
    }
    c.itf8();
    n = c.itf8();
    for (int i = 0; i < n && c.ok; ++i) {
      int key = c.itf8();
      Encoding e;
      if (!e.parse(c)) return false;
      tag_enc[key] = e;
    }
    if (tag_dict.empty()) tag_dict.push_back({});
    return c.ok;
  }
};

// ----------------------------------------------------------- slice header

struct SliceHeader {
  int32_t ref_id = 0;
  int32_t start = 0;
  int32_t span = 0;
  int32_t n_records = 0;
  int32_t n_blocks = 0;

  bool parse(const std::vector<uint8_t>& data) {
    Cursor c(data.data(), data.size());
    ref_id = c.itf8();
    start = c.itf8();
    span = c.itf8();
    n_records = c.itf8();
    if (n_records < 0 || n_records > 100'000'000) return false;
    c.ltf8();  // record counter
    n_blocks = c.itf8();
    if (n_blocks < 0 || n_blocks > 100'000) return false;
    int32_t nids = c.itf8();
    if (nids < 0 || nids > 100'000) return false;
    for (int i = 0; i < nids && c.ok; ++i) c.itf8();
    c.itf8();    // embedded ref id
    c.skip(16);  // md5
    return c.ok;
  }
};

// -------------------------------------------------------------- records

struct LiteRec {
  int32_t ref_id = -1;
  int64_t pos = -1;  // 0-based
  int32_t flag = 0;
  int32_t mapq = 0;
  int32_t mate_ref = -1;
  int32_t ref_len = 0;
  int32_t nf = -1;  // mate-downstream distance (resolved after the loop)
};

struct SliceDecoder {
  const CompHeader& comp;
  std::map<std::string, Codec> storage;
  std::map<int, Codec> tag_codecs;
  BitReader core;
  ExtMap ext;
  // Codecs resolved + stream-bound once per slice; the per-record loop
  // does no map lookups.
  const Codec *bf = nullptr, *cf = nullptr, *ri = nullptr, *rl = nullptr,
              *ap = nullptr, *rg = nullptr, *rn = nullptr, *mf = nullptr,
              *ns = nullptr, *np = nullptr, *ts = nullptr, *nf = nullptr,
              *tl = nullptr, *fn = nullptr, *fc = nullptr, *fp = nullptr,
              *ba = nullptr, *qs = nullptr, *bs = nullptr, *in_ = nullptr,
              *sc = nullptr, *bb = nullptr, *qq = nullptr, *dl = nullptr,
              *rs = nullptr, *pd = nullptr, *hc = nullptr, *mq = nullptr;

  explicit SliceDecoder(const CompHeader& ch) : comp(ch) {}

  const Codec* resolve(const char* key) {
    auto se = comp.series.find(key);
    if (se == comp.series.end()) return nullptr;
    Codec cd;
    if (!cd.init(se->second) || !cd.bind(ext)) return nullptr;
    return &storage.emplace(key, std::move(cd)).first->second;
  }

  // Call after core/ext are populated.
  void resolve_all() {
    bf = resolve("BF"); cf = resolve("CF"); ri = resolve("RI");
    rl = resolve("RL"); ap = resolve("AP"); rg = resolve("RG");
    rn = resolve("RN"); mf = resolve("MF"); ns = resolve("NS");
    np = resolve("NP"); ts = resolve("TS"); nf = resolve("NF");
    tl = resolve("TL"); fn = resolve("FN"); fc = resolve("FC");
    fp = resolve("FP"); ba = resolve("BA"); qs = resolve("QS");
    bs = resolve("BS"); in_ = resolve("IN"); sc = resolve("SC");
    bb = resolve("BB"); qq = resolve("QQ"); dl = resolve("DL");
    rs = resolve("RS"); pd = resolve("PD"); hc = resolve("HC");
    mq = resolve("MQ");
    for (const auto& [key, enc] : comp.tag_enc) {
      Codec cd;
      if (cd.init(enc) && cd.bind(ext)) tag_codecs.emplace(key, std::move(cd));
    }
  }

  bool decode(const SliceHeader& sh, std::vector<LiteRec>& out) {
    int64_t prev_ap = sh.start;
    size_t base = out.size();
    out.reserve(base + (size_t)sh.n_records);
    for (int32_t i = 0; i < sh.n_records; ++i) {
      LiteRec r;
      int32_t vbf, vcf, vrl, vap, dummy;
      if (!bf || !cf || !bf->read_int(core, &vbf) || !cf->read_int(core, &vcf))
        return false;
      if (sh.ref_id == -2) {
        if (!ri || !ri->read_int(core, &r.ref_id)) return false;
      } else {
        r.ref_id = sh.ref_id;
      }
      if (!rl || !rl->read_int(core, &vrl)) return false;
      if (!ap || !ap->read_int(core, &vap)) return false;
      if (comp.ap_delta) {
        vap += (int32_t)prev_ap;
        prev_ap = vap;
      }
      r.pos = (int64_t)vap - 1;
      if (!rg || !rg->read_int(core, &dummy)) return false;
      if (comp.rn_preserved && (!rn || rn->skip_bytes(core) < 0)) return false;
      int32_t vmf = 0;
      if (vcf & 0x2) {  // detached
        int32_t vnp, vts;
        if (!mf || !mf->read_int(core, &vmf)) return false;
        if (!comp.rn_preserved && (!rn || rn->skip_bytes(core) < 0))
          return false;
        if (!ns || !np || !ts || !ns->read_int(core, &r.mate_ref) ||
            !np->read_int(core, &vnp) || !ts->read_int(core, &vts))
          return false;
      } else if (vcf & 0x4) {  // mate downstream
        if (!nf || !nf->read_int(core, &r.nf)) return false;
      }
      int32_t vtl;
      if (!tl || !tl->read_int(core, &vtl)) return false;
      if (vtl < 0 || vtl >= (int32_t)comp.tag_dict.size()) return false;
      for (int key : comp.tag_dict[vtl]) {
        auto it = tag_codecs.find(key);
        if (it == tag_codecs.end()) return false;
        if (it->second.skip_bytes(core) < 0) return false;
      }

      if (!(vbf & 0x4)) {  // mapped
        int32_t vfn;
        if (!fn || !fn->read_int(core, &vfn)) return false;
        int32_t ref_len = vrl;
        for (int32_t f = 0; f < vfn; ++f) {
          uint8_t vfc;
          int32_t vfp, op;
          uint8_t ob;
          if (!fc || !fp || !fc->read_byte(core, &vfc) ||
              !fp->read_int(core, &vfp))
            return false;
          int len;
          switch ((char)vfc) {
            case 'B':
              if (!ba || !qs || !ba->read_byte(core, &ob) ||
                  !qs->read_byte(core, &ob))
                return false;
              break;
            case 'X':
              if (!bs || !bs->read_byte(core, &ob)) return false;
              break;
            case 'I':
              if (!in_ || (len = in_->skip_bytes(core)) < 0) return false;
              ref_len -= len;
              break;
            case 'S':
              if (!sc || (len = sc->skip_bytes(core)) < 0) return false;
              ref_len -= len;
              break;
            case 'b':
              if (!bb || (len = bb->skip_bytes(core)) < 0) return false;
              break;
            case 'q':
              if (!qq || qq->skip_bytes(core) < 0) return false;
              break;
            case 'D':
              if (!dl || !dl->read_int(core, &op)) return false;
              ref_len += op;
              break;
            case 'N':
              if (!rs || !rs->read_int(core, &op)) return false;
              ref_len += op;
              break;
            case 'P':
              if (!pd || !pd->read_int(core, &op)) return false;
              break;
            case 'H':
              if (!hc || !hc->read_int(core, &op)) return false;
              break;
            case 'i':
              if (!ba || !ba->read_byte(core, &ob)) return false;
              ref_len -= 1;
              break;
            case 'Q':
              if (!qs || !qs->read_byte(core, &ob)) return false;
              break;
            default:
              return false;
          }
        }
        r.ref_len = ref_len > 0 ? ref_len : 0;
        if (!mq || !mq->read_int(core, &r.mapq)) return false;
        if (vcf & 0x1) {
          if (!qs || qs->skip_bytes(core, vrl) < 0) return false;
        }
      } else {  // unmapped
        if (!(vcf & 0x8)) {
          if (!ba || ba->skip_bytes(core, vrl) < 0) return false;
        }
        if (vcf & 0x1) {
          if (!qs || qs->skip_bytes(core, vrl) < 0) return false;
        }
      }
      r.flag = vbf | ((vmf & 1) ? 0x20 : 0) | ((vmf & 2) ? 0x8 : 0);
      out.push_back(r);
    }
    // resolve mate-downstream refs + flags
    for (size_t i = base; i < out.size(); ++i) {
      if (out[i].nf < 0) continue;
      size_t j = i + (size_t)out[i].nf + 1;
      if (j >= out.size()) continue;
      out[i].mate_ref = out[j].ref_id;
      out[j].mate_ref = out[i].ref_id;
      out[i].flag |= ((out[j].flag & 0x10) ? 0x20 : 0) | ((out[j].flag & 0x4) ? 0x8 : 0);
      out[j].flag |= ((out[i].flag & 0x10) ? 0x20 : 0) | ((out[i].flag & 0x4) ? 0x8 : 0);
    }
    return true;
  }
};

// ----------------------------------------------------------------- reader

struct CramFile {
  FILE* f = nullptr;
  std::vector<std::pair<std::string, int64_t>> refs;
  long data_start = 0;
  std::string path;

  ~CramFile() {
    if (f) fclose(f);
  }

  bool open(const char* p) {
    path = p;
    f = fopen(p, "rb");
    if (!f) return false;
    uint8_t magic[6];
    if (fread(magic, 1, 6, f) != 6 || memcmp(magic, "CRAM", 4) != 0)
      return false;
    if (magic[4] != 2 && magic[4] != 3) return false;
    fseek(f, 20, SEEK_CUR);  // file id
    ContainerHeader h;
    if (!read_container_header(f, &h)) return false;
    std::vector<uint8_t> body(h.length);
    if (fread(body.data(), 1, body.size(), f) != body.size()) return false;
    Cursor c(body.data(), body.size());
    Block b;
    if (!read_block(c, &b) || b.ctype != CT_FILE_HEADER) return false;
    if (b.data.size() < 4) return false;
    int32_t text_len;
    memcpy(&text_len, b.data.data(), 4);
    if (text_len < 0 || 4 + (size_t)text_len > b.data.size()) return false;
    std::string text((const char*)b.data.data() + 4, (size_t)text_len);
    size_t lpos = 0;
    while (lpos < text.size()) {
      size_t eol = text.find('\n', lpos);
      if (eol == std::string::npos) eol = text.size();
      std::string line = text.substr(lpos, eol - lpos);
      lpos = eol + 1;
      if (line.rfind("@SQ", 0) != 0) continue;
      std::string name;
      int64_t len = 0;
      size_t tpos = 0;
      while (tpos < line.size()) {
        size_t tab = line.find('\t', tpos);
        if (tab == std::string::npos) tab = line.size();
        std::string fieldv = line.substr(tpos, tab - tpos);
        tpos = tab + 1;
        if (fieldv.rfind("SN:", 0) == 0) name = fieldv.substr(3);
        if (fieldv.rfind("LN:", 0) == 0) len = atoll(fieldv.c_str() + 3);
      }
      if (len < 0 || len > (1LL << 35)) continue;  // corrupt @SQ length
      if (!name.empty()) refs.emplace_back(name, len);
    }
    data_start = ftell(f);
    return true;
  }

  int32_t ref_index(const char* chrom) const {
    for (size_t i = 0; i < refs.size(); ++i)
      if (refs[i].first == chrom) return (int32_t)i;
    return -1;
  }

  // Decode selected slices of the container body (all when landmarks empty).
  bool decode_container(const ContainerHeader& h, const std::vector<uint8_t>& body,
                        const std::vector<int32_t>& landmarks,
                        std::vector<LiteRec>& out) {
    Cursor c(body.data(), body.size());
    Block cb;
    if (!read_block(c, &cb) || cb.ctype != CT_COMP_HEADER) return false;
    CompHeader comp;
    if (!comp.parse(cb.data)) return false;
    const std::vector<int32_t>& lms =
        landmarks.empty() ? h.landmarks : landmarks;
    for (int32_t lm : lms) {
      if (lm < 0 || (size_t)lm >= body.size()) return false;
      Cursor sc(body.data() + lm, body.size() - lm);
      Block shb;
      if (!read_block(sc, &shb) || shb.ctype != CT_SLICE_HEADER) return false;
      SliceHeader sh;
      if (!sh.parse(shb.data)) return false;
      SliceDecoder dec(comp);
      Block core_block;  // CORE is bit-packed and tiny; decode eagerly
      for (int32_t bi = 0; bi < sh.n_blocks; ++bi) {
        RawBlock rb;
        if (!parse_block(sc, &rb)) return false;
        if (rb.ctype == CT_CORE) {
          if (!materialize_block(rb, core_block.data)) return false;
          dec.core.init(core_block.data.data(), core_block.data.size());
        } else if (rb.ctype == CT_EXTERNAL) {
          // DEFERRED: decompressed only if a codec reads actual bytes
          dec.ext.streams[rb.content_id].init(rb);
        }
      }
      dec.resolve_all();
      if (!dec.decode(sh, out)) return false;
    }
    return true;
  }

  // Iterate containers; cb returns false to stop.
  template <typename Fn>
  int for_each_container(Fn fn) {
    fseek(f, data_start, SEEK_SET);
    for (;;) {
      ContainerHeader h;
      long at = ftell(f);
      if (!read_container_header(f, &h)) return 0;
      std::vector<uint8_t> body(h.length);
      if (h.length &&
          fread(body.data(), 1, body.size(), f) != body.size())
        return -10;
      if (h.n_records == 0) {
        if (h.ref_id == -1 && h.start == 4542278) return 0;  // EOF marker
        continue;
      }
      int rc = fn(h, body, at);
      if (rc != 0) return rc < 0 ? rc : 0;
    }
  }

  template <typename Fn>
  int for_each_container_decoded(Fn fn);  // after DecodePool
};

// Process-wide decode worker pool shared by every full-file CRAM scan.
// Deliberately leaked (threads park on the condvar when idle): the library
// lives inside a Python process, and joining threads from a static
// destructor during interpreter teardown deadlocks. Size:
// GRID_TPU_DECODE_THREADS env override, else hardware_concurrency, capped
// at 8; < 2 disables the pool (scans decode inline).
class DecodePool {
 public:
  static DecodePool* get() {
    static DecodePool* pool = [] {
      int n = (int)std::thread::hardware_concurrency();
      if (const char* e = getenv("GRID_TPU_DECODE_THREADS")) n = atoi(e);
      if (n > 8) n = 8;
      return n >= 2 ? new DecodePool(n) : nullptr;
    }();
    return pool;
  }

  int size() const { return (int)threads_.size(); }

  void submit(std::function<void()> task) {
    {
      std::lock_guard<std::mutex> lk(m_);
      q_.push_back(std::move(task));
    }
    cv_.notify_one();
  }

 private:
  explicit DecodePool(int n) {
    for (int i = 0; i < n; ++i)
      threads_.emplace_back([this] {
        for (;;) {
          std::function<void()> task;
          {
            std::unique_lock<std::mutex> lk(m_);
            cv_.wait(lk, [this] { return !q_.empty(); });
            task = std::move(q_.front());
            q_.pop_front();
          }
          task();
        }
      });
  }

  std::vector<std::thread> threads_;
  std::deque<std::function<void()>> q_;
  std::mutex m_;
  std::condition_variable cv_;
};

// Pipelined full scan: the caller thread reads container bodies (the
// sequential IO) while pool workers run the slice/record decode; fn(h,
// recs) fires on the caller thread in container order. Falls back to
// inline decode without a pool. fn returns 0 to continue (<0 aborts).
template <typename Fn>
int CramFile::for_each_container_decoded(Fn fn) {
  DecodePool* pool = DecodePool::get();
  if (!pool) {
    std::vector<LiteRec> recs;
    return for_each_container(
        [&](const ContainerHeader& h, const std::vector<uint8_t>& body, long) {
          recs.clear();
          if (!decode_container(h, body, {}, recs)) return -11;
          return fn(h, recs);
        });
  }

  struct Pending {
    ContainerHeader h;
    std::vector<uint8_t> body;
    std::vector<LiteRec> recs;
    bool ok = false;
    bool done = false;
    std::mutex m;
    std::condition_variable cv;
  };
  std::deque<std::unique_ptr<Pending>> inflight;
  const size_t max_inflight = (size_t)pool->size() + 1;
  int rc = 0;

  auto drain_front = [&]() -> int {
    std::unique_ptr<Pending> p = std::move(inflight.front());
    inflight.pop_front();
    {
      std::unique_lock<std::mutex> lk(p->m);
      p->cv.wait(lk, [&] { return p->done; });
    }
    if (!p->ok) return -11;
    return fn(p->h, p->recs);
  };

  int io_rc = for_each_container(
      [&](const ContainerHeader& h, std::vector<uint8_t>& body, long) {
        if (rc != 0) return rc;  // stop reading after a downstream failure
        auto p = std::make_unique<Pending>();
        p->h = h;
        p->body = std::move(body);  // per-iteration buffer; safe to steal
        Pending* raw = p.get();
        pool->submit([this, raw] {
          bool ok = false;
          try {
            ok = decode_container(raw->h, raw->body, {}, raw->recs);
          } catch (const std::exception&) {
            ok = false;
          }
          {
            std::lock_guard<std::mutex> lk(raw->m);
            raw->ok = ok;
            raw->done = true;
          }
          raw->cv.notify_one();
        });
        inflight.push_back(std::move(p));
        if (inflight.size() >= max_inflight) rc = drain_front();
        return rc;
      });
  while (!inflight.empty()) {
    int r = drain_front();  // always drain: workers hold raw pointers
    if (rc == 0) rc = r;
  }
  if (rc != 0) return rc < 0 ? rc : 0;
  return io_rc;
}

// CRAI parse (gzip text).
bool read_crai(const std::string& path,
               std::vector<std::array<int64_t, 6>>& out) {
  gzFile g = gzopen(path.c_str(), "rb");
  if (!g) return false;
  char line[512];
  while (gzgets(g, line, sizeof(line))) {
    std::array<int64_t, 6> e{};
    if (sscanf(line, "%ld %ld %ld %ld %ld %ld", &e[0], &e[1], &e[2], &e[3],
               &e[4], &e[5]) == 6)
      out.push_back(e);
  }
  gzclose(g);
  return true;
}

bool collect_region_records(CramFile& cf, int32_t ref_id, int64_t start,
                            int64_t end, std::vector<LiteRec>& recs) {
  std::string crai = cf.path + ".crai";
  std::vector<std::array<int64_t, 6>> entries;
  FILE* probe = fopen(crai.c_str(), "rb");
  bool have_index = probe != nullptr;
  if (probe) fclose(probe);
  if (have_index && read_crai(crai, entries)) {
    std::map<int64_t, std::vector<int32_t>> hits;
    for (const auto& e : entries) {
      if (e[0] == -2 || (e[0] == ref_id && e[1] <= end && e[1] + e[2] > start))
        hits[e[3]].push_back((int32_t)e[4]);
    }
    for (const auto& [c_off, lms] : hits) {
      fseek(cf.f, (long)c_off, SEEK_SET);
      ContainerHeader h;
      if (!read_container_header(cf.f, &h)) return false;
      std::vector<uint8_t> body(h.length);
      if (fread(body.data(), 1, body.size(), cf.f) != body.size())
        return false;
      std::vector<int32_t> uniq(lms.begin(), lms.end());
      std::sort(uniq.begin(), uniq.end());
      uniq.erase(std::unique(uniq.begin(), uniq.end()), uniq.end());
      if (!cf.decode_container(h, body, uniq, recs)) return false;
    }
    return true;
  }
  // full scan (pool-pipelined container decode)
  int rc = cf.for_each_container_decoded(
      [&](const ContainerHeader&, std::vector<LiteRec>& r) {
        recs.insert(recs.end(), r.begin(), r.end());
        return 0;
      });
  return rc == 0;
}

// One full decode pass: per-bin overlap accumulation for every reference,
// optionally fused with the step-2 window read count (same filter as
// grid_cram_count / grid/utils/count_reads.py:96-107). Twin of bam.cpp's
// scan_bam_bins so BAM and CRAM cohorts share the one-pass ingest shape.
int scan_cram_bins(CramFile& cf, int32_t bin_size, int32_t exclude_flags,
                   int32_t bin_min_mapq,
                   std::vector<std::vector<int64_t>>* overlap,
                   int32_t count_ref, int64_t wstart, int64_t wend,
                   const int32_t* flags, int32_t n_flags,
                   int32_t count_min_mapq, int64_t* out_count,
                   gridtpu::WindowCounter* wc = nullptr) {
  overlap->assign(cf.refs.size(), {});
  for (size_t i = 0; i < cf.refs.size(); ++i)
    (*overlap)[i].assign((size_t)((cf.refs[i].second + bin_size - 1) / bin_size), 0);

  const bool counting = out_count != nullptr && count_ref >= 0;
  const bool multi = wc != nullptr && !wc->empty();
  std::set<int32_t> fset;
  if ((counting || multi) && flags) fset.insert(flags, flags + n_flags);
  int64_t count = 0;
  const bool any_count = counting || multi;

  int rc = cf.for_each_container_decoded(
      [&](const ContainerHeader&, std::vector<LiteRec>& recs) {
        for (const auto& r : recs) {
          const bool base_ok = any_count && fset.count(r.flag) &&
              r.mapq >= count_min_mapq && r.mate_ref == r.ref_id &&
              !(r.flag & (0x400 | 0x100));
          if (counting && base_ok && r.ref_id == count_ref &&
              r.pos >= wstart && r.pos < wend)
            ++count;
          if (multi && base_ok) wc->hit(r.ref_id, r.pos);
          if (r.ref_id < 0 || r.ref_id >= (int32_t)cf.refs.size()) continue;
          if (r.flag & exclude_flags) continue;
          if (r.mapq < bin_min_mapq) continue;
          int64_t beg = r.pos;
          int64_t endp = r.pos + (r.ref_len > 0 ? r.ref_len : 0);
          if (endp <= beg) continue;
          auto& bins = (*overlap)[r.ref_id];
          for (int64_t b = beg / bin_size;
               b <= (endp - 1) / bin_size && b < (int64_t)bins.size(); ++b) {
            int64_t bs = b * bin_size, be = bs + bin_size;
            int64_t o = std::min(endp, be) - std::max(beg, bs);
            if (o > 0) bins[b] += o;
          }
        }
        return 0;
      });
  if (rc != 0) return rc;
  if (out_count) *out_count = counting ? count : 0;
  return 0;
}

bool gridtpu_cram_write_bed(const char* out_path, const CramFile& cf,
                            const std::vector<std::vector<int64_t>>& overlap,
                            int32_t bin_size, bool skip_zero) {
  return gridtpu::write_bins_bed(out_path, cf.refs, overlap, bin_size, skip_zero);
}

}  // namespace

using gridtpu::WindowProducts;
using gridtpu::collect_window_bins;

extern "C" {

// Count reads in [start, end) with the reference filter semantics
// (flag in set, mapq >= min_mapq, mate on same ref, not dup/secondary,
// start <= pos < end). Returns the count, or a negative error code.
int64_t grid_cram_count(const char* path, const char* chrom, int64_t start,
                        int64_t end, const int32_t* flags, int32_t n_flags,
                        int32_t min_mapq) try {
  CramFile cf;
  if (!cf.open(path)) return -1;
  int32_t ref_id = cf.ref_index(chrom);
  if (ref_id < 0) return -4;
  std::vector<LiteRec> recs;
  if (!collect_region_records(cf, ref_id, start, end, recs)) return -2;
  std::set<int32_t> fset(flags, flags + n_flags);
  int64_t n = 0;
  for (const auto& r : recs) {
    if (r.ref_id != ref_id) continue;
    if (!fset.count(r.flag)) continue;
    if (r.mapq < min_mapq) continue;
    if (r.mate_ref != r.ref_id) continue;
    if (r.flag & (0x400 | 0x100)) continue;
    if (r.pos < start || r.pos >= end) continue;
    ++n;
  }
  return n;
} catch (const std::exception&) {
  return -99;  // corrupt input (e.g. allocation from a damaged size field)
}

// mosdepth-fast-mode binned depth over the whole file -> bed.gz
// (same overlap math as grid_bam_binned_depth).
int grid_cram_binned_depth(const char* path, const char* out_path,
                           int32_t bin_size, int32_t exclude_flags,
                           int32_t min_mapq, int32_t skip_zero) try {
  CramFile cf;
  if (!cf.open(path)) return -1;
  std::vector<std::vector<int64_t>> overlap;
  int rc = scan_cram_bins(cf, bin_size, exclude_flags, min_mapq, &overlap,
                          -1, 0, 0, nullptr, 0, 0, nullptr);
  if (rc != 0) return rc;
  if (!gridtpu_cram_write_bed(out_path, cf, overlap, bin_size, skip_zero != 0))
    return -3;
  return 0;
} catch (const std::exception&) {
  return -99;
}

// Reference names + lengths from the CRAM SAM header (twin of
// grid_bam_refs). names_out: NUL-separated names; lens_out: int64 lengths.
// Returns the reference count, or a negative error code.
int32_t grid_cram_refs(const char* path, char* names_out, int64_t cap,
                       int64_t* lens_out, int32_t max_refs) try {
  CramFile cf;
  if (!cf.open(path)) return -1;
  if ((int32_t)cf.refs.size() > max_refs) return -2;
  int64_t off = 0;
  for (size_t i = 0; i < cf.refs.size(); ++i) {
    const std::string& n = cf.refs[i].first;
    if (off + (int64_t)n.size() + 1 > cap) return -3;
    memcpy(names_out + off, n.data(), n.size());
    off += (int64_t)n.size();
    names_out[off++] = '\0';
    lens_out[i] = cf.refs[i].second;
  }
  return (int32_t)cf.refs.size();
} catch (const std::exception&) {
  return -99;
}

// Fused one-pass ingest for CRAM: steps 2+3 (+ the staging scan) in one
// decode pass. Twin of grid_bam_ingest (see bam.cpp for the semantics and
// the per-output parity contracts). Returns 0 or a negative error
// (-5: bins_cap too small; *out_nbins holds the required size).
int grid_cram_ingest_multi(const char* path, const char* out_bed,
                           int32_t bin_size, int32_t exclude_flags,
                           int32_t bin_min_mapq, int32_t skip_zero,
                           const char* chrom, int64_t wstart, int64_t wend,
                           const int32_t* flags, int32_t n_flags,
                           int32_t count_min_mapq,
                           const char* stage_chrom_prefix, int64_t* out_count,
                           int64_t* out_cov100, int32_t* bins_refid,
                           int64_t* bins_start, int64_t* bins_end,
                           double* bins_depth, int64_t bins_cap,
                           int64_t* out_nbins, const char* win_chroms,
                           const int64_t* win_starts, const int64_t* win_ends,
                           int32_t n_windows, int64_t* win_counts);

int grid_cram_ingest(const char* path, const char* out_bed, int32_t bin_size,
                     int32_t exclude_flags, int32_t bin_min_mapq,
                     int32_t skip_zero, const char* chrom, int64_t wstart,
                     int64_t wend, const int32_t* flags, int32_t n_flags,
                     int32_t count_min_mapq, const char* stage_chrom_prefix,
                     int64_t* out_count, int64_t* out_cov100,
                     int32_t* bins_refid, int64_t* bins_start,
                     int64_t* bins_end, double* bins_depth, int64_t bins_cap,
                     int64_t* out_nbins) {
  return grid_cram_ingest_multi(
      path, out_bed, bin_size, exclude_flags, bin_min_mapq, skip_zero, chrom,
      wstart, wend, flags, n_flags, count_min_mapq, stage_chrom_prefix,
      out_count, out_cov100, bins_refid, bins_start, bins_end, bins_depth,
      bins_cap, out_nbins, nullptr, nullptr, nullptr, 0, nullptr);
}

// grid_cram_ingest plus N extra count-only windows — CRAM twin of
// grid_bam_ingest_multi (see bam.cpp for the multi-window contract). A
// window whose chromosome is absent gets count -1 (the Python layer writes
// an Error counts row, matching the sequential CRAM count path, which
// raises on an unknown chromosome; BAM counts 0 — per-format parity).
int grid_cram_ingest_multi(const char* path, const char* out_bed,
                           int32_t bin_size, int32_t exclude_flags,
                           int32_t bin_min_mapq, int32_t skip_zero,
                           const char* chrom, int64_t wstart, int64_t wend,
                           const int32_t* flags, int32_t n_flags,
                           int32_t count_min_mapq,
                           const char* stage_chrom_prefix, int64_t* out_count,
                           int64_t* out_cov100, int32_t* bins_refid,
                           int64_t* bins_start, int64_t* bins_end,
                           double* bins_depth, int64_t bins_cap,
                           int64_t* out_nbins, const char* win_chroms,
                           const int64_t* win_starts, const int64_t* win_ends,
                           int32_t n_windows, int64_t* win_counts) try {
  CramFile cf;
  if (!cf.open(path)) return -1;
  int32_t count_ref = cf.ref_index(chrom);  // chr/no-chr alternates OK
  // unknown count chromosome: error like grid_cram_count (the sequential
  // CRAM path raises and records an Error counts row; BAM counts 0 —
  // each format's fused behavior matches its sequential behavior)
  if (count_ref < 0) return -4;
  gridtpu::WindowCounter wc(cf.refs.size(), (size_t)std::max(n_windows, 0));
  if (win_chroms && n_windows > 0) {
    auto wnames = gridtpu::split_names(win_chroms, n_windows);
    for (int32_t w = 0; w < n_windows; ++w) {
      // EXACT name match only — grid_cram_count raises on a name mismatch
      // (including chr/no-chr), so the window marks -1 and the caller
      // writes the same Error row the sequential per-locus count would.
      int32_t tid = cf.ref_index(wnames[w].c_str());
      if (tid < 0) {
        wc.counts[w] = -1;  // absent chromosome: Error row downstream
        continue;
      }
      wc.add(tid, win_starts[w], win_ends[w], w);
    }
    wc.finalize();
  }
  std::vector<std::vector<int64_t>> overlap;
  int rc = scan_cram_bins(cf, bin_size, exclude_flags, bin_min_mapq, &overlap,
                          count_ref, wstart, wend, flags, n_flags,
                          count_min_mapq, out_count,
                          (win_chroms && n_windows > 0) ? &wc : nullptr);
  if (rc != 0) return rc;
  if (win_counts && n_windows > 0)
    std::copy(wc.counts.begin(), wc.counts.end(), win_counts);

  int32_t cov_ref = -1;
  for (size_t i = 0; i < cf.refs.size(); ++i)
    if (cf.refs[i].first == chrom) { cov_ref = (int32_t)i; break; }
  WindowProducts wp = collect_window_bins(
      cf.refs, overlap, bin_size, cov_ref, stage_chrom_prefix, wstart, wend,
      bins_refid, bins_start, bins_end, bins_depth, bins_cap);
  if (out_cov100) *out_cov100 = wp.cov100;
  if (out_nbins) *out_nbins = wp.n_bins;
  if (wp.overflow) return -5;

  if (out_bed && out_bed[0] &&
      !gridtpu_cram_write_bed(out_bed, cf, overlap, bin_size, skip_zero != 0))
    return -3;
  return 0;
} catch (const std::exception&) {
  return -99;
}

// Flat record dump for twin tests: per record writes
// (ref_id, pos, flag, mapq, mate_ref, ref_len) into out (capacity cap
// records). Returns record count or negative error.
int64_t grid_cram_dump(const char* path, int64_t* out, int64_t cap) try {
  CramFile cf;
  if (!cf.open(path)) return -1;
  std::vector<LiteRec> recs;
  int rc = cf.for_each_container_decoded(
      [&](const ContainerHeader&, std::vector<LiteRec>& r) {
        recs.insert(recs.end(), r.begin(), r.end());
        return 0;
      });
  if (rc != 0) return rc;
  int64_t n = std::min<int64_t>((int64_t)recs.size(), cap);
  for (int64_t i = 0; i < n; ++i) {
    out[i * 6 + 0] = recs[i].ref_id;
    out[i * 6 + 1] = recs[i].pos;
    out[i * 6 + 2] = recs[i].flag;
    out[i * 6 + 3] = recs[i].mapq;
    out[i * 6 + 4] = recs[i].mate_ref;
    out[i * 6 + 5] = recs[i].ref_len;
  }
  return (int64_t)recs.size();
} catch (const std::exception&) {
  return -99;
}

}  // extern "C"
