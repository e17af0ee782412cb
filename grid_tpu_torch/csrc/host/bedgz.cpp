// Fast regions.bed.gz reader (zlib), feeding grid_tpu's host staging.
//
// Replaces the Python gzip+split line scan of the reference
// (grid/utils/normalize_mosdepth.py:262-285) — the dominant ingestion cost
// at cohort scale — with a buffered inflate + handwritten field parser.
// Filter semantics are identical:
//   * optional chromosome prefix match on the RAW line text;
//   * with a window: keep depth > 0 && reg_end >= win_start && reg_start <= win_end;
//     without: keep depth > 0;
//   * drop regions whose kb bins (start/1000 .. end/1000 inclusive) intersect
//     the per-chromosome exclusion list (repeat mask).
//
// C ABI: results are malloc'd arrays owned by the callee until
// grid_bed_free() is called.

#include <zlib.h>

#include "bedwrite.h"  // LibDeflateApi (runtime-resolved libdeflate)

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

struct Mask {
  // chrom name -> sorted kb bins
  std::unordered_map<std::string, std::unordered_set<int64_t>> bins;

  bool excluded(const char* chrom, size_t chrom_len, int64_t start, int64_t end) const {
    if (bins.empty()) return false;
    auto it = bins.find(std::string(chrom, chrom_len));
    if (it == bins.end()) return false;
    const auto& s = it->second;
    for (int64_t kb = start / 1000; kb <= end / 1000; ++kb) {
      if (s.count(kb)) return true;
    }
    return false;
  }
};

// Parse a non-negative integer; returns pointer past the number or nullptr.
inline const char* parse_i64(const char* p, const char* lim, int64_t* out) {
  if (p >= lim) return nullptr;
  int64_t v = 0;
  bool any = false;
  while (p < lim && *p >= '0' && *p <= '9') {
    v = v * 10 + (*p - '0');
    ++p;
    any = true;
  }
  if (!any) return nullptr;
  *out = v;
  return p;
}

inline const char* parse_double(const char* p, const char* lim, double* out) {
  if (p >= lim) return nullptr;
  // Fast path for mosdepth's fixed-point depths ([-]digits[.digits]):
  // accumulate every digit into ONE integer and divide once by 10^nf —
  // numerator and denominator are both exact doubles (<= 15 significant
  // digits), so the single rounding gives the IDENTICAL bits to strtod
  // (the byte-parity contract vs Python float()). strtod was ~40% of the
  // whole 3M-line scan (docs/perf.md r5).
  static const double P10[16] = {1.0, 1e1, 1e2, 1e3, 1e4, 1e5, 1e6, 1e7,
                                 1e8, 1e9, 1e10, 1e11, 1e12, 1e13, 1e14,
                                 1e15};
  const char* q = p;
  bool neg = false;
  if (*q == '-' || *q == '+') {
    neg = (*q == '-');
    ++q;
  }
  uint64_t digits = 0;
  int nd = 0, nf = -1;  // nf >= 0 once a '.' was seen
  const char* fast_end = nullptr;
  while (q < lim) {
    char c = *q;
    if (c >= '0' && c <= '9') {
      if (nd >= 15) break;  // would lose exactness: fall back
      digits = digits * 10 + (uint64_t)(c - '0');
      ++nd;
      if (nf >= 0) ++nf;
    } else if (c == '.' && nf < 0) {
      nf = 0;
    } else if (c == '\t' || c == '\n' || c == '\r') {
      fast_end = q;
      break;
    } else {
      break;  // exponent / inf / nan / junk: fall back
    }
    ++q;
  }
  if (q == lim) fast_end = q;
  if (fast_end && nd > 0) {
    double v = (double)digits / P10[nf > 0 ? nf : 0];
    *out = neg ? -v : v;
    return fast_end;
  }
  // slow path: anything the fast scan rejected (exponents, >15 digits)
  char buf[64];
  size_t n = 0;
  while (p < lim && *p != '\t' && *p != '\n' && *p != '\r' && n < sizeof(buf) - 1) {
    buf[n++] = *p++;
  }
  if (n == 0) return nullptr;
  buf[n] = 0;
  char* endp = nullptr;
  *out = strtod(buf, &endp);
  if (endp == buf) return nullptr;
  return p;
}

// Walk a BGZF file's independent gzip members, libdeflate-inflating each
// <=64 KiB block and feeding it to `consume` (zlib raw-inflate fallback).
// Returns 1 = handled, 0 = not BGZF (caller uses the generic-gzip path),
// -1 = corrupt/IO error (caller reports; Python falls back to its pure
// reader, which re-reads from the start — nothing was emitted to the
// caller's output arrays on error paths that matter, since the wrapper
// discards results on a nonzero rc).
template <class F>
int scan_bgzf(const char* path, F&& consume) {
  FILE* fp = fopen(path, "rb");
  if (!fp) return 0;
  uint8_t hdr[18];
  size_t got = fread(hdr, 1, sizeof hdr, fp);
  bool bgzf = got == sizeof hdr && hdr[0] == 0x1f && hdr[1] == 0x8b &&
              hdr[2] == 8 && (hdr[3] & 4) && hdr[12] == 'B' && hdr[13] == 'C';
  if (!bgzf) {
    fclose(fp);
    return 0;
  }
  if (fseek(fp, 0, SEEK_SET) != 0) {
    fclose(fp);
    return -1;
  }

  // Streaming member-by-member: BGZF blocks are <= 64 KiB compressed AND
  // uncompressed, so fixed bounded buffers suffice — a cohort scan with N
  // threads holds N x ~192 KiB, never N whole files.
  const gridtpu::LibDeflateApi& a = gridtpu::libdeflate_api();
  void* d = gridtpu::libdeflate_decompressor();
  std::vector<uint8_t> extra(1 << 16), cdata(1 << 16), ublock(1 << 16);
  auto fail = [&]() {
    fclose(fp);
    return -1;
  };
  for (;;) {
    uint8_t mh[12];
    size_t r = fread(mh, 1, sizeof mh, fp);
    if (r == 0) break;  // clean EOF at a member boundary
    if (r != sizeof mh) return fail();
    if (!(mh[0] == 0x1f && mh[1] == 0x8b && mh[2] == 8 && (mh[3] & 4)))
      return fail();
    uint16_t xlen = (uint16_t)mh[10] | ((uint16_t)mh[11] << 8);
    if (fread(extra.data(), 1, xlen, fp) != xlen) return fail();
    int32_t bsize = -1;
    for (size_t e = 0; e + 4 <= xlen;) {
      uint16_t slen = (uint16_t)extra[e + 2] | ((uint16_t)extra[e + 3] << 8);
      if (extra[e] == 'B' && extra[e + 1] == 'C' && slen == 2 &&
          e + 6 <= xlen) {
        bsize = ((int32_t)extra[e + 4] | ((int32_t)extra[e + 5] << 8)) + 1;
        break;
      }
      e += 4 + slen;
    }
    if (bsize < (int32_t)(12 + xlen + 8)) return fail();
    size_t cdata_len = (size_t)bsize - 12 - xlen - 8;
    if (cdata_len > cdata.size()) return fail();  // BGZF caps bsize at 64K
    if (fread(cdata.data(), 1, cdata_len, fp) != cdata_len) return fail();
    uint8_t tail[8];
    if (fread(tail, 1, 8, fp) != 8) return fail();
    uint32_t isize = (uint32_t)tail[4] | ((uint32_t)tail[5] << 8) |
                     ((uint32_t)tail[6] << 16) | ((uint32_t)tail[7] << 24);
    if (isize > (1u << 16)) return fail();
    if (isize) {
      if (d) {
        size_t actual = 0;
        if (a.deflate_decompress(d, cdata.data(), cdata_len, ublock.data(),
                                 ublock.size(), &actual) != 0 ||
            actual != isize)
          return fail();
      } else {
        z_stream zs;
        memset(&zs, 0, sizeof(zs));
        if (inflateInit2(&zs, -15) != Z_OK) return fail();
        zs.next_in = cdata.data();
        zs.avail_in = (uInt)cdata_len;
        zs.next_out = ublock.data();
        zs.avail_out = (uInt)ublock.size();
        int ret = inflate(&zs, Z_FINISH);
        inflateEnd(&zs);
        if (ret != Z_STREAM_END || zs.total_out != isize) return fail();
      }
      consume((const char*)ublock.data(), (int64_t)isize);
    }
  }
  fclose(fp);
  return 1;
}


// Drive `process_line(line, lim)` over every line of a bed.gz: the BGZF
// fast path when the container is blocked, the generic gzread stream
// otherwise; handles the cross-chunk carry. ONE implementation for both
// readers (window + grouped) so the container/IO handling cannot drift.
// Returns 0 ok, -1 open failure, -2 corrupt/IO error.
template <class Line>
int scan_bed_lines(const char* path, Line&& process_line) {
  const size_t BUF = 1 << 20;
  std::string carry;

  auto consume = [&](const char* data, int64_t got) {
    int64_t off = 0;
    while (off < got) {
      const char* nl = (const char*)memchr(data + off, '\n', got - off);
      if (!nl) {
        carry.append(data + off, got - off);
        break;
      }
      if (!carry.empty()) {
        carry.append(data + off, nl - (data + off));
        process_line(carry.data(), carry.data() + carry.size());
        carry.clear();
      } else {
        process_line(data + off, nl);
      }
      off = (nl - data) + 1;
    }
  };

  int bg = scan_bgzf(path, consume);
  if (bg < 0) return -2;
  if (bg == 0) {
    gzFile f = gzopen(path, "rb");
    if (!f) return -1;
    gzbuffer(f, 1 << 20);
    std::vector<char> buf(BUF);
    for (;;) {
      int got = gzread(f, buf.data(), BUF);
      if (got < 0) {
        gzclose(f);
        return -2;
      }
      if (got == 0) break;
      consume(buf.data(), got);
    }
    gzclose(f);
  }
  if (!carry.empty()) process_line(carry.data(), carry.data() + carry.size());
  return 0;
}

}  // namespace

extern "C" {

// chrom_filter: "chrN" prefix to require, or NULL.
// has_window: 0/1; win_start/win_end used when 1.
// mask_*: n_mask_chroms chromosome names in mask_names (NUL-separated),
//         mask_offsets[i]..mask_offsets[i+1] index into mask_kb.
// Outputs: *out_n rows in three malloc'd arrays. Returns 0 on success.
int grid_bed_read(const char* path, const char* chrom_filter, int has_window,
                  int64_t win_start, int64_t win_end, const char* mask_names,
                  int32_t n_mask_chroms, const int64_t* mask_offsets,
                  const int64_t* mask_kb, int64_t** out_starts,
                  int64_t** out_ends, double** out_depths, int64_t* out_n)
// function-try-block: a std::bad_alloc (result vectors at genome scale)
// must become an error code, not std::terminate through the C ABI — the
// Python side falls back to its pure reader on any nonzero rc
try {
  *out_starts = nullptr;
  *out_ends = nullptr;
  *out_depths = nullptr;
  *out_n = 0;

  Mask mask;
  const char* name_p = mask_names;
  for (int32_t i = 0; i < n_mask_chroms; ++i) {
    std::string name(name_p);
    name_p += name.size() + 1;
    auto& s = mask.bins[name];
    for (int64_t j = mask_offsets[i]; j < mask_offsets[i + 1]; ++j) s.insert(mask_kb[j]);
  }

  std::vector<int64_t> starts, ends;
  std::vector<double> depths;
  const size_t flt_len = chrom_filter ? strlen(chrom_filter) : 0;

  auto process_line = [&](const char* line, const char* lim) {
    if (line >= lim) return;
    // chromosome prefix filter on raw text (reference line.startswith)
    if (flt_len) {
      if ((size_t)(lim - line) < flt_len || memcmp(line, chrom_filter, flt_len) != 0) return;
    }
    // field 0: chrom
    const char* p = line;
    const char* tab = (const char*)memchr(p, '\t', lim - p);
    if (!tab) return;
    const char* chrom = p;
    size_t chrom_len = tab - p;
    // normalise "6" -> "chr6" for mask lookup (reference norm_chrom)
    char normed[64];
    const char* chrom_key = chrom;
    size_t chrom_key_len = chrom_len;
    if (chrom_len < 3 || memcmp(chrom, "chr", 3) != 0) {
      if (chrom_len + 3 < sizeof(normed)) {
        memcpy(normed, "chr", 3);
        memcpy(normed + 3, chrom, chrom_len);
        chrom_key = normed;
        chrom_key_len = chrom_len + 3;
      }
    }
    p = tab + 1;
    int64_t s, e;
    p = parse_i64(p, lim, &s);
    if (!p || p >= lim || *p != '\t') return;
    ++p;
    p = parse_i64(p, lim, &e);
    if (!p || p >= lim || *p != '\t') return;
    ++p;
    double d;
    p = parse_double(p, lim, &d);
    if (!p) return;

    if (has_window) {
      if (!(d > 0 && e >= win_start && s <= win_end)) return;
    } else if (d <= 0) {
      return;
    }
    if (mask.excluded(chrom_key, chrom_key_len, s, e)) return;

    starts.push_back(s);
    ends.push_back(e);
    depths.push_back(d);
  };

  int rc_scan = scan_bed_lines(path, process_line);
  if (rc_scan != 0) return rc_scan;

  int64_t n = (int64_t)starts.size();
  *out_starts = (int64_t*)malloc(sizeof(int64_t) * (n ? n : 1));
  *out_ends = (int64_t*)malloc(sizeof(int64_t) * (n ? n : 1));
  *out_depths = (double*)malloc(sizeof(double) * (n ? n : 1));
  if (!*out_starts || !*out_ends || !*out_depths) return -3;
  memcpy(*out_starts, starts.data(), sizeof(int64_t) * n);
  memcpy(*out_ends, ends.data(), sizeof(int64_t) * n);
  memcpy(*out_depths, depths.data(), sizeof(double) * n);
  *out_n = n;
  return 0;
} catch (...) {
  return -3;
}

void grid_bed_free(int64_t* starts, int64_t* ends, double* depths) {
  free(starts);
  free(ends);
  free(depths);
}

// Multi-chromosome variant mirroring io/bed.py:read_regions_bed_gz_grouped:
// NO window, depth > 0 filter (NaN kept, like Python's `depth <= 0`),
// kb-bin mask on the NORMALIZED chrom, and contiguous same-chrom runs
// become segments in file order.  Outputs: the three row arrays plus
// seg_names (NUL-separated NORMALIZED names, one per segment, malloc'd)
// and seg_bounds (n_segs+1 malloc'd offsets into the row arrays).
// Known leniency shared with grid_bed_read: a depth field like "1.2abc"
// parses as 1.2 where Python float() would reject the line.
int grid_bed_read_grouped(const char* path, const char* mask_names,
                          int32_t n_mask_chroms, const int64_t* mask_offsets,
                          const int64_t* mask_kb, int64_t** out_starts,
                          int64_t** out_ends, double** out_depths,
                          char** out_seg_names, int64_t* out_seg_names_len,
                          int64_t** out_seg_bounds, int64_t* out_n_segs,
                          int64_t* out_n)
try {
  *out_starts = nullptr;
  *out_ends = nullptr;
  *out_depths = nullptr;
  *out_seg_names = nullptr;
  *out_seg_names_len = 0;
  *out_seg_bounds = nullptr;
  *out_n_segs = 0;
  *out_n = 0;

  Mask mask;
  const char* name_p = mask_names;
  for (int32_t i = 0; i < n_mask_chroms; ++i) {
    std::string name(name_p);
    name_p += name.size() + 1;
    auto& s = mask.bins[name];
    for (int64_t j = mask_offsets[i]; j < mask_offsets[i + 1]; ++j)
      s.insert(mask_kb[j]);
  }

  std::vector<int64_t> starts, ends;
  std::vector<double> depths;
  std::string seg_names;            // NUL-separated normalized names
  std::vector<int64_t> seg_bounds;  // row offset where each segment starts
  std::string cur;                  // current segment's normalized chrom
  bool have_cur = false;

  auto process_line = [&](const char* line, const char* lim) {
    if (line >= lim) return;
    const char* p = line;
    const char* tab = (const char*)memchr(p, '\t', lim - p);
    if (!tab) return;
    const char* chrom = p;
    size_t chrom_len = tab - p;
    char normed[72];
    const char* chrom_key = chrom;
    size_t chrom_key_len = chrom_len;
    if (chrom_len < 3 || memcmp(chrom, "chr", 3) != 0) {
      if (chrom_len + 3 < sizeof(normed)) {
        memcpy(normed, "chr", 3);
        memcpy(normed + 3, chrom, chrom_len);
        chrom_key = normed;
        chrom_key_len = chrom_len + 3;
      }
    }
    p = tab + 1;
    int64_t s, e;
    p = parse_i64(p, lim, &s);
    if (!p || p >= lim || *p != '\t') return;
    ++p;
    p = parse_i64(p, lim, &e);
    if (!p || p >= lim || *p != '\t') return;
    ++p;
    double d;
    p = parse_double(p, lim, &d);
    if (!p) return;
    if (d <= 0) return;  // NaN compares false: kept, like Python
    if (mask.excluded(chrom_key, chrom_key_len, s, e)) return;

    if (!have_cur || cur.size() != chrom_key_len ||
        memcmp(cur.data(), chrom_key, chrom_key_len) != 0) {
      cur.assign(chrom_key, chrom_key_len);
      have_cur = true;
      seg_bounds.push_back((int64_t)starts.size());
      seg_names.append(cur);
      seg_names.push_back('\0');
    }
    starts.push_back(s);
    ends.push_back(e);
    depths.push_back(d);
  };

  int rc_scan = scan_bed_lines(path, process_line);
  if (rc_scan != 0) return rc_scan;

  int64_t n = (int64_t)starts.size();
  int64_t n_segs = (int64_t)seg_bounds.size();
  seg_bounds.push_back(n);
  *out_starts = (int64_t*)malloc(sizeof(int64_t) * (n ? n : 1));
  *out_ends = (int64_t*)malloc(sizeof(int64_t) * (n ? n : 1));
  *out_depths = (double*)malloc(sizeof(double) * (n ? n : 1));
  *out_seg_names = (char*)malloc(seg_names.size() ? seg_names.size() : 1);
  *out_seg_bounds = (int64_t*)malloc(sizeof(int64_t) * (n_segs + 1));
  if (!*out_starts || !*out_ends || !*out_depths || !*out_seg_names ||
      !*out_seg_bounds)
    return -3;
  memcpy(*out_starts, starts.data(), sizeof(int64_t) * n);
  memcpy(*out_ends, ends.data(), sizeof(int64_t) * n);
  memcpy(*out_depths, depths.data(), sizeof(double) * n);
  memcpy(*out_seg_names, seg_names.data(), seg_names.size());
  memcpy(*out_seg_bounds, seg_bounds.data(), sizeof(int64_t) * (n_segs + 1));
  *out_seg_names_len = (int64_t)seg_names.size();
  *out_n_segs = n_segs;
  *out_n = n;
  return 0;
} catch (...) {
  return -3;
}

void grid_bed_free_grouped(char* seg_names, int64_t* seg_bounds) {
  free(seg_names);
  free(seg_bounds);
}

}  // extern "C"
