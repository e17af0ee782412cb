// Fast %.2f-identical bed.gz emission shared by the BAM and CRAM binned-
// depth writers (and the fused ingest pass).
//
// The measured cost split for a dense genome-wide bed (160k bins):
// snprintf formatting 45 ms vs level-1 deflate 34 ms — so the formatter,
// not zlib, was the larger half of the binner's output wall. This header
// replaces snprintf with an integer fixed-point path that is byte-identical
// to printf's %.2f (fuzz-checked over 800k rationals in the commit that
// introduced it): depth cents are computed by round-half-even on the
// double (llrint under the default FP mode — the same tie rule printf
// applies to the decimal expansion), with an snprintf fallback inside a
// hairline guard band around exact .xx5 ties where one extra binary
// rounding could disagree.
//
// Output container (round 3): BGZF by default — the same block-gzip framing
// mosdepth itself emits for regions.bed.gz (every gzip consumer still reads
// it; tabix/CSI become possible). Blocks are raw-deflated with libdeflate
// when the system library exists (dlopen'd, ~3x faster than zlib level 1 at
// a comparable ratio), else with zlib. GRID_TPU_BED_FORMAT=gzip restores the
// previous single-member gzFile stream for A/B measurement.
#pragma once

#include <dlfcn.h>
#include <zlib.h>

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <mutex>
#include <string>
#include <unordered_map>
#include <utility>
#include <vector>

namespace gridtpu {

inline char* bed_u64toa(unsigned long long v, char* p) {
  char tmp[20];
  int n = 0;
  do {
    tmp[n++] = (char)('0' + (char)(v % 10));
    v /= 10;
  } while (v);
  while (n) *p++ = tmp[--n];
  return p;
}

// Integer cents equal to what snprintf("%.2f", x) prints (x >= 0).
inline long long bed_depth_cents(double x) {
  double v = x * 100.0;
  long long k = llrint(v);  // round-half-even (default FP mode)
  double d = v - (double)k;
  if (d > 0.4999999 || d < -0.4999999) {
    // within one multiply-rounding of an exact tie: defer to printf
    char buf[48];
    snprintf(buf, sizeof buf, "%.2f", x);
    return llrint(strtod(buf, nullptr) * 100.0);
  }
  return k;
}

// libdeflate, resolved at runtime so the build needs zlib + dl only.
// decompress(...) returns 0 (LIBDEFLATE_SUCCESS) on success.
struct LibDeflateApi {
  void* (*alloc_compressor)(int) = nullptr;
  size_t (*deflate_compress)(void*, const void*, size_t, void*, size_t) = nullptr;
  uint32_t (*crc32)(uint32_t, const void*, size_t) = nullptr;
  void (*free_compressor)(void*) = nullptr;
  void* (*alloc_decompressor)() = nullptr;
  int (*deflate_decompress)(void*, const void*, size_t, void*, size_t,
                            size_t*) = nullptr;
  int (*gzip_decompress)(void*, const void*, size_t, void*, size_t,
                         size_t*) = nullptr;
  int (*zlib_decompress)(void*, const void*, size_t, void*, size_t,
                         size_t*) = nullptr;
  void (*free_decompressor)(void*) = nullptr;
  bool ok = false;          // compression side usable
  bool ok_inflate = false;  // decompression side usable
};

inline const LibDeflateApi& libdeflate_api() {
  static LibDeflateApi api = [] {
    LibDeflateApi a;
    void* h = dlopen("libdeflate.so.0", RTLD_NOW | RTLD_GLOBAL);
    if (!h) h = dlopen("libdeflate.so", RTLD_NOW | RTLD_GLOBAL);
    if (!h) return a;
    a.alloc_compressor =
        (void* (*)(int))dlsym(h, "libdeflate_alloc_compressor");
    a.deflate_compress = (size_t(*)(void*, const void*, size_t, void*, size_t))
        dlsym(h, "libdeflate_deflate_compress");
    a.crc32 = (uint32_t(*)(uint32_t, const void*, size_t))
        dlsym(h, "libdeflate_crc32");
    a.free_compressor = (void (*)(void*))dlsym(h, "libdeflate_free_compressor");
    a.ok = a.alloc_compressor && a.deflate_compress && a.crc32 &&
           a.free_compressor;
    using dec_fn = int (*)(void*, const void*, size_t, void*, size_t, size_t*);
    a.alloc_decompressor =
        (void* (*)())dlsym(h, "libdeflate_alloc_decompressor");
    a.deflate_decompress = (dec_fn)dlsym(h, "libdeflate_deflate_decompress");
    a.gzip_decompress = (dec_fn)dlsym(h, "libdeflate_gzip_decompress");
    a.zlib_decompress = (dec_fn)dlsym(h, "libdeflate_zlib_decompress");
    a.free_decompressor =
        (void (*)(void*))dlsym(h, "libdeflate_free_decompressor");
    a.ok_inflate = a.alloc_decompressor && a.deflate_decompress &&
                   a.gzip_decompress && a.zlib_decompress &&
                   a.free_decompressor;
    return a;
  }();
  return api;
}

// One lazily-allocated decompressor per thread (libdeflate decompressors
// are not thread-safe but are reusable; never freed — thread lifetime).
inline void* libdeflate_decompressor() {
  const LibDeflateApi& a = libdeflate_api();
  if (!a.ok_inflate) return nullptr;
  thread_local void* d = a.alloc_decompressor();
  return d;
}

// Buffered writer of "chrom\tstart\tend\tD.DD\n" lines. Default container is
// BGZF (level-1 raw-deflate blocks, libdeflate when present); set
// GRID_TPU_BED_FORMAT=gzip for the legacy single-member gzip stream.
struct BedWriter {
  gzFile out = nullptr;  // legacy gzip backend
  FILE* bf = nullptr;    // BGZF backend (file sink)
  std::string* mem = nullptr;  // BGZF backend (memory sink — block cache)
  void* ld_comp = nullptr;
  z_stream zs;  // zlib raw-deflate fallback for BGZF blocks
  bool zs_live = false;
  std::string chunk;
  std::vector<uint8_t> cbuf;
  bool write_err = false;

  static bool use_bgzf() {
    const char* fmt = getenv("GRID_TPU_BED_FORMAT");
    return !(fmt && strcmp(fmt, "gzip") == 0);
  }

  bool init_bgzf_compressor() {
    chunk.reserve(kBlock + 256);
    cbuf.resize(1 << 16);
    const LibDeflateApi& api = libdeflate_api();
    if (api.ok) ld_comp = api.alloc_compressor(1);
    if (!ld_comp) {
      memset(&zs, 0, sizeof(zs));
      if (deflateInit2(&zs, 1, Z_DEFLATED, -15, 8, Z_DEFAULT_STRATEGY) != Z_OK)
        return false;
      zs_live = true;
    }
    return true;
  }

  bool open(const char* path) {
    write_err = false;
    if (!use_bgzf()) {
      out = gzopen(path, "wb1");
      if (!out) return false;
      gzbuffer(out, 1 << 20);
      chunk.reserve(1 << 20);
      return true;
    }
    bf = fopen(path, "wb");
    if (!bf) return false;
    if (!init_bgzf_compressor()) {
      fclose(bf);
      bf = nullptr;
      return false;
    }
    return true;
  }

  // BGZF-to-memory mode: compressed blocks append to *sink (no file, no
  // EOF marker) — used to build the reusable zero-contig block cache.
  bool open_mem(std::string* sink) {
    write_err = false;
    mem = sink;
    return init_bgzf_compressor();
  }

  void line(const char* name, size_t name_len, long long bs, long long be,
            long long cents) {
    char buf[192];
    char* p = buf;
    if (name_len > sizeof(buf) - 48) name_len = sizeof(buf) - 48;  // defensive
    memcpy(p, name, name_len);
    p += name_len;
    *p++ = '\t';
    p = bed_u64toa((unsigned long long)bs, p);
    *p++ = '\t';
    p = bed_u64toa((unsigned long long)be, p);
    *p++ = '\t';
    p = bed_u64toa((unsigned long long)(cents / 100), p);
    *p++ = '.';
    *p++ = (char)('0' + (char)((cents / 10) % 10));
    *p++ = (char)('0' + (char)(cents % 10));
    *p++ = '\n';
    chunk.append(buf, (size_t)(p - buf));
    if (bf || mem) {
      if (chunk.size() + sizeof(buf) > kBlock) flush();
    } else if (chunk.size() > (1 << 20) - 256) {
      flush();
    }
  }

  void flush() {
    if (chunk.empty()) return;
    if (bf || mem) {
      flush_bgzf_block((const uint8_t*)chunk.data(), chunk.size());
    } else if (gzwrite(out, chunk.data(), (unsigned)chunk.size()) <= 0) {
      write_err = true;
    }
    chunk.clear();
  }

  // Splice pre-compressed BGZF blocks (from the zero-run cache) into the
  // stream. Flushes first so the splice sits on a block boundary.
  void raw_blocks(const char* data, size_t n) {
    flush();
    if (bf) {
      if (fwrite(data, 1, n, bf) != n) write_err = true;
    } else if (mem) {
      mem->append(data, n);
    }
  }

  // returns false on any write/close error
  bool close() {
    flush();
    bool ok;
    if (mem) {
      if (ld_comp) libdeflate_api().free_compressor(ld_comp);
      ld_comp = nullptr;
      if (zs_live) deflateEnd(&zs);
      zs_live = false;
      mem = nullptr;
      return !write_err;
    }
    if (bf) {
      // standard 28-byte BGZF EOF marker (SAMv1 §4.1.2)
      static const uint8_t kEof[28] = {
          0x1f, 0x8b, 0x08, 0x04, 0,    0,    0,    0,    0,    0xff,
          0x06, 0x00, 0x42, 0x43, 0x02, 0x00, 0x1b, 0x00, 0x03, 0x00,
          0,    0,    0,    0,    0,    0,    0,    0};
      if (fwrite(kEof, 1, 28, bf) != 28) write_err = true;
      ok = fclose(bf) == 0 && !write_err;
      bf = nullptr;
      if (ld_comp) libdeflate_api().free_compressor(ld_comp);
      ld_comp = nullptr;
      if (zs_live) deflateEnd(&zs);
      zs_live = false;
    } else {
      ok = gzclose(out) == Z_OK && !write_err;
      out = nullptr;
    }
    return ok;
  }

 private:
  // Max uncompressed payload per BGZF block (htslib's choice; keeps the
  // on-disk block <= 64 KiB even on incompressible input).
  static const size_t kBlock = 0xff00;

  void flush_bgzf_block(const uint8_t* data, size_t n) {
    if (n > kBlock) {  // defensive: split oversized payloads
      flush_bgzf_block(data, n / 2);
      flush_bgzf_block(data + n / 2, n - n / 2);
      return;
    }
    size_t clen = 0;
    if (ld_comp) {
      clen = libdeflate_api().deflate_compress(ld_comp, data, n, cbuf.data(),
                                               cbuf.size());
    }
    if (clen == 0 && zs_live) {
      if (deflateReset(&zs) != Z_OK) {
        write_err = true;
        return;
      }
      zs.next_in = const_cast<uint8_t*>(data);
      zs.avail_in = (uInt)n;
      zs.next_out = cbuf.data();
      zs.avail_out = (uInt)cbuf.size();
      if (deflate(&zs, Z_FINISH) != Z_STREAM_END) {
        write_err = true;
        return;
      }
      clen = zs.total_out;
    }
    if (clen == 0 || clen + 26 > 0xffff) {
      if (n < 2) {
        write_err = true;  // cannot shrink further
        return;
      }
      flush_bgzf_block(data, n / 2);  // ratio < 1: halve and retry
      flush_bgzf_block(data + n / 2, n - n / 2);
      return;
    }
    uint32_t bsize = (uint32_t)(clen + 26);  // hdr18 + cdata + crc4 + isize4
    uint8_t hdr[18] = {0x1f, 0x8b, 0x08, 0x04, 0,    0,    0,    0,    0,
                       0xff, 0x06, 0x00, 0x42, 0x43, 0x02, 0x00, 0,    0};
    hdr[16] = (uint8_t)((bsize - 1) & 0xff);
    hdr[17] = (uint8_t)(((bsize - 1) >> 8) & 0xff);
    const LibDeflateApi& api = libdeflate_api();
    uint32_t crc = api.ok ? api.crc32(0, data, n)
                          : (uint32_t)crc32(0L, data, (uInt)n);
    uint8_t tail[8];
    memcpy(tail, &crc, 4);
    uint32_t isize = (uint32_t)n;
    memcpy(tail + 4, &isize, 4);
    if (mem) {
      mem->append((const char*)hdr, 18);
      mem->append((const char*)cbuf.data(), clen);
      mem->append((const char*)tail, 8);
      return;
    }
    if (fwrite(hdr, 1, 18, bf) != 18 ||
        fwrite(cbuf.data(), 1, clen, bf) != clen ||
        fwrite(tail, 1, 8, bf) != 8)
      write_err = true;
  }
};

// Cohort-invariant zero-run block cache. A cohort's bed.gz files differ
// only where reads landed: every bin range with no coverage produces
// EXACTLY the same "name\tstart\tend\t0.00" lines in every sample, and
// with BGZF framing (independent blocks) the compressed bytes can be
// spliced verbatim. The cache holds, per (contig, length, bin_size), the
// all-zero contig compressed into blocks of ~2,500 bins with each block's
// bin range recorded; the per-sample writer splices cached blocks for
// ranges its sample left untouched and fresh-compresses only blocks
// containing a nonzero bin. For locus-windowed cohorts (the 1000G e2e
// shape: one covered window in a 160k-bin contig) that removes ~99% of
// the deflate work — the dominant cost of the dense genome-wide bed
// (measured 15.6 of 15.9 ms/sample). Decompressed output is
// byte-identical; only block boundaries move (deterministic, same for
// every sample), which no gzip consumer observes. Process-wide,
// deliberately leaked (DecodePool pattern); a cohort populates one entry
// per contig on its first sample (~26 compressed bytes per block).
struct ZeroRunBlocks {
  struct Seg {
    size_t lo, hi;   // bin range [lo, hi) carried by this block
    size_t off, n;   // compressed bytes [off, off+n) in `bytes`
  };
  std::string bytes;
  std::vector<Seg> segs;
};

inline const ZeroRunBlocks* zero_run_blocks(const std::string& name,
                                            int64_t len, int32_t bin_size,
                                            size_t n_bins) {
  static std::mutex m;
  static auto* cache =
      new std::unordered_map<std::string, std::unique_ptr<ZeroRunBlocks>>();
  std::string key = name;
  key += '\0';
  key += std::to_string(len);
  key += '\0';
  key += std::to_string(bin_size);
  {
    std::lock_guard<std::mutex> lk(m);
    auto it = cache->find(key);
    if (it != cache->end()) return it->second.get();
  }
  // build outside the lock (two first-samples may race: both build, one
  // entry wins — harmless)
  auto zb = std::make_unique<ZeroRunBlocks>();
  BedWriter w;
  if (!w.open_mem(&zb->bytes)) return nullptr;
  size_t seg_lo = 0, prev_off = 0;
  for (size_t b = 0; b < n_bins; ++b) {
    int64_t bs = (int64_t)b * bin_size;
    int64_t be = bs + bin_size < len ? bs + bin_size : len;
    w.line(name.data(), name.size(), bs, be, 0);
    if (zb->bytes.size() != prev_off) {  // line() emitted a block
      zb->segs.push_back({seg_lo, b + 1, prev_off, zb->bytes.size() - prev_off});
      prev_off = zb->bytes.size();
      seg_lo = b + 1;
    }
  }
  w.flush();
  if (zb->bytes.size() != prev_off)
    zb->segs.push_back({seg_lo, n_bins, prev_off, zb->bytes.size() - prev_off});
  if (!w.close()) return nullptr;
  std::lock_guard<std::mutex> lk(m);
  auto& slot = (*cache)[key];
  if (!slot) slot = std::move(zb);
  return slot.get();
}

// Emit the full binned-depth bed.gz (mosdepth regions.bed.gz format).
// skip_zero omits zero-depth bins EXCEPT each contig's final bin (the
// sparse file must still record the contig extent — see steps/coverage.py
// compute_region_coverage). Byte-identical to the earlier snprintf writer.
inline bool write_bins_bed(
    const char* out_path,
    const std::vector<std::pair<std::string, int64_t>>& refs,
    const std::vector<std::vector<int64_t>>& overlap, int32_t bin_size,
    bool skip_zero) {
  BedWriter w;
  if (!w.open(out_path)) return false;
  // knob semantics match GRID_TPU_BATCH_INGEST: "0"/empty leaves the
  // cache ON; any other value disables it
  const char* nocache = getenv("GRID_TPU_BED_NOCACHE");
  const bool bgzf = BedWriter::use_bgzf() &&
                    !(nocache && nocache[0] && strcmp(nocache, "0") != 0);
  for (size_t i = 0; i < refs.size(); ++i) {
    const std::string& name = refs[i].first;
    const int64_t len = refs[i].second;
    const auto& bins = overlap[i];
    const ZeroRunBlocks* zb =
        (bgzf && !skip_zero && !bins.empty())
            ? zero_run_blocks(name, len, bin_size, bins.size())
            : nullptr;
    if (zb) {
      for (const auto& seg : zb->segs) {
        bool zero = true;
        for (size_t b = seg.lo; b < seg.hi; ++b)
          if (bins[b] != 0) {
            zero = false;
            break;
          }
        if (zero) {
          w.raw_blocks(zb->bytes.data() + seg.off, seg.n);
          continue;
        }
        for (size_t b = seg.lo; b < seg.hi; ++b) {
          int64_t bs = (int64_t)b * bin_size;
          int64_t be = bs + bin_size < len ? bs + bin_size : len;
          long long cents =
              bed_depth_cents((double)bins[b] / (double)(be - bs));
          w.line(name.data(), name.size(), bs, be, cents);
        }
        w.flush();  // keep later splices on block boundaries
      }
      continue;
    }
    for (size_t b = 0; b < bins.size(); ++b) {
      if (skip_zero && bins[b] == 0 && b + 1 < bins.size()) continue;
      int64_t bs = (int64_t)b * bin_size;
      int64_t be = bs + bin_size < len ? bs + bin_size : len;
      long long cents = bed_depth_cents((double)bins[b] / (double)(be - bs));
      w.line(name.data(), name.size(), bs, be, cents);
    }
  }
  return w.close();
}

// Window products of the fused one-pass ingest: the step-3 coverage integer
// (identical accumulation order/types to steps/coverage.py
// compute_region_coverage re-reading the dense bed) and the staged
// depth>0 bins for in-process staging (identical filter semantics to
// io/bed.py read_regions_bed_gz: ref-name PREFIX match on the normalized
// window chromosome, bin_end >= wstart, bin_start <= wend, depth > 0).
struct WindowProducts {
  long long cov100 = 0;   // int(round(100 * overlap-weighted window mean))
  int64_t n_bins = 0;     // staged bins matched (> bins_cap => overflow)
  bool overflow = false;
};

inline WindowProducts collect_window_bins(
    const std::vector<std::pair<std::string, int64_t>>& refs,
    const std::vector<std::vector<int64_t>>& overlap, int32_t bin_size,
    int32_t cov_ref,            // ref index whose name == chrom EXACTLY, or -1
    const char* chrom_prefix,   // normalized prefix for staged-bin refs
    int64_t wstart, int64_t wend, int32_t* bins_refid, int64_t* bins_start,
    int64_t* bins_end, double* bins_depth, int64_t bins_cap) {
  WindowProducts out;
  const size_t plen = chrom_prefix ? strlen(chrom_prefix) : 0;
  double region_cov = 0.0;
  int64_t covered_bp = 0;
  for (size_t i = 0; i < refs.size(); ++i) {
    const std::string& name = refs[i].first;
    const int64_t len = refs[i].second;
    const bool stage_ref =
        plen > 0 && name.size() >= plen && memcmp(name.data(), chrom_prefix, plen) == 0;
    const bool cov_this = (int32_t)i == cov_ref;
    if (!stage_ref && !cov_this) continue;
    const auto& bins = overlap[i];
    int64_t b_lo = wstart / bin_size - 1;
    if (b_lo < 0) b_lo = 0;
    int64_t b_hi = wend / bin_size;
    if (b_hi > (int64_t)bins.size() - 1) b_hi = (int64_t)bins.size() - 1;
    for (int64_t b = b_lo; b <= b_hi; ++b) {
      int64_t bs = b * bin_size;
      int64_t be = bs + bin_size < len ? bs + bin_size : len;
      if (be < wstart || bs > wend) continue;  // inclusive window, per reader
      long long cents = bed_depth_cents((double)bins[b] / (double)(be - bs));
      if (cov_this) {
        // compute_region_coverage semantics: overlap = min(end, r_end) -
        // max(start, r_start), zero-depth bins still count in covered_bp
        int64_t ov = (wend < be ? wend : be) - (wstart > bs ? wstart : bs);
        if (ov > 0) {
          region_cov += ((double)cents / 100.0) * (double)ov;
          covered_bp += ov;
        }
      }
      if (stage_ref && cents > 0) {
        if (out.n_bins < bins_cap) {
          bins_refid[out.n_bins] = (int32_t)i;
          bins_start[out.n_bins] = bs;
          bins_end[out.n_bins] = be;
          bins_depth[out.n_bins] = (double)cents / 100.0;
        } else {
          out.overflow = true;
        }
        ++out.n_bins;
      }
    }
  }
  out.cov100 = covered_bp > 0 ? llrint(100.0 * (region_cov / (double)covered_bp)) : 0;
  return out;
}

}  // namespace gridtpu
