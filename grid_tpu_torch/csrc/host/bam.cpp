// Native BAM machinery: region read counting, binned depth, BAI read/write.
//
// grid_tpu's TPU-native equivalent of the reference's pysam/htslib usage
// (grid/utils/count_reads.py:95, grid/utils/utils.py:87) and of the
// mosdepth Nim binary (grid/utils/mosdepth.py:177-225) — implemented from
// the SAM/BAM/BAI specification over the local BGZF reader, so the
// framework ingests BAM cohorts with zero external native dependencies.
//
// Counting filter semantics (identical to grid/utils/count_reads.py:96-107):
//   flag ∈ proper_flags, mapq >= min_mapq, refID == next_refID,
//   !(flag & DUP 0x400), !(flag & SECONDARY 0x100), start <= pos < end.
//
// Depth binning follows mosdepth --fast-mode: per read passing the default
// exclude mask (UNMAP|SECONDARY|QCFAIL|DUP = 1796), add its reference span
// [pos, pos + cigar_ref_len) into per-bin overlap accumulators; per-bin
// depth = overlapped_bp / bin_width, written as "chrom start end depth".

#include <zlib.h>

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <set>
#include <string>
#include <unordered_set>
#include <vector>

#include "bedwrite.h"
#include "bgzf.h"
#include "windows.h"

namespace gridtpu {
namespace {

constexpr uint16_t FLAG_UNMAP = 0x4;
constexpr uint16_t FLAG_SECONDARY = 0x100;
constexpr uint16_t FLAG_QCFAIL = 0x200;
constexpr uint16_t FLAG_DUP = 0x400;

struct Ref {
  std::string name;
  int32_t len;
};

struct BamHeader {
  std::vector<Ref> refs;
  int32_t tid(const char* name) const {
    for (size_t i = 0; i < refs.size(); ++i) {
      if (refs[i].name == name) return (int32_t)i;
    }
    // accept "chr6" vs "6" mismatches both ways
    std::string n(name);
    std::string alt = n.rfind("chr", 0) == 0 ? n.substr(3) : ("chr" + n);
    for (size_t i = 0; i < refs.size(); ++i) {
      if (refs[i].name == alt) return (int32_t)i;
    }
    return -1;
  }
};

inline int32_t rd_i32(const uint8_t* p) {
  int32_t v;
  memcpy(&v, p, 4);
  return v;
}
inline uint32_t rd_u32(const uint8_t* p) {
  uint32_t v;
  memcpy(&v, p, 4);
  return v;
}
inline uint16_t rd_u16(const uint8_t* p) {
  uint16_t v;
  memcpy(&v, p, 2);
  return v;
}

bool read_header(BgzfReader& r, BamHeader* hdr) {
  uint8_t magic[4];
  if (!r.read(magic, 4) || memcmp(magic, "BAM\1", 4) != 0) return false;
  uint8_t b4[4];
  if (!r.read(b4, 4)) return false;
  int32_t l_text = rd_i32(b4);
  if (l_text < 0) return false;
  if (!r.skip((size_t)l_text)) return false;
  if (!r.read(b4, 4)) return false;
  int32_t n_ref = rd_i32(b4);
  if (n_ref < 0 || n_ref > 1'000'000) return false;  // corrupt ref count
  hdr->refs.clear();
  hdr->refs.reserve(n_ref);
  for (int32_t i = 0; i < n_ref; ++i) {
    if (!r.read(b4, 4)) return false;
    int32_t l_name = rd_i32(b4);
    if (l_name < 1 || l_name > 4096) return false;  // corrupt name length
    std::string name(l_name, 0);
    if (!r.read(name.data(), l_name)) return false;
    name.resize(l_name - 1);  // drop trailing NUL
    if (!r.read(b4, 4)) return false;
    Ref ref;
    ref.name = name;
    ref.len = rd_i32(b4);
    hdr->refs.push_back(std::move(ref));
  }
  return true;
}

// A parsed (partially) alignment record.
struct Rec {
  int32_t refid;
  int32_t pos;
  uint8_t mapq;
  uint16_t flag;
  uint16_t n_cigar;
  int32_t next_refid;
  int32_t ref_span;  // reference bases consumed by the CIGAR (0 if unmapped)
};

// Read one record; data buffer is reused. Returns false at EOF.
bool read_record(BgzfReader& r, std::vector<uint8_t>& data, Rec* rec) {
  uint8_t b4[4];
  if (r.eof()) return false;
  if (!r.read(b4, 4)) return false;
  int32_t block_size = rd_i32(b4);
  if (block_size < 32 || block_size > (1 << 27)) return false;
  data.resize(block_size);
  if (!r.read(data.data(), block_size)) return false;
  const uint8_t* p = data.data();
  rec->refid = rd_i32(p + 0);
  rec->pos = rd_i32(p + 4);
  uint8_t l_read_name = p[8];
  rec->mapq = p[9];
  rec->n_cigar = rd_u16(p + 12);
  rec->flag = rd_u16(p + 14);
  rec->next_refid = rd_i32(p + 20);
  // CIGAR sits after the 32-byte fixed block + read name
  rec->ref_span = 0;
  size_t cig_off = 32 + l_read_name;
  if (cig_off + 4ull * rec->n_cigar <= (size_t)block_size) {
    for (uint16_t i = 0; i < rec->n_cigar; ++i) {
      uint32_t v = rd_u32(p + cig_off + 4ull * i);
      uint32_t op = v & 0xf, len = v >> 4;
      // M, D, N, =, X consume reference
      if (op == 0 || op == 2 || op == 3 || op == 7 || op == 8) rec->ref_span += (int32_t)len;
    }
  }
  return true;
}

// ---- BAI (SAM spec binning index) -----------------------------------------

constexpr int32_t MAX_BIN = ((1 << 18) - 1) / 7;  // 37449: bins for 2^29 range

int32_t reg2bin(int64_t beg, int64_t end) {
  --end;
  if (beg >> 14 == end >> 14) return (int32_t)(((1 << 15) - 1) / 7 + (beg >> 14));
  if (beg >> 17 == end >> 17) return (int32_t)(((1 << 12) - 1) / 7 + (beg >> 17));
  if (beg >> 20 == end >> 20) return (int32_t)(((1 << 9) - 1) / 7 + (beg >> 20));
  if (beg >> 23 == end >> 23) return (int32_t)(((1 << 6) - 1) / 7 + (beg >> 23));
  if (beg >> 26 == end >> 26) return (int32_t)(((1 << 3) - 1) / 7 + (beg >> 26));
  return 0;
}

void reg2bins(int64_t beg, int64_t end, std::vector<int32_t>* bins) {
  --end;
  bins->push_back(0);
  for (int64_t k = 1 + (beg >> 26); k <= 1 + (end >> 26); ++k) bins->push_back((int32_t)k);
  for (int64_t k = 9 + (beg >> 23); k <= 9 + (end >> 23); ++k) bins->push_back((int32_t)k);
  for (int64_t k = 73 + (beg >> 20); k <= 73 + (end >> 20); ++k) bins->push_back((int32_t)k);
  for (int64_t k = 585 + (beg >> 17); k <= 585 + (end >> 17); ++k) bins->push_back((int32_t)k);
  for (int64_t k = 4681 + (beg >> 14); k <= 4681 + (end >> 14); ++k) bins->push_back((int32_t)k);
}

struct Chunk {
  uint64_t beg, end;
};

struct BaiRef {
  std::map<int32_t, std::vector<Chunk>> bins;
  std::vector<uint64_t> ioffsets;  // 16kb linear index
};

struct Bai {
  std::vector<BaiRef> refs;
};

bool read_bai(const char* path, Bai* bai) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  auto rd = [&](void* dst, size_t n) { return fread(dst, 1, n, f) == n; };
  char magic[4];
  int32_t n_ref;
  bool ok = rd(magic, 4) && memcmp(magic, "BAI\1", 4) == 0 && rd(&n_ref, 4);
  if (ok && (n_ref < 0 || n_ref > 1'000'000)) ok = false;
  if (ok) {
    bai->refs.resize(n_ref);
    for (int32_t i = 0; ok && i < n_ref; ++i) {
      int32_t n_bin;
      ok = rd(&n_bin, 4);
      for (int32_t b = 0; ok && b < n_bin; ++b) {
        uint32_t bin;
        int32_t n_chunk;
        ok = rd(&bin, 4) && rd(&n_chunk, 4);
        if (!ok) break;
        if (n_chunk < 0 || n_chunk > 100'000'000) { ok = false; break; }
        auto& v = bai->refs[i].bins[(int32_t)bin];
        v.resize(n_chunk);
        for (int32_t c = 0; ok && c < n_chunk; ++c) {
          ok = rd(&v[c].beg, 8) && rd(&v[c].end, 8);
        }
      }
      int32_t n_intv;
      if (ok) ok = rd(&n_intv, 4);
      if (ok && (n_intv < 0 || n_intv > 100'000'000)) ok = false;
      if (ok) {
        bai->refs[i].ioffsets.resize(n_intv);
        for (int32_t c = 0; ok && c < n_intv; ++c) ok = rd(&bai->refs[i].ioffsets[c], 8);
      }
    }
  }
  fclose(f);
  return ok;
}

std::string bai_path_for(const char* bam_path) {
  std::string p(bam_path);
  std::string cand = p + ".bai";
  FILE* f = fopen(cand.c_str(), "rb");
  if (f) {
    fclose(f);
    return cand;
  }
  if (p.size() > 4 && p.substr(p.size() - 4) == ".bam") {
    cand = p.substr(0, p.size() - 4) + ".bai";
    f = fopen(cand.c_str(), "rb");
    if (f) {
      fclose(f);
      return cand;
    }
  }
  return "";
}

// One sequential scan: mosdepth-fast-mode per-bin overlap accumulation for
// every reference, optionally fused with the step-2 window read count
// (reference filter semantics, grid/utils/count_reads.py:96-107) so steps
// 2+3 share a single decompression pass over the BAM.
int scan_bam_bins(const char* path, int32_t bin_size, int32_t exclude_flags,
                  int32_t bin_min_mapq, BamHeader* hdr,
                  std::vector<std::vector<int64_t>>* overlap,
                  const char* count_chrom, int64_t wstart, int64_t wend,
                  const int32_t* flags, int32_t n_flags,
                  int32_t count_min_mapq, int64_t* out_count,
                  const std::vector<std::string>* win_chroms = nullptr,
                  const int64_t* win_starts = nullptr,
                  const int64_t* win_ends = nullptr,
                  int64_t* win_counts = nullptr) {
  BgzfReader r;
  if (!r.open(path)) return -1;
  if (!read_header(r, hdr)) return -2;

  overlap->assign(hdr->refs.size(), {});
  for (size_t i = 0; i < hdr->refs.size(); ++i)
    (*overlap)[i].assign((hdr->refs[i].len + bin_size - 1) / bin_size, 0);

  const bool counting = count_chrom != nullptr && out_count != nullptr;
  int32_t count_tid = counting ? hdr->tid(count_chrom) : -1;
  // extra count windows (multi-locus sweep): same filter, many windows,
  // counted in this same pass. Missing chromosome => window stays 0, like
  // grid_bam_count on an absent chromosome.
  WindowCounter wc(hdr->refs.size(),
                   win_chroms ? win_chroms->size() : 0);
  if (win_chroms) {
    for (size_t w = 0; w < win_chroms->size(); ++w)
      wc.add(hdr->tid((*win_chroms)[w].c_str()), win_starts[w], win_ends[w],
             (int32_t)w);
    wc.finalize();
  }
  const bool multi = win_chroms && !win_chroms->empty();
  std::unordered_set<int32_t> flagset;
  if ((counting || multi) && flags) flagset.insert(flags, flags + n_flags);
  int64_t count = 0;

  std::vector<uint8_t> buf;
  Rec rec;
  const bool any_count = counting || multi;
  while (read_record(r, buf, &rec)) {
    const bool base_ok = any_count && flagset.count((int32_t)rec.flag) &&
        rec.mapq >= count_min_mapq && rec.refid == rec.next_refid &&
        !(rec.flag & FLAG_DUP) && !(rec.flag & FLAG_SECONDARY);
    if (counting && base_ok && rec.refid == count_tid &&
        rec.pos >= wstart && rec.pos < wend)
      ++count;
    if (multi && base_ok) wc.hit(rec.refid, rec.pos);
    if (rec.refid < 0 || rec.refid >= (int32_t)hdr->refs.size()) continue;
    if (rec.flag & exclude_flags) continue;
    if (rec.mapq < bin_min_mapq) continue;
    int64_t beg = rec.pos;
    int64_t end = rec.pos + (rec.ref_span > 0 ? rec.ref_span : 0);
    if (beg < 0 || end <= beg) continue;
    auto& bins = (*overlap)[rec.refid];
    for (int64_t b = beg / bin_size; b <= (end - 1) / bin_size && b < (int64_t)bins.size(); ++b) {
      int64_t bs = b * bin_size, be = bs + bin_size;
      int64_t o = std::min(end, be) - std::max(beg, bs);
      if (o > 0) bins[b] += o;
    }
  }
  if (out_count) *out_count = count;
  if (win_counts && win_chroms)
    std::copy(wc.counts.begin(), wc.counts.end(), win_counts);
  return 0;
}

std::vector<std::pair<std::string, int64_t>> refs_as_pairs(const BamHeader& hdr) {
  std::vector<std::pair<std::string, int64_t>> refs;
  refs.reserve(hdr.refs.size());
  for (const auto& r : hdr.refs) refs.emplace_back(r.name, (int64_t)r.len);
  return refs;
}

}  // namespace
}  // namespace gridtpu

using namespace gridtpu;

extern "C" {

// Count reads passing the reference filter in [start, end) on `chrom`.
// flags: array of accepted SAM flag values (exact match), n_flags entries.
// Returns count >= 0, or negative error code.
int64_t grid_bam_count(const char* path, const char* chrom, int64_t start, int64_t end,
                       const int32_t* flags, int32_t n_flags, int32_t min_mapq) {
  BgzfReader r;
  if (!r.open(path)) return -1;
  BamHeader hdr;
  if (!read_header(r, &hdr)) return -2;
  int32_t tid = hdr.tid(chrom);
  if (tid < 0) return 0;

  std::unordered_set<int32_t> flagset(flags, flags + n_flags);

  auto passes = [&](const Rec& rec) {
    return rec.refid == tid && flagset.count((int32_t)rec.flag) &&
           rec.mapq >= min_mapq && rec.refid == rec.next_refid &&
           !(rec.flag & FLAG_DUP) && !(rec.flag & FLAG_SECONDARY) &&
           rec.pos >= start && rec.pos < end;
  };

  int64_t count = 0;
  std::vector<uint8_t> buf;
  Rec rec;

  std::string bai_path = bai_path_for(path);
  Bai bai;
  if (!bai_path.empty() && read_bai(bai_path.c_str(), &bai) && tid < (int32_t)bai.refs.size()) {
    // indexed path: gather candidate chunks, prune by linear index
    const BaiRef& ref = bai.refs[tid];
    std::vector<int32_t> cand;
    reg2bins(start, end, &cand);
    uint64_t min_off = 0;
    size_t intv = (size_t)(start >> 14);
    if (intv < ref.ioffsets.size()) min_off = ref.ioffsets[intv];
    std::vector<Chunk> chunks;
    for (int32_t b : cand) {
      auto it = ref.bins.find(b);
      if (it == ref.bins.end()) continue;
      for (const Chunk& c : it->second) {
        if (c.end > min_off) chunks.push_back(c);
      }
    }
    std::sort(chunks.begin(), chunks.end(),
              [](const Chunk& a, const Chunk& b) { return a.beg < b.beg; });
    // merge overlapping/adjacent chunks
    std::vector<Chunk> merged;
    for (const Chunk& c : chunks) {
      if (!merged.empty() && c.beg <= merged.back().end) {
        merged.back().end = std::max(merged.back().end, c.end);
      } else {
        merged.push_back(c);
      }
    }
    for (const Chunk& c : merged) {
      if (!r.seek(c.beg)) return -3;
      while (r.tell() < c.end) {
        if (!read_record(r, buf, &rec)) break;
        if (rec.refid != tid || rec.pos >= end) {
          if (rec.refid > tid || (rec.refid == tid && rec.pos >= end)) break;
          continue;
        }
        if (passes(rec)) ++count;
      }
    }
  } else {
    // no index: full sequential scan
    while (read_record(r, buf, &rec)) {
      if (passes(rec)) ++count;
    }
  }
  return count;
}

// Genome-binned depth (mosdepth --fast-mode semantics). Writes
// "chrom\tstart\tend\tdepth" gzip lines for every bin of every reference
// (skip_zero: zero-depth bins omitted except each contig's final bin —
// sparse mode for locus-subset cohorts; see bedwrite.h write_bins_bed).
int grid_bam_binned_depth(const char* path, const char* out_path, int32_t bin_size,
                          int32_t exclude_flags, int32_t min_mapq,
                          int32_t skip_zero) {
  BamHeader hdr;
  std::vector<std::vector<int64_t>> overlap;
  int rc = scan_bam_bins(path, bin_size, exclude_flags, min_mapq, &hdr, &overlap,
                         nullptr, 0, 0, nullptr, 0, 0, nullptr);
  if (rc != 0) return rc;
  if (!write_bins_bed(out_path, refs_as_pairs(hdr), overlap, bin_size,
                      skip_zero != 0))
    return -3;
  return 0;
}

// Fused one-pass ingest: steps 2+3 (+ the staging scan) in ONE decompression
// pass over the BAM. Replaces the reference's two-tool / two-pass shape
// (pysam count_reads + the mosdepth binary, grid/utils/count_reads.py:82-107
// and grid/utils/mosdepth.py:179-297):
//   - writes the genome-wide regions.bed.gz artifact (byte-identical to
//     grid_bam_binned_depth output),
//   - returns the step-2 window read count (*out_count),
//   - returns the step-3 window coverage int (*out_cov100, identical to
//     re-reading the dense bed through compute_region_coverage),
//   - fills the staged window bins (depth>0, rounded-as-written) so the
//     normalize stage never re-reads the bed.gz it just wrote.
// cov uses the EXACT chromosome name match (like compute_region_coverage);
// staged bins use the normalized-prefix match (like read_regions_bed_gz);
// the count accepts chr/no-chr alternates (like grid_bam_count).
// Returns 0, or negative error (-5: bins_cap too small; *out_nbins holds
// the required size).
int grid_bam_ingest_multi(const char* path, const char* out_bed,
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

int grid_bam_ingest(const char* path, const char* out_bed, int32_t bin_size,
                    int32_t exclude_flags, int32_t bin_min_mapq,
                    int32_t skip_zero, const char* chrom, int64_t wstart,
                    int64_t wend, const int32_t* flags, int32_t n_flags,
                    int32_t count_min_mapq, const char* stage_chrom_prefix,
                    int64_t* out_count, int64_t* out_cov100,
                    int32_t* bins_refid, int64_t* bins_start,
                    int64_t* bins_end, double* bins_depth, int64_t bins_cap,
                    int64_t* out_nbins) {
  return grid_bam_ingest_multi(
      path, out_bed, bin_size, exclude_flags, bin_min_mapq, skip_zero, chrom,
      wstart, wend, flags, n_flags, count_min_mapq, stage_chrom_prefix,
      out_count, out_cov100, bins_refid, bins_start, bins_end, bins_depth,
      bins_cap, out_nbins, nullptr, nullptr, nullptr, 0, nullptr);
}

// grid_bam_ingest plus N extra count-only windows (the multi-locus sweep:
// every catalog locus' step-2 count is a byproduct of the ONE genome scan,
// replacing the reference's per-locus indexed fetch per sample). Extra
// windows: win_chroms is a NUL-separated buffer of n_windows names
// (chr/no-chr alternates accepted); win_counts[w] receives the window's
// count (0 when the chromosome is absent, like grid_bam_count). The primary
// window keeps the full single-window contract (count + coverage + staged
// bins + bed.gz).
int grid_bam_ingest_multi(const char* path, const char* out_bed,
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
                          int32_t n_windows, int64_t* win_counts) {
  BamHeader hdr;
  std::vector<std::vector<int64_t>> overlap;
  std::vector<std::string> wnames;
  if (win_chroms && n_windows > 0)
    wnames = split_names(win_chroms, n_windows);
  int rc = scan_bam_bins(path, bin_size, exclude_flags, bin_min_mapq, &hdr,
                         &overlap, chrom, wstart, wend, flags, n_flags,
                         count_min_mapq, out_count,
                         wnames.empty() ? nullptr : &wnames, win_starts,
                         win_ends, win_counts);
  if (rc != 0) return rc;

  auto refs = refs_as_pairs(hdr);
  int32_t cov_ref = -1;
  for (size_t i = 0; i < refs.size(); ++i)
    if (refs[i].first == chrom) { cov_ref = (int32_t)i; break; }
  WindowProducts wp = collect_window_bins(
      refs, overlap, bin_size, cov_ref, stage_chrom_prefix, wstart, wend,
      bins_refid, bins_start, bins_end, bins_depth, bins_cap);
  if (out_cov100) *out_cov100 = wp.cov100;
  if (out_nbins) *out_nbins = wp.n_bins;
  if (wp.overflow) return -5;

  if (out_bed && out_bed[0] &&
      !write_bins_bed(out_bed, refs, overlap, bin_size, skip_zero != 0))
    return -3;
  return 0;
}

// Build a BAI index for a coordinate-sorted BAM.
int grid_bam_build_bai(const char* path, const char* out_path) {
  BgzfReader r;
  if (!r.open(path)) return -1;
  BamHeader hdr;
  if (!read_header(r, &hdr)) return -2;

  std::vector<BaiRef> refs(hdr.refs.size());
  std::vector<uint8_t> buf;
  Rec rec;

  for (;;) {
    uint64_t voff_start = r.tell();
    if (!read_record(r, buf, &rec)) break;
    uint64_t voff_end = r.tell();
    if (rec.refid < 0 || rec.refid >= (int32_t)refs.size()) continue;
    int64_t beg = rec.pos;
    int64_t end = rec.pos + std::max(rec.ref_span, 1);
    int32_t bin = reg2bin(beg, end);
    auto& chunks = refs[rec.refid].bins[bin];
    if (!chunks.empty() && chunks.back().end == voff_start) {
      chunks.back().end = voff_end;
    } else {
      chunks.push_back({voff_start, voff_end});
    }
    // linear index: min voffset per 16kb window covered by the read
    if (beg < 0 || end <= beg) continue;
    auto& io = refs[rec.refid].ioffsets;
    size_t first = (size_t)(beg >> 14), last = (size_t)((end - 1) >> 14);
    if (last > (1u << 22)) continue;  // corrupt coordinate
    if (io.size() <= last) io.resize(last + 1, 0);
    for (size_t w = first; w <= last; ++w) {
      if (io[w] == 0 || voff_start < io[w]) io[w] = voff_start;
    }
  }

  FILE* out = fopen(out_path, "wb");
  if (!out) return -3;
  auto wr = [&](const void* p, size_t n) { fwrite(p, 1, n, out); };
  wr("BAI\1", 4);
  int32_t n_ref = (int32_t)refs.size();
  wr(&n_ref, 4);
  for (const auto& ref : refs) {
    int32_t n_bin = (int32_t)ref.bins.size();
    wr(&n_bin, 4);
    for (const auto& [bin, chunks] : ref.bins) {
      uint32_t b = (uint32_t)bin;
      int32_t n_chunk = (int32_t)chunks.size();
      wr(&b, 4);
      wr(&n_chunk, 4);
      for (const Chunk& c : chunks) {
        wr(&c.beg, 8);
        wr(&c.end, 8);
      }
    }
    // fill linear-index gaps with the previous offset (spec-permitted)
    std::vector<uint64_t> io = ref.ioffsets;
    uint64_t prev = 0;
    for (auto& v : io) {
      if (v == 0) v = prev;
      prev = v;
    }
    int32_t n_intv = (int32_t)io.size();
    wr(&n_intv, 4);
    for (uint64_t v : io) wr(&v, 8);
  }
  fclose(out);
  return 0;
}

// Reference names/lengths inspection (for tests/tools).
// Fills up to cap chars of NUL-separated names; returns n_refs or negative.
int32_t grid_bam_refs(const char* path, char* names_out, int64_t cap, int32_t* lens_out,
                      int32_t max_refs) {
  BgzfReader r;
  if (!r.open(path)) return -1;
  BamHeader hdr;
  if (!read_header(r, &hdr)) return -2;
  int64_t off = 0;
  int32_t n = std::min<int32_t>((int32_t)hdr.refs.size(), max_refs);
  for (int32_t i = 0; i < n; ++i) {
    int64_t need = (int64_t)hdr.refs[i].name.size() + 1;
    if (off + need > cap) return -3;
    memcpy(names_out + off, hdr.refs[i].name.c_str(), need);
    off += need;
    lens_out[i] = hdr.refs[i].len;
  }
  return n;
}

}  // extern "C"

// ---- BGZF writing + BAM region subset -------------------------------------
// Covers the reference's subset_cram capability (utils/subset_cram.py:26-32)
// for BAM: copy the header plus all records overlapping [start, end) into a
// new coordinate-sorted BAM (used to build small test cohorts).

namespace gridtpu {
namespace {

class BgzfWriter {
 public:
  bool open(const char* path) {
    f_ = fopen(path, "wb");
    buf_.reserve(0xff00);
    return f_ != nullptr;
  }
  bool write(const void* data, size_t n) {
    const uint8_t* p = (const uint8_t*)data;
    while (n > 0) {
      size_t room = 0xff00 - buf_.size();
      size_t take = n < room ? n : room;
      buf_.insert(buf_.end(), p, p + take);
      p += take;
      n -= take;
      if (buf_.size() == 0xff00 && !flush_block()) return false;
    }
    return true;
  }
  bool close() {
    if (!f_) return true;
    bool ok = true;
    if (!buf_.empty()) ok = flush_block();
    // standard 28-byte BGZF EOF marker
    static const uint8_t kEof[28] = {0x1f, 0x8b, 0x08, 0x04, 0,    0,    0,    0,
                                     0,    0xff, 0x06, 0x00, 0x42, 0x43, 0x02, 0x00,
                                     0x1b, 0x00, 0x03, 0x00, 0,    0,    0,    0,
                                     0,    0,    0,    0};
    ok = ok && fwrite(kEof, 1, 28, f_) == 28;
    fclose(f_);
    f_ = nullptr;
    return ok;
  }
  ~BgzfWriter() { close(); }

 private:
  bool flush_block() {
    uLongf bound = compressBound((uLong)buf_.size());
    std::vector<uint8_t> cdata(bound);
    z_stream zs;
    memset(&zs, 0, sizeof(zs));
    if (deflateInit2(&zs, 6, Z_DEFLATED, -15, 8, Z_DEFAULT_STRATEGY) != Z_OK) return false;
    zs.next_in = buf_.data();
    zs.avail_in = (uInt)buf_.size();
    zs.next_out = cdata.data();
    zs.avail_out = (uInt)bound;
    int ret = deflate(&zs, Z_FINISH);
    uLong clen = zs.total_out;
    deflateEnd(&zs);
    if (ret != Z_STREAM_END) return false;

    uint32_t bsize = (uint32_t)(clen + 26);  // hdr12 + extra6 + cdata + crc4 + isize4
    uint8_t hdr[18] = {0x1f, 0x8b, 0x08, 0x04, 0, 0, 0, 0, 0, 0xff, 0x06, 0x00,
                       0x42, 0x43, 0x02, 0x00, 0, 0};
    hdr[16] = (uint8_t)((bsize - 1) & 0xff);
    hdr[17] = (uint8_t)(((bsize - 1) >> 8) & 0xff);
    uint32_t crc = crc32(0L, buf_.data(), (uInt)buf_.size());
    uint32_t isize = (uint32_t)buf_.size();
    bool ok = fwrite(hdr, 1, 18, f_) == 18 && fwrite(cdata.data(), 1, clen, f_) == clen &&
              fwrite(&crc, 1, 4, f_) == 4 && fwrite(&isize, 1, 4, f_) == 4;
    buf_.clear();
    return ok;
  }

  FILE* f_ = nullptr;
  std::vector<uint8_t> buf_;
};

}  // namespace
}  // namespace gridtpu

extern "C" {

// Subset records overlapping [start, end) on `chrom` into a new BAM.
// Returns number of records written, or negative error.
int64_t grid_bam_subset(const char* path, const char* chrom, int64_t start, int64_t end,
                        const char* out_path) {
  BgzfReader r;
  if (!r.open(path)) return -1;

  // Re-read the raw header bytes so the output preserves them verbatim.
  uint8_t magic[4];
  if (!r.read(magic, 4) || memcmp(magic, "BAM\1", 4) != 0) return -2;
  uint8_t b4[4];
  if (!r.read(b4, 4)) return -2;
  int32_t l_text = rd_i32(b4);
  std::vector<uint8_t> text(l_text);
  if (l_text && !r.read(text.data(), l_text)) return -2;
  if (!r.read(b4, 4)) return -2;
  int32_t n_ref = rd_i32(b4);

  BamHeader hdr;
  std::vector<uint8_t> ref_blob;
  for (int32_t i = 0; i < n_ref; ++i) {
    uint8_t lb[4];
    if (!r.read(lb, 4)) return -2;
    int32_t l_name = rd_i32(lb);
    if (l_name < 1 || l_name > 4096) return -2;
    std::vector<uint8_t> name(l_name);
    if (!r.read(name.data(), l_name)) return -2;
    uint8_t ln[4];
    if (!r.read(ln, 4)) return -2;
    Ref ref;
    ref.name.assign((const char*)name.data(), l_name - 1);
    ref.len = rd_i32(ln);
    hdr.refs.push_back(ref);
    ref_blob.insert(ref_blob.end(), lb, lb + 4);
    ref_blob.insert(ref_blob.end(), name.begin(), name.end());
    ref_blob.insert(ref_blob.end(), ln, ln + 4);
  }
  int32_t tid = hdr.tid(chrom);
  if (tid < 0) return -4;

  BgzfWriter w;
  if (!w.open(out_path)) return -5;
  w.write("BAM\1", 4);
  int32_t lt = l_text;
  w.write(&lt, 4);
  if (l_text) w.write(text.data(), l_text);
  w.write(&n_ref, 4);
  if (!ref_blob.empty()) w.write(ref_blob.data(), ref_blob.size());

  int64_t written = 0;
  std::vector<uint8_t> data;
  for (;;) {
    uint8_t bs4[4];
    if (r.eof()) break;
    if (!r.read(bs4, 4)) break;
    int32_t block_size = rd_i32(bs4);
    if (block_size < 32 || block_size > (1 << 27)) break;
    data.resize(block_size);
    if (!r.read(data.data(), block_size)) break;
    int32_t refid = rd_i32(data.data() + 0);
    int32_t pos = rd_i32(data.data() + 4);
    if (refid != tid) {
      if (refid > tid) break;
      continue;
    }
    if (pos >= end) break;
    // reference span for overlap check
    uint8_t l_read_name = data[8];
    uint16_t n_cigar = rd_u16(data.data() + 12);
    int32_t span = 0;
    size_t cig_off = 32 + l_read_name;
    if (cig_off + 4ull * n_cigar <= (size_t)block_size) {
      for (uint16_t i = 0; i < n_cigar; ++i) {
        uint32_t v = rd_u32(data.data() + cig_off + 4ull * i);
        uint32_t op = v & 0xf, len = v >> 4;
        if (op == 0 || op == 2 || op == 3 || op == 7 || op == 8) span += (int32_t)len;
      }
    }
    if (pos + std::max(span, 1) <= start) continue;
    w.write(bs4, 4);
    w.write(data.data(), block_size);
    ++written;
  }
  if (!w.close()) return -6;
  return written;
}

}  // extern "C"

// ---- region read fetch (positions + sequences) ----------------------------
// Feeds the realignment path: extract reads overlapping a window with their
// decoded sequences. Results are malloc'd; free with grid_bam_fetch_free.

extern "C" {

static const char kSeqCode[16] = {'=', 'A', 'C', 'M', 'G', 'R', 'S', 'V',
                                  'T', 'W', 'Y', 'H', 'K', 'D', 'B', 'N'};

// Fetch reads with pos in [start, end) passing (flag & exclude_flags) == 0
// and mapq >= min_mapq. Outputs:
//   out_pos[i], out_flag[i], out_mapq[i] per read;
//   out_seq: concatenated sequence bytes; out_seq_off[i]..out_seq_off[i+1]
//   delimit read i (out_seq_off has n+1 entries).
// Returns n >= 0 or negative error.
int64_t grid_bam_fetch(const char* path, const char* chrom, int64_t start, int64_t end,
                       int32_t exclude_flags, int32_t min_mapq, int64_t** out_pos,
                       int32_t** out_flag, int32_t** out_mapq, char** out_seq,
                       int64_t** out_seq_off) {
  *out_pos = nullptr;
  *out_flag = nullptr;
  *out_mapq = nullptr;
  *out_seq = nullptr;
  *out_seq_off = nullptr;

  BgzfReader r;
  if (!r.open(path)) return -1;
  BamHeader hdr;
  if (!read_header(r, &hdr)) return -2;
  int32_t tid = hdr.tid(chrom);
  if (tid < 0) return -4;

  std::vector<int64_t> poss;
  std::vector<int32_t> flags_v, mapqs;
  std::vector<char> seqs;
  std::vector<int64_t> offs;
  offs.push_back(0);

  std::vector<uint8_t> data;
  for (;;) {
    uint8_t b4[4];
    if (r.eof()) break;
    if (!r.read(b4, 4)) break;
    int32_t block_size = rd_i32(b4);
    if (block_size < 32 || block_size > (1 << 27)) break;
    data.resize(block_size);
    if (!r.read(data.data(), block_size)) break;
    const uint8_t* p = data.data();
    int32_t refid = rd_i32(p + 0);
    int32_t pos = rd_i32(p + 4);
    if (refid != tid) {
      if (refid > tid) break;
      continue;
    }
    if (pos >= end) break;
    if (pos < start) continue;
    uint8_t l_read_name = p[8];
    uint8_t mapq = p[9];
    uint16_t n_cigar = rd_u16(p + 12);
    uint16_t flag = rd_u16(p + 14);
    int32_t l_seq = rd_i32(p + 16);
    if (flag & exclude_flags) continue;
    if (mapq < min_mapq) continue;
    size_t seq_off = 32 + l_read_name + 4ull * n_cigar;
    if (seq_off + (l_seq + 1) / 2 > (size_t)block_size) continue;
    poss.push_back(pos);
    flags_v.push_back(flag);
    mapqs.push_back(mapq);
    for (int32_t i = 0; i < l_seq; ++i) {
      uint8_t nib = p[seq_off + i / 2];
      nib = (i % 2 == 0) ? (nib >> 4) : (nib & 0xf);
      seqs.push_back(kSeqCode[nib]);
    }
    offs.push_back((int64_t)seqs.size());
  }

  int64_t n = (int64_t)poss.size();
  *out_pos = (int64_t*)malloc(sizeof(int64_t) * (n ? n : 1));
  *out_flag = (int32_t*)malloc(sizeof(int32_t) * (n ? n : 1));
  *out_mapq = (int32_t*)malloc(sizeof(int32_t) * (n ? n : 1));
  *out_seq = (char*)malloc(seqs.size() ? seqs.size() : 1);
  *out_seq_off = (int64_t*)malloc(sizeof(int64_t) * (n + 1));
  if (!*out_pos || !*out_flag || !*out_mapq || !*out_seq || !*out_seq_off) return -5;
  memcpy(*out_pos, poss.data(), sizeof(int64_t) * n);
  memcpy(*out_flag, flags_v.data(), sizeof(int32_t) * n);
  memcpy(*out_mapq, mapqs.data(), sizeof(int32_t) * n);
  if (!seqs.empty()) memcpy(*out_seq, seqs.data(), seqs.size());
  memcpy(*out_seq_off, offs.data(), sizeof(int64_t) * (n + 1));
  return n;
}

void grid_bam_fetch_free(int64_t* pos, int32_t* flag, int32_t* mapq, char* seq,
                         int64_t* seq_off) {
  free(pos);
  free(flag);
  free(mapq);
  free(seq);
  free(seq_off);
}

}  // extern "C"
