// CRAM 3.0 writer (native twin of grid_tpu/io/cramlite.py's write path;
// the reference has no native code at all — it defers CRAM entirely to
// htslib via pysam, grid/utils/subset_cram.py:26-32). Produces
// spec-conformant single-slice containers with detached mates, verbatim
// base stretches ('b' features), gzip-compressed external blocks, CRC32
// trailers, and a CRAI index — byte-layout compatible with the Python
// reader/writer (round-trip tested against both).
//
// Records arrive from Python as packed column arrays (one ctypes call for
// the whole file) — no per-record FFI.

#include <zlib.h>

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <set>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

using Bytes = std::vector<uint8_t>;

void itf8_encode(Bytes& out, int64_t sv) {
  uint32_t v = (uint32_t)(sv & 0xFFFFFFFF);
  if (v < 0x80) {
    out.push_back((uint8_t)v);
  } else if (v < 0x4000) {
    out.push_back((uint8_t)(0x80 | (v >> 8)));
    out.push_back((uint8_t)(v & 0xFF));
  } else if (v < 0x200000) {
    out.push_back((uint8_t)(0xC0 | (v >> 16)));
    out.push_back((uint8_t)((v >> 8) & 0xFF));
    out.push_back((uint8_t)(v & 0xFF));
  } else if (v < 0x10000000) {
    out.push_back((uint8_t)(0xE0 | (v >> 24)));
    out.push_back((uint8_t)((v >> 16) & 0xFF));
    out.push_back((uint8_t)((v >> 8) & 0xFF));
    out.push_back((uint8_t)(v & 0xFF));
  } else {
    out.push_back((uint8_t)(0xF0 | (v >> 28)));
    out.push_back((uint8_t)((v >> 20) & 0xFF));
    out.push_back((uint8_t)((v >> 12) & 0xFF));
    out.push_back((uint8_t)((v >> 4) & 0xFF));
    out.push_back((uint8_t)(v & 0x0F));
  }
}

void ltf8_encode(Bytes& out, int64_t sv) {
  uint64_t v = (uint64_t)sv;
  if (v < 0x80) {
    out.push_back((uint8_t)v);
  } else if (v < 0x4000) {
    out.push_back((uint8_t)(0x80 | (v >> 8)));
    out.push_back((uint8_t)(v & 0xFF));
  } else if (v < 0x200000) {
    out.push_back((uint8_t)(0xC0 | (v >> 16)));
    out.push_back((uint8_t)((v >> 8) & 0xFF));
    out.push_back((uint8_t)(v & 0xFF));
  } else if (v < 0x10000000) {
    out.push_back((uint8_t)(0xE0 | (v >> 24)));
    out.push_back((uint8_t)((v >> 16) & 0xFF));
    out.push_back((uint8_t)((v >> 8) & 0xFF));
    out.push_back((uint8_t)(v & 0xFF));
  } else {
    // full 8-byte form covers every larger case unambiguously
    out.push_back(0xFF);
    for (int s = 56; s >= 0; s -= 8) out.push_back((uint8_t)((v >> s) & 0xFF));
  }
}

int gzip_level() {
  // level 1 by default, like the text output writers (io/formats.py:31):
  // decoded content is identical at every level; level 6 measured 1.45x
  // slower for ~27% smaller files at 200k records
  // (scripts/bench_write_throughput.py). GRID_TPU_GZ_LEVEL overrides
  // (e.g. 6/9 for archival).
  static int lvl = [] {
    const char* e = getenv("GRID_TPU_GZ_LEVEL");
    if (e && *e) {
      int v = atoi(e);
      if (v >= 0 && v <= 9) return v;
    }
    return 1;
  }();
  return lvl;
}

bool gzip_compress(const Bytes& src, Bytes& dst) {
  z_stream zs{};
  if (deflateInit2(&zs, gzip_level(), Z_DEFLATED, 15 + 16, 8,
                   Z_DEFAULT_STRATEGY) != Z_OK)
    return false;
  dst.resize(deflateBound(&zs, (uLong)src.size()));
  zs.next_in = const_cast<Bytef*>(src.data());
  zs.avail_in = (uInt)src.size();
  zs.next_out = dst.data();
  zs.avail_out = (uInt)dst.size();
  int rc = deflate(&zs, Z_FINISH);
  deflateEnd(&zs);
  if (rc != Z_STREAM_END) return false;
  dst.resize(zs.total_out);
  return true;
}

// method 0 = RAW, 1 = GZIP (auto-falls back to RAW when gzip grows)
constexpr uint8_t RAW = 0, GZIP = 1;
constexpr uint8_t CT_FILE_HEADER = 0, CT_COMPRESSION_HEADER = 1,
                  CT_SLICE_HEADER = 2, CT_EXTERNAL = 4, CT_CORE = 5;

void write_block(Bytes& out, uint8_t ctype, int32_t content_id,
                 const Bytes& data, uint8_t method) {
  Bytes comp;
  if (method == GZIP && gzip_compress(data, comp) && comp.size() < data.size()) {
    // keep gzip
  } else {
    method = RAW;
    comp = data;
  }
  Bytes blk;
  blk.push_back(method);
  blk.push_back(ctype);
  itf8_encode(blk, content_id);
  itf8_encode(blk, (int64_t)comp.size());
  itf8_encode(blk, (int64_t)data.size());
  blk.insert(blk.end(), comp.begin(), comp.end());
  uint32_t crc = (uint32_t)crc32(0L, blk.data(), (uInt)blk.size());
  out.insert(out.end(), blk.begin(), blk.end());
  for (int s = 0; s < 32; s += 8) out.push_back((uint8_t)((crc >> s) & 0xFF));
}

Bytes container_header(int64_t ref_id, int64_t start, int64_t span,
                       int64_t n_records, int64_t record_counter,
                       int64_t n_bases, int64_t n_blocks,
                       const std::vector<int64_t>& landmarks,
                       int64_t body_length) {
  Bytes h;
  int32_t bl = (int32_t)body_length;
  for (int s = 0; s < 32; s += 8) h.push_back((uint8_t)((bl >> s) & 0xFF));
  itf8_encode(h, ref_id);
  itf8_encode(h, start);
  itf8_encode(h, span);
  itf8_encode(h, n_records);
  ltf8_encode(h, record_counter);
  ltf8_encode(h, n_bases);
  itf8_encode(h, n_blocks);
  itf8_encode(h, (int64_t)landmarks.size());
  for (auto lm : landmarks) itf8_encode(h, lm);
  uint32_t crc = (uint32_t)crc32(0L, h.data(), (uInt)h.size());
  for (int s = 0; s < 32; s += 8) h.push_back((uint8_t)((crc >> s) & 0xFF));
  return h;
}

// data-series external-block content ids (must match the Python twin;
// 20 is cramlite's embedded-reference block id — skipped here)
enum SeriesId : int32_t {
  S_BF = 1, S_CF = 2, S_RL = 3, S_AP = 4, S_MF = 5, S_NS = 6, S_NP = 7,
  S_TS = 8, S_RN = 9, S_FN = 10, S_FC = 11, S_FP = 12, S_BBLEN = 13,
  S_BBVAL = 14, S_QS = 15, S_MQ = 16, S_BA = 17, S_RI = 18, S_BS = 19,
  S_SC = 21, S_IN = 22, S_DL = 23, S_RS = 24, S_PD = 25, S_HC = 26,
};

void enc_external(Bytes& out, const char key[2], int32_t cid) {
  out.push_back((uint8_t)key[0]);
  out.push_back((uint8_t)key[1]);
  itf8_encode(out, 1);  // codec EXTERNAL
  Bytes p;
  itf8_encode(p, cid);
  itf8_encode(out, (int64_t)p.size());
  out.insert(out.end(), p.begin(), p.end());
}

void enc_huffman_const(Bytes& out, const char key[2], int64_t value) {
  out.push_back((uint8_t)key[0]);
  out.push_back((uint8_t)key[1]);
  itf8_encode(out, 3);  // codec HUFFMAN
  Bytes p;
  itf8_encode(p, 1);
  itf8_encode(p, value);
  itf8_encode(p, 1);
  itf8_encode(p, 0);
  itf8_encode(out, (int64_t)p.size());
  out.insert(out.end(), p.begin(), p.end());
}

void enc_byte_array_stop(Bytes& out, const char key[2], uint8_t stop,
                         int32_t cid) {
  out.push_back((uint8_t)key[0]);
  out.push_back((uint8_t)key[1]);
  itf8_encode(out, 5);  // codec BYTE_ARRAY_STOP
  Bytes p;
  p.push_back(stop);
  itf8_encode(p, cid);
  itf8_encode(out, (int64_t)p.size());
  out.insert(out.end(), p.begin(), p.end());
}

void enc_byte_array_len(Bytes& out, const char key[2], int32_t len_cid,
                        int32_t val_cid) {
  out.push_back((uint8_t)key[0]);
  out.push_back((uint8_t)key[1]);
  itf8_encode(out, 4);  // codec BYTE_ARRAY_LEN
  Bytes p;
  itf8_encode(p, 1);  // len: EXTERNAL
  Bytes lp;
  itf8_encode(lp, len_cid);
  itf8_encode(p, (int64_t)lp.size());
  p.insert(p.end(), lp.begin(), lp.end());
  itf8_encode(p, 1);  // val: EXTERNAL
  Bytes vp;
  itf8_encode(vp, val_cid);
  itf8_encode(p, (int64_t)vp.size());
  p.insert(p.end(), vp.begin(), vp.end());
  itf8_encode(out, (int64_t)p.size());
  out.insert(out.end(), p.begin(), p.end());
}

Bytes compression_header(bool multi_ref) {
  // preservation map: RN=1, AP=1, RR=1, SM = 0x1B x5, TD = [[]]
  Bytes pres;
  int entries = 0;
  const char* keys1[] = {"RN", "AP", "RR"};
  for (auto* k : keys1) {
    pres.push_back((uint8_t)k[0]);
    pres.push_back((uint8_t)k[1]);
    pres.push_back(1);
    ++entries;
  }
  pres.push_back('S');
  pres.push_back('M');
  for (int i = 0; i < 5; ++i) pres.push_back(0x1B);
  ++entries;
  Bytes td = {0x00};
  pres.push_back('T');
  pres.push_back('D');
  itf8_encode(pres, (int64_t)td.size());
  pres.insert(pres.end(), td.begin(), td.end());
  ++entries;
  Bytes pres_map;
  itf8_encode(pres_map, entries);
  pres_map.insert(pres_map.end(), pres.begin(), pres.end());

  Bytes ser;
  int n_series = 0;
  auto EXT = [&](const char* k, int32_t cid) { enc_external(ser, k, cid); ++n_series; };
  EXT("BF", S_BF);
  EXT("CF", S_CF);
  EXT("RL", S_RL);
  EXT("AP", S_AP);
  enc_huffman_const(ser, "RG", -1);
  ++n_series;
  enc_byte_array_stop(ser, "RN", 0x00, S_RN);
  ++n_series;
  EXT("MF", S_MF);
  EXT("NS", S_NS);
  EXT("NP", S_NP);
  EXT("TS", S_TS);
  enc_huffman_const(ser, "TL", 0);
  ++n_series;
  EXT("FN", S_FN);
  EXT("FC", S_FC);
  EXT("FP", S_FP);
  enc_byte_array_len(ser, "BB", S_BBLEN, S_BBVAL);
  ++n_series;
  EXT("QS", S_QS);
  EXT("MQ", S_MQ);
  EXT("BA", S_BA);
  EXT("BS", S_BS);
  // CIGAR-feature series (declared-but-absent blocks are fine — readers
  // bind codecs lazily, exactly as BA behaves for all-mapped slices)
  enc_byte_array_stop(ser, "SC", 0x00, S_SC);
  ++n_series;
  enc_byte_array_stop(ser, "IN", 0x00, S_IN);
  ++n_series;
  EXT("DL", S_DL);
  EXT("RS", S_RS);
  EXT("PD", S_PD);
  EXT("HC", S_HC);
  if (multi_ref) EXT("RI", S_RI);
  Bytes ser_map;
  itf8_encode(ser_map, n_series);
  ser_map.insert(ser_map.end(), ser.begin(), ser.end());

  Bytes tag_map;
  itf8_encode(tag_map, 0);

  Bytes out;
  for (const Bytes* m : {&pres_map, &ser_map, &tag_map}) {
    itf8_encode(out, (int64_t)m->size());
    out.insert(out.end(), m->begin(), m->end());
  }
  return out;
}

constexpr int32_t MATE_REVERSE = 0x20, MATE_UNMAPPED = 0x8;
constexpr int32_t CF_QS_STORED = 1, CF_DETACHED = 2, CF_NO_SEQ = 8;

struct RecView {
  int32_t flag, ref_id, mapq, rl, mate_ref_id, tlen;
  int64_t pos, mate_pos;
  const char* name;
  int32_t name_len;
  const char* seq;
  int32_t seq_len;
  const uint8_t* qual;
  int32_t qual_len;
  const uint32_t* cig;  // BAM packed ops (len<<4 | op), or nullptr
  int32_t n_cig;
};

// BAM CIGAR op codes: MIDNSHP=X
constexpr char kCigChar[9] = {'M', 'I', 'D', 'N', 'S', 'H', 'P', '=', 'X'};

inline bool cig_consumes_read(uint32_t op) {
  return op == 0 || op == 1 || op == 4 || op == 7 || op == 8;
}
inline bool cig_consumes_ref(uint32_t op) {
  return op == 0 || op == 2 || op == 3 || op == 7 || op == 8;
}
inline bool cig_match_like(uint32_t op) { return op == 0 || op == 7 || op == 8; }

inline bool cigar_trivial(const RecView& r) {
  for (int32_t i = 0; i < r.n_cig; ++i)
    if (!cig_match_like(r.cig[i] & 0xF)) return false;
  return true;
}

inline int64_t cigar_ref_len(const RecView& r) {
  int64_t n = 0;
  for (int32_t i = 0; i < r.n_cig; ++i)
    if (cig_consumes_ref(r.cig[i] & 0xF)) n += r.cig[i] >> 4;
  return n;
}

struct SliceMeta {
  int64_t ref_id, start, span, landmark, n_records, n_bases, n_blocks;
};

Bytes encode_slice(const std::vector<RecView>& recs, int64_t record_counter,
                   SliceMeta* meta) {
  std::set<int32_t> ref_ids;
  for (const auto& r : recs) ref_ids.insert(r.ref_id);
  bool multi_ref = ref_ids.size() != 1;
  int64_t slice_ref = multi_ref ? -2 : recs[0].ref_id;
  int64_t s_start = 0, s_span = 0;
  if (!multi_ref) {
    int64_t lo = INT64_MAX, hi = INT64_MIN;
    for (const auto& r : recs) {
      if (r.ref_id >= 0 && r.pos >= 0) {
        lo = std::min(lo, r.pos + 1);
        int64_t span = r.rl > 0 ? r.rl : 1;
        if (r.n_cig > 0 && !(r.flag & 0x4)) span = cigar_ref_len(r);
        hi = std::max(hi, r.pos + std::max<int64_t>(span, 1));
      }
    }
    if (lo != INT64_MAX) {
      s_start = lo;
      s_span = hi - lo + 1;
    }
  }

  Bytes bf, cf, rl_b, ap, rn, mf, ns, np_b, ts, fn, fc, fp, bblen, bbval, qs,
      mq, ba, ri, sc, in_b, dl, rs, pd, hc;
  int64_t prev_ap = s_start;
  int64_t n_bases = 0;
  for (const auto& r : recs) {
    int32_t rl = r.rl > 0 ? r.rl : r.seq_len;
    n_bases += rl;
    int32_t cflags = CF_DETACHED;
    if (r.qual_len > 0) cflags |= CF_QS_STORED;
    if (r.seq_len == 0) cflags |= CF_NO_SEQ;
    itf8_encode(bf, r.flag & ~(MATE_REVERSE | MATE_UNMAPPED));
    itf8_encode(cf, cflags);
    if (multi_ref) itf8_encode(ri, r.ref_id);
    itf8_encode(rl_b, rl);
    int64_t apv = r.pos + 1;
    itf8_encode(ap, apv - prev_ap);
    prev_ap = apv;
    rn.insert(rn.end(), (const uint8_t*)r.name, (const uint8_t*)r.name + r.name_len);
    rn.push_back(0);
    int32_t mfv = ((r.flag & MATE_REVERSE) ? 1 : 0) | ((r.flag & MATE_UNMAPPED) ? 2 : 0);
    itf8_encode(mf, mfv);
    itf8_encode(ns, r.mate_ref_id);
    itf8_encode(np_b, r.mate_pos + 1);
    itf8_encode(ts, r.tlen);
    if (!(r.flag & 0x4)) {  // mapped
      if (r.seq_len == 0) {
        // SEQ "*" with a real CIGAR (CF_NO_SEQ set above): emit the
        // positional features so the alignment geometry round-trips —
        // S/I carry placeholder 'N' stretches (readers ignore bases under
        // CF_NO_SEQ and rebuild the CIGAR from feature lengths); M
        // segments need no feature at all. Twin of cramlite's
        // skip_match=True path.
        int32_t nfeat = 0;
        if (r.n_cig > 0 && !cigar_trivial(r))
          for (int32_t i = 0; i < r.n_cig; ++i)
            if (!cig_match_like(r.cig[i] & 0xF)) ++nfeat;
        itf8_encode(fn, nfeat);
        if (nfeat > 0) {
          int64_t rp = 1, prev_fp = 0;
          for (int32_t i = 0; i < r.n_cig; ++i) {
            uint32_t op = r.cig[i] & 0xF;
            int64_t n = r.cig[i] >> 4;
            if (cig_match_like(op)) {
              rp += n;
              continue;
            }
            char code;
            Bytes* payload_ba = nullptr;
            Bytes* payload_int = nullptr;
            switch (op) {
              case 1: code = 'I'; payload_ba = &in_b; break;
              case 4: code = 'S'; payload_ba = &sc; break;
              case 2: code = 'D'; payload_int = &dl; break;
              case 3: code = 'N'; payload_int = &rs; break;
              case 5: code = 'H'; payload_int = &hc; break;
              case 6: code = 'P'; payload_int = &pd; break;
              default: throw std::length_error("bad cigar op");
            }
            fc.push_back((uint8_t)code);
            itf8_encode(fp, rp - prev_fp);
            prev_fp = rp;
            if (payload_ba) {
              payload_ba->insert(payload_ba->end(), (size_t)n, (uint8_t)'N');
              payload_ba->push_back(0x00);
              rp += n;
            } else {
              itf8_encode(*payload_int, n);
            }
          }
        }
      } else if (r.n_cig > 0 && !cigar_trivial(r)) {
        // CIGAR-preserving encode (verbatim 'b' stretches for match runs;
        // S/I/D/N/H/P become their CRAM feature codes). Count features
        // first: one per op, with adjacent match-like ops merged.
        int32_t nfeat = 0;
        for (int32_t i = 0; i < r.n_cig; ++i) {
          uint32_t op = r.cig[i] & 0xF;
          if (cig_match_like(op) && i > 0 && cig_match_like(r.cig[i - 1] & 0xF))
            continue;  // merged into the previous 'b'
          ++nfeat;
        }
        itf8_encode(fn, nfeat);
        int64_t rp = 1, prev_fp = 0;
        for (int32_t i = 0; i < r.n_cig; ++i) {
          uint32_t op = r.cig[i] & 0xF;
          int64_t n = r.cig[i] >> 4;
          if (cig_match_like(op)) {
            // merge the full match-like run into one 'b' stretch
            if (i > 0 && cig_match_like(r.cig[i - 1] & 0xF)) {
              // already emitted as part of the run head
              continue;
            }
            int64_t run = 0;
            for (int32_t j = i; j < r.n_cig && cig_match_like(r.cig[j] & 0xF); ++j)
              run += r.cig[j] >> 4;
            if (rp - 1 + run > r.seq_len) throw std::length_error("cigar>seq");
            fc.push_back('b');
            itf8_encode(fp, rp - prev_fp);
            prev_fp = rp;
            itf8_encode(bblen, run);
            bbval.insert(bbval.end(), (const uint8_t*)r.seq + rp - 1,
                         (const uint8_t*)r.seq + rp - 1 + run);
            rp += run;
            continue;
          }
          char code;
          Bytes* payload_ba = nullptr;  // byte-array series (stop 0x00)
          Bytes* payload_int = nullptr; // itf8 length series
          switch (op) {
            case 1: code = 'I'; payload_ba = &in_b; break;
            case 4: code = 'S'; payload_ba = &sc; break;
            case 2: code = 'D'; payload_int = &dl; break;
            case 3: code = 'N'; payload_int = &rs; break;
            case 5: code = 'H'; payload_int = &hc; break;
            case 6: code = 'P'; payload_int = &pd; break;
            default: throw std::length_error("bad cigar op");
          }
          fc.push_back((uint8_t)code);
          itf8_encode(fp, rp - prev_fp);
          prev_fp = rp;
          if (payload_ba) {
            if (rp - 1 + n > r.seq_len) throw std::length_error("cigar>seq");
            payload_ba->insert(payload_ba->end(), (const uint8_t*)r.seq + rp - 1,
                               (const uint8_t*)r.seq + rp - 1 + n);
            payload_ba->push_back(0x00);
            rp += n;
          } else {
            itf8_encode(*payload_int, n);
          }
        }
      } else {
        itf8_encode(fn, 1);
        fc.push_back('b');  // verbatim base stretch
        itf8_encode(fp, 1);
        itf8_encode(bblen, r.seq_len);
        bbval.insert(bbval.end(), (const uint8_t*)r.seq,
                     (const uint8_t*)r.seq + r.seq_len);
      }
      itf8_encode(mq, r.mapq);
      if (r.qual_len > 0) qs.insert(qs.end(), r.qual, r.qual + r.qual_len);
    } else {
      if (r.seq_len > 0)
        ba.insert(ba.end(), (const uint8_t*)r.seq, (const uint8_t*)r.seq + r.seq_len);
      if (r.qual_len > 0) qs.insert(qs.end(), r.qual, r.qual + r.qual_len);
    }
  }

  struct Used {
    int32_t cid;
    const Bytes* data;
  };
  std::vector<Used> used;
  const std::pair<int32_t, const Bytes*> all[] = {
      {S_BF, &bf}, {S_CF, &cf}, {S_RL, &rl_b}, {S_AP, &ap}, {S_MF, &mf},
      {S_NS, &ns}, {S_NP, &np_b}, {S_TS, &ts}, {S_RN, &rn}, {S_FN, &fn},
      {S_FC, &fc}, {S_FP, &fp}, {S_BBLEN, &bblen}, {S_BBVAL, &bbval},
      {S_QS, &qs}, {S_MQ, &mq}, {S_BA, &ba}, {S_RI, &ri}, {S_SC, &sc},
      {S_IN, &in_b}, {S_DL, &dl}, {S_RS, &rs}, {S_PD, &pd}, {S_HC, &hc},
  };
  for (const auto& [cid, data] : all)
    if (!data->empty()) used.push_back({cid, data});

  Bytes body;
  write_block(body, CT_COMPRESSION_HEADER, 0, compression_header(multi_ref), GZIP);
  int64_t landmark = (int64_t)body.size();

  // slice header
  Bytes sh;
  itf8_encode(sh, slice_ref);
  itf8_encode(sh, s_start);
  itf8_encode(sh, s_span);
  itf8_encode(sh, (int64_t)recs.size());
  ltf8_encode(sh, record_counter);
  itf8_encode(sh, 1 + (int64_t)used.size());  // core + externals
  itf8_encode(sh, (int64_t)used.size());
  for (const auto& u : used) itf8_encode(sh, u.cid);
  itf8_encode(sh, -1);  // no embedded reference
  for (int i = 0; i < 16; ++i) sh.push_back(0);  // ref md5 (unverified)
  write_block(body, CT_SLICE_HEADER, 0, sh, RAW);
  write_block(body, CT_CORE, 0, Bytes{}, RAW);
  for (const auto& u : used) write_block(body, CT_EXTERNAL, u.cid, *u.data, GZIP);

  meta->ref_id = slice_ref;
  meta->start = s_start;
  meta->span = s_span;
  meta->landmark = landmark;
  meta->n_records = (int64_t)recs.size();
  meta->n_bases = n_bases;
  meta->n_blocks = 3 + (int64_t)used.size();  // comp hdr + slice hdr + core + ext
  return body;
}

}  // namespace

extern "C" {

// Write a CRAM 3.0 file from packed record columns. Offsets arrays have
// n_records+1 entries. cigar/cigar_off may be NULL (all-match encode);
// when given, cigar holds BAM-packed ops (len<<4 | op) and non-trivial
// CIGARs are preserved as CRAM features (D/N/I/S/H/P).
// Returns 0, or a negative error code.
int grid_cram_write(const char* path, const uint8_t* sam_header,
                    int64_t header_len, int64_t n_records,
                    const int32_t* flag, const int32_t* ref_id,
                    const int64_t* pos, const int32_t* mapq,
                    const int32_t* rl, const int32_t* mate_ref_id,
                    const int64_t* mate_pos, const int32_t* tlen,
                    const uint8_t* names, const int64_t* name_off,
                    const uint8_t* seqs, const int64_t* seq_off,
                    const uint8_t* quals, const int64_t* qual_off,
                    const uint32_t* cigar, const int64_t* cigar_off,
                    int32_t slice_records, const char* crai_path) try {
  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  // magic + version + 20-byte file id
  std::fwrite("CRAM\x03\x00", 1, 6, f);
  char fid[20] = {0};
  const char* base = std::strrchr(path, '/');
  base = base ? base + 1 : path;
  std::memcpy(fid, base, std::min(sizeof(fid), std::strlen(base)));
  std::fwrite(fid, 1, 20, f);

  // SAM header container
  Bytes hdr_data;
  int32_t hl = (int32_t)header_len;
  for (int s = 0; s < 32; s += 8) hdr_data.push_back((uint8_t)((hl >> s) & 0xFF));
  hdr_data.insert(hdr_data.end(), sam_header, sam_header + header_len);
  Bytes hdr_body;
  write_block(hdr_body, CT_FILE_HEADER, 0, hdr_data, RAW);
  Bytes ch = container_header(0, 0, 0, 0, 0, 0, 1, {0}, (int64_t)hdr_body.size());
  std::fwrite(ch.data(), 1, ch.size(), f);
  std::fwrite(hdr_body.data(), 1, hdr_body.size(), f);

  gzFile crai = nullptr;
  if (crai_path && crai_path[0]) {
    crai = gzopen(crai_path, "wb");
    if (!crai) {
      std::fclose(f);
      return -3;
    }
  }

  int64_t counter = 0;
  for (int64_t lo = 0; lo < n_records; lo += slice_records) {
    int64_t hi = std::min<int64_t>(lo + slice_records, n_records);
    std::vector<RecView> recs;
    recs.reserve((size_t)(hi - lo));
    for (int64_t i = lo; i < hi; ++i) {
      RecView r;
      r.flag = flag[i];
      r.ref_id = ref_id[i];
      r.pos = pos[i];
      r.mapq = mapq[i];
      r.rl = rl[i];
      r.mate_ref_id = mate_ref_id[i];
      r.mate_pos = mate_pos[i];
      r.tlen = tlen[i];
      r.name = (const char*)names + name_off[i];
      r.name_len = (int32_t)(name_off[i + 1] - name_off[i]);
      r.seq = (const char*)seqs + seq_off[i];
      r.seq_len = (int32_t)(seq_off[i + 1] - seq_off[i]);
      r.qual = quals + qual_off[i];
      r.qual_len = (int32_t)(qual_off[i + 1] - qual_off[i]);
      if (cigar && cigar_off) {
        r.cig = cigar + cigar_off[i];
        r.n_cig = (int32_t)(cigar_off[i + 1] - cigar_off[i]);
      } else {
        r.cig = nullptr;
        r.n_cig = 0;
      }
      recs.push_back(r);
    }
    SliceMeta meta{};
    Bytes body = encode_slice(recs, counter, &meta);
    Bytes chd = container_header(meta.ref_id, meta.start, meta.span,
                                 meta.n_records, counter, meta.n_bases,
                                 meta.n_blocks, {meta.landmark},
                                 (int64_t)body.size());
    long c_off = std::ftell(f);
    std::fwrite(chd.data(), 1, chd.size(), f);
    std::fwrite(body.data(), 1, body.size(), f);
    counter += meta.n_records;
    if (crai)
      gzprintf(crai, "%lld\t%lld\t%lld\t%lld\t%lld\t%lld\n",
               (long long)meta.ref_id, (long long)meta.start,
               (long long)meta.span, (long long)c_off,
               (long long)meta.landmark,
               (long long)((int64_t)body.size() - meta.landmark));
  }

  // EOF container (spec 9: empty compression-header container @4542278)
  Bytes eof_body;
  write_block(eof_body, CT_COMPRESSION_HEADER, 0,
              Bytes{0x01, 0x00, 0x01, 0x00, 0x01, 0x00}, RAW);
  Bytes ech = container_header(-1, 4542278, 0, 0, 0, 0, 1, {},
                               (int64_t)eof_body.size());
  std::fwrite(ech.data(), 1, ech.size(), f);
  std::fwrite(eof_body.data(), 1, eof_body.size(), f);
  std::fclose(f);
  if (crai) gzclose(crai);
  return 0;
} catch (const std::exception&) {
  return -99;
}

}  // extern "C"
