// Native writer for the step-5 neighbors artifact (.tsv.gz).
//
// The Python writer (io/formats.py write_neighbors_dense) vectorizes the
// %.2f formatting with np.char.mod but still spends ~2 s formatting +
// joining 2504 x 1502 object cells, ~2.6 s of the 17.8 s e2e pipeline
// (docs/perf.md r4-final). This C path reuses the bedwrite machinery:
// the %.2f-identical integer cents formatter (fuzz-pinned, snprintf
// guard band for exact-tie neighborhoods; plain snprintf for negatives)
// and the BGZF/libdeflate block writer (every gzip consumer reads BGZF;
// GRID_TPU_BED_FORMAT=gzip selects the legacy single-member stream).
//
// Line format (grid/utils/find_neighbors.py:231-267):
//   ID \t scale \t (nbrID \t nbrScale \t dist) * k \n

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#include "bedwrite.h"

namespace {

// printf-identical "%.{2,3}f" via the bedwrite integer strategy: round the
// magnitude in fixed units with llrint (round-half-even, printf's decimal
// tie rule), defer to snprintf inside the guard band around exact ties and
// for huge values. Sign handled like printf: "-0.00" for tiny negatives
// and for IEEE -0.0 (Python's %-format prints those too).
inline void append_fixed(std::string& out, double v, int dec, char* buf) {
  if (std::isnan(v)) {
    out.append("nan", 3);  // Python %-format: always unsigned "nan"
    return;
  }
  if (std::isinf(v)) {
    if (v < 0) out.push_back('-');
    out.append("inf", 3);
    return;
  }
  double av = v < 0 ? -v : v;
  double mult = dec == 2 ? 100.0 : 1000.0;
  double scaled = av * mult;
  long long k = llrint(scaled);
  double d = scaled - (double)k;
  // 1e12: far below where ulp(av*mult) approaches the 1e-7 guard band
  // (printf divergence is reachable from ~1.7e13 for %.3f) and far above
  // any value this pipeline formats — huge values take the printf path.
  if (av >= 1e12 || d > 0.4999999 || d < -0.4999999) {
    int m = snprintf(buf, 80, "%.*f", dec, v);
    out.append(buf, (size_t)(m > 0 ? m : 0));
    return;
  }
  if (v < 0 || (v == 0.0 && std::signbit(v))) out.push_back('-');
  long long unit = dec == 2 ? 100 : 1000;
  char* q = gridtpu::bed_u64toa((unsigned long long)(k / unit), buf);
  *q++ = '.';
  if (dec == 3) *q++ = (char)('0' + (char)((k / 100) % 10));
  *q++ = (char)('0' + (char)((k / 10) % 10));
  *q++ = (char)('0' + (char)(k % 10));
  out.append(buf, (size_t)(q - buf));
}

inline void append_f2(std::string& out, double v, char* buf) {
  append_fixed(out, v, 2, buf);
}

}  // namespace

extern "C" {

// ids: NUL-separated buffer of n sample IDs (row order).
// scales: [n]; nbr_idx: [n*k] row indices into ids; dists: [n*k].
// Returns 0, -1 on open failure, -2 on write/close failure, -3 on a
// neighbor index out of range.
int grid_write_neighbors(const char* path, const char* ids, int64_t n,
                         int64_t k, const double* scales,
                         const int64_t* nbr_idx, const double* dists) {
  std::vector<const char*> idp((size_t)n);
  std::vector<size_t> idlen((size_t)n);
  const char* p = ids;
  for (int64_t i = 0; i < n; ++i) {
    idp[i] = p;
    idlen[i] = strlen(p);
    p += idlen[i] + 1;
  }

  // per-sample scale string, formatted once (each appears k-ish times)
  std::vector<std::string> sstr((size_t)n);
  char buf[80];
  for (int64_t i = 0; i < n; ++i) append_f2(sstr[i], scales[i], buf);

  gridtpu::BedWriter w;
  if (!w.open(path)) return -1;
  for (int64_t i = 0; i < n; ++i) {
    w.chunk.append(idp[i], idlen[i]);
    w.chunk.push_back('\t');
    w.chunk.append(sstr[i]);
    const int64_t* row_idx = nbr_idx + i * k;
    const double* row_d = dists + i * k;
    for (int64_t j = 0; j < k; ++j) {
      int64_t t = row_idx[j];
      if (t < 0 || t >= n) {
        w.close();
        return -3;
      }
      w.chunk.push_back('\t');
      w.chunk.append(idp[t], idlen[t]);
      w.chunk.push_back('\t');
      w.chunk.append(sstr[t]);
      w.chunk.push_back('\t');
      append_f2(w.chunk, row_d[j], buf);
      if (w.chunk.size() > 0xf000) w.flush();
    }
    w.chunk.push_back('\n');
    if (w.chunk.size() > 0xf000) w.flush();
  }
  return w.close() ? 0 : -2;
}

// Step-4 artifact (io/formats.py write_normalized_output; ref format
// grid/utils/normalize_mosdepth.py:502-554):
//   line 0: N \t Rwant \t mu_j...       (%.3f, "NA" where NaN)
//   line 1: N \t Rwant \t ratio_j...    (%.3f, "NA" where NaN)
//   rows  : ID \t scale(%.2f) \t z_ij...(%.2f, "NA" where ~mask)
// z/mask are [n*r] row-major over the ALREADY column-selected matrix.
int grid_write_normalized(const char* path, const char* ids, int64_t n,
                          int64_t r, const double* scales, const double* z,
                          const uint8_t* mask, const double* means,
                          const double* ratios) {
  std::vector<const char*> idp((size_t)n);
  std::vector<size_t> idlen((size_t)n);
  const char* p = ids;
  for (int64_t i = 0; i < n; ++i) {
    idp[i] = p;
    idlen[i] = strlen(p);
    p += idlen[i] + 1;
  }

  gridtpu::BedWriter w;
  if (!w.open(path)) return -1;
  char buf[96];

  // The Python writer's prefix f-strings end in '\t' and the values are
  // '\t'.joined after it — so the separator goes BEFORE each value except
  // the first, and an r=0 line still carries the trailing prefix tab.
  auto header = [&](const double* vals) {
    char* q = gridtpu::bed_u64toa((unsigned long long)n, buf);
    *q++ = '\t';
    q = gridtpu::bed_u64toa((unsigned long long)r, q);
    *q++ = '\t';
    w.chunk.append(buf, (size_t)(q - buf));
    for (int64_t j = 0; j < r; ++j) {
      if (j) w.chunk.push_back('\t');
      if (std::isnan(vals[j])) {
        w.chunk.append("NA", 2);
      } else {
        append_fixed(w.chunk, vals[j], 3, buf);
      }
      if (w.chunk.size() > 0xf000) w.flush();
    }
    w.chunk.push_back('\n');
  };
  header(means);
  header(ratios);

  for (int64_t i = 0; i < n; ++i) {
    w.chunk.append(idp[i], idlen[i]);
    w.chunk.push_back('\t');
    append_fixed(w.chunk, scales[i], 2, buf);
    w.chunk.push_back('\t');
    const double* zr = z + i * r;
    const uint8_t* mr = mask + i * r;
    for (int64_t j = 0; j < r; ++j) {
      if (j) w.chunk.push_back('\t');
      if (mr[j]) {
        append_fixed(w.chunk, zr[j], 2, buf);
      } else {
        w.chunk.append("NA", 2);
      }
      if (w.chunk.size() > 0xf000) w.flush();
    }
    w.chunk.push_back('\n');
    if (w.chunk.size() > 0xf000) w.flush();
  }
  return w.close() ? 0 : -2;
}

}  // extern "C"
