// PBWT-based IBS haplotype-neighbor search (multithreaded C++ core).
//
// Native replacement for the reference's external computeIBSpbwt dependency
// (ref docs/source/ibs_ibd.rst:14-19 — the tool is not shipped; users must
// build supplementary C++ against Eagle headers + Boost). This core is the
// exact twin of grid_tpu/ops/pbwt.py: same contract, same tie-breaking,
// same threshold-merge search — cross-checked bit-for-bit in
// tests/test_ibs.py. See the Python module docstring for the algorithm.
//
// Only the std library is used; haplotypes are bitpacked internally so
// match-extent computation runs at 64 sites per XOR.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <queue>
#include <thread>
#include <vector>

namespace {

struct Panel {
  const uint8_t* H;  // [n_hap, n_sites] row-major
  int32_t n_hap;
  int32_t n_sites;
  int32_t f;  // focal site index
  std::vector<uint64_t> packed;  // [n_hap, n_words]
  int64_t n_words;

  void pack() {
    n_words = (static_cast<int64_t>(n_sites) + 63) / 64;
    packed.assign(static_cast<size_t>(n_hap) * n_words, 0);
    for (int32_t h = 0; h < n_hap; ++h) {
      const uint8_t* row = H + static_cast<int64_t>(h) * n_sites;
      uint64_t* out = packed.data() + static_cast<int64_t>(h) * n_words;
      for (int32_t j = 0; j < n_sites; ++j) {
        if (row[j]) out[j >> 6] |= (1ULL << (j & 63));
      }
    }
  }

  // Largest b with rows x,y equal on sites [f, f+b).
  int32_t right_extent(int32_t x, int32_t y) const {
    if (f >= n_sites) return 0;
    const uint64_t* px = packed.data() + static_cast<int64_t>(x) * n_words;
    const uint64_t* py = packed.data() + static_cast<int64_t>(y) * n_words;
    int64_t w = f >> 6;
    int off = f & 63;
    uint64_t diff = (px[w] ^ py[w]) >> off;
    int32_t limit = n_sites - f;
    if (diff) return std::min(static_cast<int32_t>(__builtin_ctzll(diff)), limit);
    int32_t ext = 64 - off;
    for (++w; w < n_words; ++w) {
      diff = px[w] ^ py[w];
      if (diff)
        return std::min(ext + static_cast<int32_t>(__builtin_ctzll(diff)), limit);
      ext += 64;
    }
    return limit;
  }

  // Largest a with rows x,y equal on sites [f-a, f).
  int32_t left_extent(int32_t x, int32_t y) const {
    if (f <= 0) return 0;
    const uint64_t* px = packed.data() + static_cast<int64_t>(x) * n_words;
    const uint64_t* py = packed.data() + static_cast<int64_t>(y) * n_words;
    int64_t w = (f - 1) >> 6;
    int off = (f - 1) & 63;
    uint64_t diff = (px[w] ^ py[w]) << (63 - off);
    if (diff) return static_cast<int32_t>(__builtin_clzll(diff));
    int32_t ext = off + 1;
    for (--w; w >= 0; --w) {
      diff = px[w] ^ py[w];
      if (diff) return ext + static_cast<int32_t>(__builtin_clzll(diff));
      ext += 64;
    }
    return f;
  }
};

// Durbin's PBWT over L columns; col(t) maps iteration order to site index
// (identity left of the focal point, reversed right of it). On return a is
// the reversed-prefix order after the last column and d[i] the first
// iteration index s such that a[i], a[i-1] agree on iterations [s, L)
// (d == L: no match; d[0] == L by convention, matching ops/pbwt.py).
void pbwt_build(const Panel& p, int32_t L, bool rev, std::vector<int32_t>& a,
                std::vector<int32_t>& d) {
  const int32_t n = p.n_hap;
  a.resize(n);
  d.assign(n, 0);
  for (int32_t i = 0; i < n; ++i) a[i] = i;
  std::vector<int32_t> a0, a1, d0, d1;
  a0.reserve(n); a1.reserve(n); d0.reserve(n); d1.reserve(n);
  for (int32_t t = 0; t < L; ++t) {
    const int32_t col = rev ? (p.n_sites - 1 - t) : t;
    a0.clear(); a1.clear(); d0.clear(); d1.clear();
    int32_t pp = t + 1, qq = t + 1;
    for (int32_t i = 0; i < n; ++i) {
      pp = std::max(pp, d[i]);
      qq = std::max(qq, d[i]);
      const uint8_t v = p.H[static_cast<int64_t>(a[i]) * p.n_sites + col];
      if (!v) {
        a0.push_back(a[i]);
        d0.push_back(pp);
        pp = 0;
      } else {
        a1.push_back(a[i]);
        d1.push_back(qq);
        qq = 0;
      }
    }
    std::copy(a0.begin(), a0.end(), a.begin());
    std::copy(a1.begin(), a1.end(), a.begin() + a0.size());
    std::copy(d0.begin(), d0.end(), d.begin());
    std::copy(d1.begin(), d1.end(), d.begin() + d0.size());
  }
  if (n) d[0] = L;
}

// Enumerates candidates around one haplotype's position in a PBWT ordering
// in non-increasing one-sided extent, skipping the sample's other
// haplotype. Twin of ops/pbwt.py::_Expander.
struct Expander {
  const std::vector<int32_t>& a;
  const std::vector<int32_t>& d;
  int32_t L;
  int32_t up, dn;
  int32_t s_up = 0, s_dn = 0;
  int32_t mate;
  int32_t n;

  Expander(const std::vector<int32_t>& a_, const std::vector<int32_t>& d_,
           const std::vector<int32_t>& inv, int32_t h, int32_t L_)
      : a(a_), d(d_), L(L_), up(inv[h]), dn(inv[h]), mate(h ^ 1),
        n(static_cast<int32_t>(a_.size())) {}

  // Returns false when exhausted; else sets (cand, ext).
  bool next(int32_t* cand, int32_t* ext) {
    for (;;) {
      const bool can_up = up > 0;
      const bool can_dn = dn < n - 1;
      if (!can_up && !can_dn) return false;
      const int32_t su = can_up ? std::max(s_up, d[up]) : L;
      const int32_t sd = can_dn ? std::max(s_dn, d[dn + 1]) : L;
      int32_t c;
      if (can_up && (!can_dn || su <= sd)) {
        s_up = su;
        --up;
        c = a[up];
        *ext = L - su;
      } else {
        s_dn = sd;
        ++dn;
        c = a[dn];
        *ext = L - sd;
      }
      if (c != mate) {
        *cand = c;
        return true;
      }
    }
  }
};

struct Cand {
  int32_t y;
  int32_t a, b;  // site extents
  double lcm, rcm;
};

struct Shared {
  const Panel* panel;
  const double* cm;
  double focal_cm;
  int32_t k, max_scan;
  const std::vector<int32_t>*aL, *dL, *invL, *aR, *dR, *invR;
  int32_t* out_idx;
  double* out_len;
  double* out_edge;
  int32_t* out_count;
};

void run_range(const Shared& S, int32_t h_begin, int32_t h_end) {
  const Panel& P = *S.panel;
  const int32_t f = P.f, M = P.n_sites, n = P.n_hap;
  const int32_t Lf = f, Rf = M - f;
  auto left_cm = [&](int32_t a) {
    return a > 0 ? S.focal_cm - S.cm[f - a] : 0.0;
  };
  auto right_cm = [&](int32_t b) {
    return b > 0 ? S.cm[f + b - 1] - S.focal_cm : 0.0;
  };

  std::vector<int32_t> stamp(n, -1);
  std::vector<Cand> cands;
  cands.reserve(2 * S.max_scan + 8);

  for (int32_t h = h_begin; h < h_end; ++h) {
    Expander gl(*S.aL, *S.dL, *S.invL, h, Lf);
    Expander gr(*S.aR, *S.dR, *S.invR, h, Rf);
    cands.clear();
    // Min-heap of the k largest totals found so far (bound check only).
    std::priority_queue<double, std::vector<double>, std::greater<double>> heap;
    double bound_l = 1e300, bound_r = 1e300;
    int32_t popped_l = 0, popped_r = 0;
    bool exhausted = false;

    auto admit = [&](int32_t y) {
      if (stamp[y] == h) return;
      stamp[y] = h;
      Cand c;
      c.y = y;
      c.a = P.left_extent(h, y);
      c.b = P.right_extent(h, y);
      c.lcm = left_cm(c.a);
      c.rcm = right_cm(c.b);
      cands.push_back(c);
      const double total = c.lcm + c.rcm;
      if (static_cast<int32_t>(heap.size()) < S.k) {
        heap.push(total);
      } else if (total > heap.top()) {
        heap.pop();
        heap.push(total);
      }
    };

    for (;;) {
      bool progressed = false;
      int32_t y, ext;
      if (popped_l < S.max_scan) {
        if (!gl.next(&y, &ext)) {
          exhausted = true;
        } else {
          ++popped_l;
          progressed = true;
          bound_l = left_cm(ext);
          admit(y);
        }
      }
      if (popped_r < S.max_scan) {
        if (!gr.next(&y, &ext)) {
          exhausted = true;
        } else {
          ++popped_r;
          progressed = true;
          bound_r = right_cm(ext);
          admit(y);
        }
      }
      if (exhausted || !progressed) break;
      if (static_cast<int32_t>(heap.size()) >= S.k &&
          heap.top() > bound_l + bound_r)
        break;
    }

    std::sort(cands.begin(), cands.end(), [](const Cand& x, const Cand& z) {
      const double tx = x.lcm + x.rcm, tz = z.lcm + z.rcm;
      if (tx != tz) return tx > tz;
      const int32_t sx = x.a + x.b, sz = z.a + z.b;
      if (sx != sz) return sx > sz;
      const int32_t mx = std::min(x.a, x.b), mz = std::min(z.a, z.b);
      if (mx != mz) return mx > mz;
      return x.y < z.y;
    });
    const int32_t cnt =
        std::min<int32_t>(S.k, static_cast<int32_t>(cands.size()));
    S.out_count[h] = cnt;
    int32_t* idx_row = S.out_idx + static_cast<int64_t>(h) * S.k;
    double* len_row = S.out_len + static_cast<int64_t>(h) * S.k;
    double* edge_row = S.out_edge + static_cast<int64_t>(h) * S.k;
    for (int32_t r = 0; r < S.k; ++r) {
      if (r < cnt) {
        idx_row[r] = cands[r].y;
        len_row[r] = cands[r].lcm + cands[r].rcm;
        edge_row[r] = std::min(cands[r].lcm, cands[r].rcm);
      } else {
        idx_row[r] = -1;
        len_row[r] = 0.0;
        edge_row[r] = 0.0;
      }
    }
  }
}

}  // namespace

extern "C" int grid_ibs_neighbors(
    const uint8_t* haps, int32_t n_hap, int32_t n_sites, const double* cm,
    int32_t focal, double focal_cm, int32_t k, int32_t max_scan,
    int32_t n_threads, int32_t* out_idx, double* out_len, double* out_edge,
    int32_t* out_count) {
  if (!haps || !cm || !out_idx || !out_len || !out_edge || !out_count)
    return -1;
  if (n_hap < 0 || n_sites < 0 || focal < 0 || focal > n_sites || k <= 0 ||
      max_scan <= 0)
    return -2;

  Panel panel{haps, n_hap, n_sites, focal, {}, 0};
  panel.pack();

  std::vector<int32_t> aL, dL, aR, dR;
  pbwt_build(panel, focal, /*rev=*/false, aL, dL);
  pbwt_build(panel, n_sites - focal, /*rev=*/true, aR, dR);
  std::vector<int32_t> invL(n_hap), invR(n_hap);
  for (int32_t i = 0; i < n_hap; ++i) {
    invL[aL[i]] = i;
    invR[aR[i]] = i;
  }

  Shared S{&panel, cm,  focal_cm, k,       max_scan, &aL,
           &dL,    &invL, &aR,      &dR,     &invR,    out_idx,
           out_len, out_edge, out_count};

  const int32_t nt = std::max(1, std::min(n_threads, n_hap > 0 ? n_hap : 1));
  if (nt == 1 || n_hap < 2 * nt) {
    run_range(S, 0, n_hap);
  } else {
    std::vector<std::thread> threads;
    const int32_t chunk = (n_hap + nt - 1) / nt;
    for (int32_t t = 0; t < nt; ++t) {
      const int32_t lo = t * chunk;
      const int32_t hi = std::min(n_hap, lo + chunk);
      if (lo >= hi) break;
      threads.emplace_back([&S, lo, hi] { run_range(S, lo, hi); });
    }
    for (auto& th : threads) th.join();
  }
  return 0;
}
