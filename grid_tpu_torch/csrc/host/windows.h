// Multi-window read counting for the fused one-pass ingest.
//
// The multi-locus sweep needs the step-2 read count for MANY VNTR windows
// (e.g. all 734 catalog loci) — the reference's shape would be one indexed
// fetch per sample per locus (grid/utils/count_reads.py:82-107 under the
// per-locus loop), i.e. O(samples x loci) decompression passes. Here every
// extra window is a byproduct of the SAME genome scan the fused ingest
// already performs: the per-record filter (flag set, mapq, mate on same
// ref, not dup/secondary — window-independent) runs once, and the record's
// (tid, pos) is binned into every window containing it.
//
// Windows are grouped per tid and sorted by start; a record probes its
// tid's list with an early break once window starts exceed pos, so the
// per-record cost is O(overlapping windows), ~O(1) for real VNTR catalogs.
#pragma once

#include <algorithm>
#include <cstdint>
#include <string>
#include <vector>

namespace gridtpu {

struct WindowCounter {
  struct Span {
    int64_t start, end;
    int32_t widx;
  };
  // spans grouped by tid, sorted by start (finalize())
  std::vector<std::vector<Span>> by_tid;
  std::vector<int64_t> counts;  // one slot per window; pre-set by caller

  explicit WindowCounter(size_t n_refs, size_t n_windows)
      : by_tid(n_refs), counts(n_windows, 0) {}

  void add(int32_t tid, int64_t start, int64_t end, int32_t widx) {
    if (tid >= 0 && tid < (int32_t)by_tid.size())
      by_tid[tid].push_back({start, end, widx});
  }

  void finalize() {
    for (auto& v : by_tid)
      std::sort(v.begin(), v.end(),
                [](const Span& a, const Span& b) { return a.start < b.start; });
  }

  // Record at (tid, pos) passed the window-independent filter: count it in
  // every window with start <= pos < end.
  inline void hit(int32_t tid, int64_t pos) {
    if (tid < 0 || tid >= (int32_t)by_tid.size()) return;
    for (const Span& s : by_tid[tid]) {
      if (s.start > pos) break;  // sorted by start: no later span contains pos
      if (pos < s.end) ++counts[s.widx];
    }
  }

  bool empty() const {
    for (const auto& v : by_tid)
      if (!v.empty()) return false;
    return true;
  }
};

// Split a NUL-separated name buffer into n entries.
inline std::vector<std::string> split_names(const char* buf, int32_t n) {
  std::vector<std::string> out;
  out.reserve(n);
  const char* p = buf;
  for (int32_t i = 0; i < n; ++i) {
    out.emplace_back(p);
    p += out.back().size() + 1;
  }
  return out;
}

}  // namespace gridtpu
