// Batched fused ingest: the whole cohort fan-out in ONE native call.
//
// Round-3 measurement (docs/perf.md): the per-sample Python dispatch around
// grid_*_ingest_multi costs ~8 ms/sample serialized on the GIL — ~30% of
// steps 1-3 wall-clock at N=2504 on 2 cores (the reference's ThreadPool
// shape, grid/utils/count_reads.py:62-77, has the same structure but pays
// it per *pass*; we pay it once per sample-call).  This driver moves the
// fan-out below the GIL: worker threads pull files off an atomic cursor and
// run the existing single-file ingest cores (grid_bam_ingest_multi /
// grid_cram_ingest_multi — both thread-safe: no mutable statics, per-thread
// libdeflate decompressors, per-instance writers), with per-file -5
// grow-and-retry handled here so the caller never resizes.
//
// Outputs land in caller-owned flat arrays (file i owns slot i and the
// bins region [i*cap_per, (i+1)*cap_per)); status[i] carries the per-file
// rc so one bad sample never poisons the batch — the Python side re-runs
// failed files through its sequential fallback chain, matching the
// per-sample failure semantics of steps/ingest.py.

#include <atomic>
#include <chrono>
#include <ctime>
#include <cstdint>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

extern "C" {

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

// paths/beds: NUL-separated buffers with n_files entries each (an empty bed
// entry skips the bed.gz artifact for that file).  is_cram[i] picks the
// decoder.  cap_per is the per-file staged-bin capacity (0: discard bins —
// the bounded-memory streaming-stager mode).  progress, when non-null, is
// atomically incremented once per finished file (any status) so the caller
// can poll a live progress bar without a callback trampoline.
// thread_busy_s / thread_cpu_s, when non-null, receive per-worker seconds
// (length >= the thread count actually used, itself written to
// *n_threads_used): busy = wall time spent INSIDE the decode cores, cpu =
// CLOCK_THREAD_CPUTIME_ID over the worker's life.  Together they are the
// GIL-free-scaling evidence: sum(cpu)/wall is the PHYSICAL parallelism
// achieved (capped by the host's cores), while busy >> cpu means workers
// sat timesliced or in IO, not serialized by dispatch.
// Returns 0 (per-file outcomes are in status[]), or -1 on bad arguments.
int grid_ingest_batch(const char* paths, const char* beds,
                      const int32_t* is_cram, int32_t n_files,
                      int32_t n_threads, int32_t bin_size,
                      int32_t exclude_flags, int32_t bin_min_mapq,
                      int32_t skip_zero, const char* chrom, int64_t wstart,
                      int64_t wend, const int32_t* flags, int32_t n_flags,
                      int32_t count_min_mapq, const char* stage_chrom_prefix,
                      const char* win_chroms, const int64_t* win_starts,
                      const int64_t* win_ends, int32_t n_windows,
                      int64_t* out_counts, int64_t* out_cov100,
                      int64_t* win_counts, int32_t* status,
                      int32_t* bins_refid, int64_t* bins_start,
                      int64_t* bins_end, double* bins_depth, int64_t cap_per,
                      int64_t* out_nbins, int64_t* progress,
                      double* thread_busy_s, double* thread_cpu_s,
                      int32_t* n_threads_used) {
  if (n_files <= 0 || !paths || !beds || !is_cram || !status) return -1;

  std::vector<const char*> path_v(n_files), bed_v(n_files);
  {
    const char* p = paths;
    const char* b = beds;
    for (int32_t i = 0; i < n_files; ++i) {
      path_v[i] = p;
      p += strlen(p) + 1;
      bed_v[i] = b;
      b += strlen(b) + 1;
    }
  }

  int nt = n_threads > 0 ? n_threads
                         : (int)std::thread::hardware_concurrency();
  if (nt < 1) nt = 1;
  if (nt > n_files) nt = n_files;

  std::atomic<int32_t> cursor{0};
  std::atomic<int64_t>* prog =
      progress ? reinterpret_cast<std::atomic<int64_t>*>(progress) : nullptr;

  // Estimated bins in the analysis window; the exact staged count is data-
  // dependent (alternate chromosome-name matches can double it), so workers
  // grow-and-retry on -5 using the exact nbins the core reports.
  int64_t est = 4 * ((wend - wstart) / (bin_size > 0 ? bin_size : 1000) + 2) +
                1024;
  // A reversed window (wend < wstart) must not turn into a negative vector
  // size — the ctor would throw inside a worker thread and std::terminate
  // the process; the per-file cores report the misconfig as a status code.
  if (est < 1024) est = 1024;

  auto thread_cpu_now = []() {
    struct timespec ts;
    if (clock_gettime(CLOCK_THREAD_CPUTIME_ID, &ts) != 0) return -1.0;
    return (double)ts.tv_sec + (double)ts.tv_nsec * 1e-9;
  };

  auto worker = [&](int32_t tid) {
    // delta, not absolute: with nt==1 the worker runs on the CALLING
    // thread, whose CPU clock includes the process's prior work
    double cpu0 = thread_cpu_now();
    std::vector<int32_t> refid(est);
    std::vector<int64_t> bstart(est), bend(est);
    std::vector<double> bdepth(est);
    double busy = 0.0;
    for (;;) {
      int32_t i = cursor.fetch_add(1);
      if (i >= n_files) break;
      auto fn = is_cram[i] ? grid_cram_ingest_multi : grid_bam_ingest_multi;
      int64_t count = 0, cov100 = 0, nbins = 0;
      int rc;
      auto t0 = std::chrono::steady_clock::now();
      for (int attempt = 0; attempt < 3; ++attempt) {
        rc = fn(path_v[i], bed_v[i], bin_size, exclude_flags, bin_min_mapq,
                skip_zero, chrom, wstart, wend, flags, n_flags,
                count_min_mapq, stage_chrom_prefix, &count, &cov100,
                refid.data(), bstart.data(), bend.data(), bdepth.data(),
                (int64_t)refid.size(), &nbins, win_chroms, win_starts,
                win_ends, n_windows,
                win_counts ? win_counts + (int64_t)i * n_windows : nullptr);
        if (rc != -5) break;
        size_t need = (size_t)nbins + 64;
        refid.resize(need);
        bstart.resize(need);
        bend.resize(need);
        bdepth.resize(need);
      }
      busy += std::chrono::duration<double>(std::chrono::steady_clock::now() -
                                            t0)
                  .count();
      status[i] = rc;
      if (rc == 0) {
        if (out_counts) out_counts[i] = count;
        if (out_cov100) out_cov100[i] = cov100;
        if (out_nbins) out_nbins[i] = nbins;
        if (cap_per > 0) {
          if (nbins > cap_per) {
            status[i] = -5;  // caller's per-file region too small
          } else {
            int64_t off = (int64_t)i * cap_per;
            memcpy(bins_refid + off, refid.data(), nbins * sizeof(int32_t));
            memcpy(bins_start + off, bstart.data(), nbins * sizeof(int64_t));
            memcpy(bins_end + off, bend.data(), nbins * sizeof(int64_t));
            memcpy(bins_depth + off, bdepth.data(), nbins * sizeof(double));
          }
        }
      } else if (out_nbins) {
        out_nbins[i] = 0;
      }
      if (prog) prog->fetch_add(1);
    }
    if (thread_busy_s) thread_busy_s[tid] = busy;
    if (thread_cpu_s) {
      double cpu1 = thread_cpu_now();
      thread_cpu_s[tid] = (cpu0 >= 0 && cpu1 >= 0) ? cpu1 - cpu0 : -1.0;
    }
  };

  if (n_threads_used) *n_threads_used = nt;
  if (nt == 1) {
    worker(0);
  } else {
    std::vector<std::thread> ts;
    ts.reserve(nt);
    for (int t = 0; t < nt; ++t) ts.emplace_back(worker, t);
    for (auto& t : ts) t.join();
  }
  return 0;
}

}  // extern "C"
