// The Jacobi phasing sweeps: n_iters sweeps over the haplotype values of
// Bt replicates at once. In each sweep every sample i with haplotype rows
// h0 = 2i and h1 = 2i + 1 takes, per haplotype, the weighted mean of its
// neighbors' current values, m_h = sum(w * val) / (1e-9 + sum(w)) over the
// valid slots whose value is not NaN, summed in slot order; then
// new_h = irr_i * m_h / (m_0 + m_1), and the old value stays where the
// denominator is <= 0 or the old value is NaN. Every replicate reads the
// values of the previous sweep only (Jacobi). float32 throughout, with no
// fused multiply-add, so the arithmetic is exactly the one the CPU tests
// emulate; its plain version is grid_tpu_torch/ops/phasing.py:phase_sweeps
// (the same sums in torch's reduction order).
//
// Replaces the lax.scan of grid_tpu/ops/phasing.py:94 (phase_haplotypes,
// lines 59-98), which the JAX package also runs vmapped over the bootstrap
// replicates (lines 189-227); no pallas_call.
//
// Bound on the H100: the bytes the function must move are its inputs read
// once and its output written once: the starting values and irrs, each
// replicate's lists (index and weight, 8 bytes a slot) and the shared
// validity bytes, and [Bt, 2N] values out: about 0.1 MB at N=2504, K=2,
// 0.03 us at 3.35 TB/s; its operations (3 a slot and sweep) take less at
// the float32 peak. That bound is not what holds this function: each
// sweep needs all of the previous one, so n_iters rounds of dependent
// gathers follow each other, and each round ends in a barrier across
// every block that holds part of a replicate (or in a kernel boundary).
// The time per sweep, against the cost of one barrier or one launch, is
// what the design works on.
//
// What the design does about it: the plain version makes ~22 small
// launches per sweep (~2,200 for a step), which made the N=2504 step
// launch-bound. Here:
//
// - resident: a cluster of 8 blocks per replicate, on 8 SMs, runs all
//   n_iters sweeps in one launch. Every block holds the whole value vector
//   double-buffered (2 * 2N * 4 bytes) and the lists of its eighth of the
//   samples (2 * ceil(N / 8) * K * 9 bytes) in shared memory: 96 KB at
//   N=2504, K=10. A sweep reads only shared memory: each block updates its
//   samples, stores their new values into all 8 blocks' next buffers
//   (distributed shared memory), then the cluster barrier. One block alone
//   would hold the lists only up to K=4 at N=2504 and run every sweep on
//   one SM (4.3 us a sweep at K=2, slower than a launch a sweep); spread
//   over 8 SMs a sweep is an eighth of the gathers and one cluster barrier.
//   phase_sweeps_mode takes it where a block's share fits
//   (16 N + 18 ceil(N / 8) K bytes) and a cluster can be scheduled.
// - per sweep: beyond that (N past ~6,000 at K=10, ~11,000 at K=2), one
//   launch per sweep over ping-pong buffers in device memory, a grid row
//   per replicate: n_iters launches instead of ~22 * n_iters, each spread
//   over the card.
//
// A thread takes one sample, both haplotypes' lists walked together slot by
// slot without branches, so their loads are in flight together. The lists
// arrive slot-major, idx and w [Bt or 1, K, 2N] and valid [K, 2N] (the
// wrapper transposes the callers' [2N, K]), so a warp's loads of one slot
// cover 64 neighbouring entries.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kClusterBlocks = 8;  // the portable cluster size
constexpr int kMaxThreads = 1024;
constexpr int kSweepThreads = 256;

// Sample i's new values from `cur`: idx, w and valid hold its lists as
// slot-major rows of `stride` entries, the sample's h0 at entry `row`. A
// slot that does not count leaves the sums as they are, exactly what
// skipping it does; every index lies in [0, 2N) (the wrapper checks), so
// the padded slots read in bounds. A sample whose two values are NaN
// (never phased) walks no list: its values can only stay.
__device__ __forceinline__ float2 sample_update(const float* cur, int i, const float* irrs,
                                                const int* idx, const float* w,
                                                const uint8_t* valid, size_t stride, size_t row,
                                                int k) {
  const float o0 = cur[2 * i], o1 = cur[2 * i + 1];
  if (isnan(o0) && isnan(o1)) return make_float2(o0, o1);
  float wsum0 = 0.f, wval0 = 0.f, wsum1 = 0.f, wval1 = 0.f;
#pragma unroll 4
  for (int s = 0; s < k; ++s) {
    const size_t o = s * stride + row;
    const float w0 = w[o], w1 = w[o + 1];
    const float v0 = cur[idx[o]], v1 = cur[idx[o + 1]];
    const bool t0 = valid[o] && !isnan(v0), t1 = valid[o + 1] && !isnan(v1);
    wsum0 = t0 ? __fadd_rn(wsum0, w0) : wsum0;
    wval0 = t0 ? __fadd_rn(wval0, __fmul_rn(w0, v0)) : wval0;
    wsum1 = t1 ? __fadd_rn(wsum1, w1) : wsum1;
    wval1 = t1 ? __fadd_rn(wval1, __fmul_rn(w1, v1)) : wval1;
  }
  // the reference's 1e-9 floor keeps an empty set's mean at 0
  const float m0 = __fdiv_rn(wval0, __fadd_rn(1e-9f, wsum0));
  const float m1 = __fdiv_rn(wval1, __fadd_rn(1e-9f, wsum1));
  const float denom = __fadd_rn(m0, m1);
  const float irr = irrs[i];
  const bool hold = denom <= 0.f;
  return make_float2(hold || isnan(o0) ? o0 : __fdiv_rn(__fmul_rn(irr, m0), denom),
                     hold || isnan(o1) ? o1 : __fdiv_rn(__fmul_rn(irr, m1), denom));
}

// All sweeps of replicate blockIdx.x / 8 in one cluster of 8 blocks: block
// r of the cluster updates samples [r * chunk, (r + 1) * chunk) and keeps
// their lists, copied in first ([K, 2 * chunk] slot-major), beside its
// copy of the whole value vector. init [2N] is every replicate's starting
// vector; idx and w advance by `lists` elements a replicate (0: one set of
// lists for all); out [Bt, 2N].
__global__ void __launch_bounds__(kMaxThreads)
phase_resident_kernel(const float* __restrict__ init, const float* __restrict__ irrs,
                      const int* __restrict__ idx, const float* __restrict__ w,
                      const uint8_t* __restrict__ valid, int n, int k, size_t lists, int n_iters,
                      int chunk, float* __restrict__ out) {
  extern __shared__ float buf[];  // [2][2N], then idx, w [K * 2 chunk] and valid [K * 2 chunk]
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int two_n = 2 * n, rows = 2 * chunk;
  const int lo = min(n, rank * chunk), hi = min(n, lo + chunk), mine = 2 * (hi - lo);
  const size_t rep = blockIdx.x / kClusterBlocks;
  int* s_idx = reinterpret_cast<int*>(buf + 2 * two_n);
  float* s_w = reinterpret_cast<float*>(s_idx + rows * k);
  uint8_t* s_valid = reinterpret_cast<uint8_t*>(s_w + rows * k);
  for (int h = threadIdx.x; h < two_n; h += blockDim.x) buf[h] = init[h];
  for (int j = threadIdx.x; j < mine * k; j += blockDim.x) {
    const int s = j / mine, r = j - s * mine;
    const size_t src = static_cast<size_t>(s) * two_n + 2 * lo + r;
    s_idx[s * rows + r] = idx[rep * lists + src];
    s_w[s * rows + r] = w[rep * lists + src];
    s_valid[s * rows + r] = valid[src];
  }
  // every block of the cluster has started (and filled its buffer) before
  // any block stores into another's shared memory
  cluster.sync();
  for (int s = 0; s < n_iters; ++s) {
    const float* cur = buf + (s & 1) * two_n;
    float2* nxt = reinterpret_cast<float2*>(buf + ((s + 1) & 1) * two_n);
    for (int i = lo + threadIdx.x; i < hi; i += blockDim.x) {
      const float2 v = sample_update(cur, i, irrs, s_idx, s_w, s_valid, rows, 2 * (i - lo), k);
#pragma unroll
      for (int c = 0; c < kClusterBlocks; ++c) cluster.map_shared_rank(nxt, c)[i] = v;
    }
    // every store of this sweep lands before any block reads the buffer in
    // the next; nobody writes a buffer while it is read (Jacobi ping-pong)
    cluster.sync();
  }
  const float* last = buf + (n_iters & 1) * two_n;
  for (int h = 2 * lo + threadIdx.x; h < 2 * hi; h += blockDim.x) out[rep * two_n + h] = last[h];
}

// One sweep: cur [Bt, 2N] (advancing by `cur_rep` a replicate: 0 for the
// shared starting vector) into nxt [Bt, 2N]; a thread per sample, a grid
// row per replicate.
__global__ void __launch_bounds__(kSweepThreads)
phase_sweep_kernel(const float* __restrict__ cur, size_t cur_rep, const float* __restrict__ irrs,
                   const int* __restrict__ idx, const float* __restrict__ w,
                   const uint8_t* __restrict__ valid, int n, int k, size_t lists,
                   float* __restrict__ nxt) {
  const int i = blockIdx.x * kSweepThreads + threadIdx.x;
  if (i >= n) return;
  const size_t rep = blockIdx.y;
  reinterpret_cast<float2*>(nxt + rep * 2 * static_cast<size_t>(n))[i] =
      sample_update(cur + rep * cur_rep, i, irrs, idx + rep * lists, w + rep * lists, valid,
                    2 * static_cast<size_t>(n), 2 * static_cast<size_t>(i), k);
}

int resident_chunk(int n) { return (n + kClusterBlocks - 1) / kClusterBlocks; }

int resident_threads(int n) {
  return min(kMaxThreads, max(32, (resident_chunk(n) + 31) / 32 * 32));
}

// Dynamic shared memory of one resident block: the two value buffers and
// its share of the lists (int32 index, float32 weight, one validity byte
// a slot).
size_t resident_smem_bytes(int n, int k) {
  return static_cast<size_t>(16) * n + static_cast<size_t>(18) * resident_chunk(n) * k;
}

cudaError_t configure_resident(size_t smem) {
  static bool carveout_set = false;
  if (!carveout_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        phase_resident_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
        cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    carveout_set = true;
  }
  if (smem > 48 * 1024) {
    return cudaFuncSetAttribute(phase_resident_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(smem));
  }
  return cudaSuccess;
}

// The resident launch of `reps` replicates: a cluster of 8 blocks each.
cudaLaunchConfig_t resident_config(int n, int k, int reps, cudaStream_t s,
                                   cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(reps) * kClusterBlocks);
  cfg.blockDim = dim3(resident_threads(n));
  cfg.dynamicSmemBytes = resident_smem_bytes(n, k);
  cfg.stream = s;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kClusterBlocks;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Clusters of the resident mode the card can hold at once (0: none fits).
cudaError_t resident_clusters(int n, int k, int* clusters) {
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = resident_config(n, k, 1, nullptr, &attr);
  const cudaError_t err = configure_resident(cfg.dynamicSmemBytes);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveClusters(clusters, phase_resident_kernel, &cfg);
}

}  // namespace

extern "C" {

// The mode that takes N samples with K slots a list on `device`: 0
// (resident: a cluster of 8 blocks a replicate, each holding the value
// buffers and its share of the lists in shared memory) where that fits and
// can be scheduled, else 1 (one launch per sweep). Returns the first
// cudaError_t.
int phase_sweeps_mode(int device, int n, int k, int* mode) {
  int optin = 0;
  cudaError_t err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  if ((err = cudaFuncGetAttributes(&attr, phase_resident_kernel)) != cudaSuccess) return err;
  *mode = 1;
  if (n > 0 && k > 0 &&
      resident_smem_bytes(n, k) + attr.sharedSizeBytes <= static_cast<size_t>(optin)) {
    int clusters = 0;
    if ((err = resident_clusters(n, k, &clusters)) != cudaSuccess) return err;
    if (clusters > 0) *mode = 0;
  }
  return cudaSuccess;
}

// Launch shape of `mode` at N samples and K slots: threads a block,
// dynamic shared memory a block, resident blocks per SM, registers a
// thread, local (spill) bytes a thread, blocks a cluster and clusters the
// card holds at once (0 in mode 1). Returns the first cudaError_t.
int phase_sweeps_info(int mode, int n, int k, int* out) {
  if (n <= 0 || k < 1 || (mode != 0 && mode != 1)) return cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  cudaError_t err;
  int blocks = 0, clusters = 0;
  size_t smem = 0;
  int threads;
  if (mode == 0) {
    smem = resident_smem_bytes(n, k);
    threads = resident_threads(n);
    if ((err = resident_clusters(n, k, &clusters)) != cudaSuccess) return err;
    if ((err = cudaFuncGetAttributes(&attr, phase_resident_kernel)) != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, phase_resident_kernel, threads,
                                                        smem);
  } else {
    threads = kSweepThreads;
    if ((err = cudaFuncGetAttributes(&attr, phase_sweep_kernel)) != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, phase_sweep_kernel, threads, 0);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = threads;
  out[1] = static_cast<int>(smem);
  out[2] = blocks;
  out[3] = attr.numRegs;
  out[4] = static_cast<int>(attr.localSizeBytes);
  out[5] = mode == 0 ? kClusterBlocks : 1;
  out[6] = clusters;
  return cudaSuccess;
}

// Run n_iters >= 1 sweeps of `reps` replicates on `stream` without
// synchronising. init [2n] float32; irrs [n] float32; idx [*, k, 2n] int32
// and w [*, k, 2n] float32 (slot-major), advancing by 2n * k a replicate
// when `per_rep` is non-zero (else one set for all); valid [k, 2n] bytes;
// out [reps, 2n] float32; scratch [reps, 2n] float32 (the per-sweep mode's
// second buffer; unused in mode 0). Mode 0 is one launch, mode 1 n_iters.
// Returns the first cudaError_t.
int phase_sweeps_launch(const void* init, const void* irrs, const void* idx, const void* w,
                        const void* valid, int n, int k, int reps, int per_rep, int n_iters,
                        int mode, void* out, void* scratch, void* stream) {
  if (n <= 0 || reps <= 0) return cudaSuccess;
  if (k < 1 || n_iters < 1 || (mode != 0 && mode != 1)) return cudaErrorInvalidValue;
  if (mode == 1 && reps > 65535) return cudaErrorInvalidValue;  // a grid row per replicate
  if (mode == 0 && reps > (1 << 27)) return cudaErrorInvalidValue;  // 8 blocks a replicate
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t lists = per_rep ? static_cast<size_t>(2) * n * k : 0;
  const float* f_init = static_cast<const float*>(init);
  const float* f_irrs = static_cast<const float*>(irrs);
  const int* i_idx = static_cast<const int*>(idx);
  const float* f_w = static_cast<const float*>(w);
  const uint8_t* u_valid = static_cast<const uint8_t*>(valid);
  if (mode == 0) {
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = resident_config(n, k, reps, s, &attr);
    cudaError_t err = configure_resident(cfg.dynamicSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaLaunchKernelEx(&cfg, phase_resident_kernel, f_init, f_irrs, i_idx, f_w, u_valid, n,
                             k, lists, n_iters, resident_chunk(n), static_cast<float*>(out));
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
  }
  // the last sweep writes `out`: sweep it writes bufs[(n_iters - 1 - it) & 1]
  float* bufs[2] = {static_cast<float*>(out), static_cast<float*>(scratch)};
  const dim3 grid((n + kSweepThreads - 1) / kSweepThreads, reps);
  const float* cur = f_init;
  size_t cur_rep = 0;
  for (int it = 0; it < n_iters; ++it) {
    float* nxt = bufs[(n_iters - 1 - it) & 1];
    phase_sweep_kernel<<<grid, kSweepThreads, 0, s>>>(cur, cur_rep, f_irrs, i_idx, f_w, u_valid,
                                                      n, k, lists, nxt);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    cur = nxt;
    cur_rep = static_cast<size_t>(2) * n;
  }
  return cudaSuccess;
}

const char* phase_sweeps_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
