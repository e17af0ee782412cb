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
// gathers follow each other, and each round ends in an exchange between
// the blocks that hold a replicate (or a grid barrier). The latency of
// one round is what the design works on.
//
// A thread takes one haplotype: it walks its own list slot by slot; the
// pair (lanes h and h ^ 1 of one warp) swaps its means with one
// __shfl_xor_sync and both lanes add m_0 + m_1 in the same order. The lists
// arrive as the callers hold them, idx and w [Bt or 1, 2N, K] and valid
// [2N, K]. Two modes, by shape:
//
// - resident: a cluster of C = 8 blocks a replicate runs all n_iters
//   sweeps in one launch. Block r holds the whole value vector
//   double-buffered (2 * 2 C chunk floats) and the lists of its `chunk`
//   samples (chunk = ceil(N / C)), laid out slot-major [K, 2 chunk] in
//   shared memory while it fills them, so a warp's loads of one slot hit 32
//   banks: 16 C chunk + 18 chunk K bytes. A sweep reads only shared memory.
//   The exchange: the two lanes of a sample store its pair of new values
//   into the next buffer of every block of the cluster, its own included,
//   with st.async, each store completing 8 bytes on the receiver's mbarrier
//   of that buffer; a block starts the next sweep once its mbarrier has
//   counted all 8 N bytes (a wait with acquire at cluster scope). No block
//   barrier and no cluster barrier runs between sweeps: a cluster barrier
//   only at the start (every block has started and set up its mbarriers
//   before a peer stores into it) and at the end (no block exits while a
//   store into its shared memory may be in flight). Why two buffers
//   suffice (sweep s reads buffer s & 1 and writes (s + 1) & 1; its stores
//   complete phase s / 2 of mbarrier (s + 1) & 1):
//   * a store of sweep s into a block's buffer (s + 1) & 1, which that
//     block's threads read in sweep s - 1, comes from a thread that has
//     seen all of sweep s - 1; each of those stores follows, in its
//     thread, that thread's reads of sweep s - 1;
//   * bytes of sweep s + 2 reach mbarrier (s + 1) & 1 only after its phase
//     of sweep s has completed (their senders saw sweep s + 1, which no
//     block sent before its own wait on sweep s); bytes that arrive before
//     the receiver's arrive.expect_tx of their phase leave the transaction
//     count below zero and the phase open until the arrival.
//   A thread that takes one haplotype (2 chunk <= 1024) with a list of at
//   most kRegSlots = 10 slots loads it into registers once, so a sweep's
//   walk reads shared memory only for the neighbors' values; else its
//   walk reads the lists from shared memory each sweep. The choices
//   (st.async stores rather than a bulk copy of each block's slice, lists
//   in registers, 8 blocks rather than a non-portable 16) follow timings on
//   an H100 that PERF.md keeps. The exchange alone takes ~1 us a sweep at
//   N=2504, about what 20 KB into each SM costs at distributed shared
//   memory's rate: a sweep's floor in this design (phase_sweeps_probe
//   times the walk alone and the exchange alone).
//   The last sweep writes the output straight from registers and exchanges
//   nothing. phase_sweeps_mode takes it where a block's share fits and a
//   cluster can be scheduled: N up to ~6,000 at K=10, ~11,000 at K=2.
// - persistent: beyond that, one cooperative launch of blocks of 512
//   threads, as many as the card holds at once or the items need
//   (cudaLaunchAttributeCooperative), striding over (replicate, haplotype);
//   the ping-pong values stay in device memory, which the L2 holds (1 MB
//   at N=65,536), and cg::this_grid().sync() ends each sweep. Its fence
//   makes the last sweep's values visible to the plain (L1-cached) loads
//   of the next. It takes the place of a launch a sweep, which was faster
//   by ~2% only at K=10 with replicates (PERF.md); a card without cooperative
//   launches takes no shape past the resident mode's edge.
//
// The float64 form (the *_f64 entry points) is the same code at T = double:
// values, irrs and weights are float64, the sums use __dadd_rn / __dmul_rn
// / __ddiv_rn in slot order, and the exchange's st.async stores move a
// sample's pair as 16 bytes (.v2.f64), so a sweep completes 16 N bytes on
// each mbarrier. A resident block holds 32 C chunk + 26 chunk K bytes (80 KB
// of values at N=2504, twice float32's), so the resident mode's edge falls
// to about half float32's N, and phase_sweeps_mode_f64 answers from the
// float64 sizes. The float32 form's code is the same text instantiated at
// float, so its results are those it gave before.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;  // the resident mode's blocks a replicate
constexpr int kMaxThreads = 1024;
constexpr int kGridThreads = 512;   // the persistent mode's block
constexpr int kRegSlots = 10;       // lists up to this long ride in registers
constexpr unsigned kFull = 0xffffffffu;
// the parts of a resident sweep; the walk alone and the exchange alone are
// launched only to measure what a sweep is made of (phase_sweeps_probe)
constexpr int kWalk = 1, kExchange = 2, kWhole = kWalk | kExchange;

// the arithmetic of one value type, rounded to nearest with no fused
// multiply-add, and the reference's 1e-9 weight-sum floor in that type
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ void set_floor(float& x) { x = 1e-9f; }
__device__ __forceinline__ void set_floor(double& x) { x = 1e-9; }
__device__ __forceinline__ void set_nan(float& x) { x = __int_as_float(0x7fc00000); }
__device__ __forceinline__ void set_nan(double& x) { x = __longlong_as_double(0x7ff8000000000000LL); }

template <typename T>
__device__ __forceinline__ T nan_value() {
  T x;
  set_nan(x);
  return x;
}

template <typename T>
__device__ __forceinline__ T floor_value() {
  T x;
  set_floor(x);
  return x;
}

// The mean m = sum(w * val) / (1e-9 + sum(w)) of one haplotype over its K
// slots, slot s at offset s * stride of idx, w and valid, summed in slot
// order. A slot that does not count leaves the sums as they are, exactly
// what skipping it does; every index lies in [0, 2N) (the wrapper checks),
// so padded slots read in bounds.
template <typename T>
__device__ __forceinline__ T hap_mean(const T* cur, const int* idx, const T* w,
                                      const uint8_t* valid, int stride, int k) {
  T wsum = 0, wval = 0;
#pragma unroll 4
  for (int s = 0; s < k; ++s) {
    const int o = s * stride;
    const T ws = w[o];
    const int j = idx[o];
    const T v = cur[j];
    const bool t = valid[o] && !isnan(v);
    wsum = t ? add_rn(wsum, ws) : wsum;
    wval = t ? add_rn(wval, mul_rn(ws, v)) : wval;
  }
  // the reference's 1e-9 floor keeps an empty set's mean at 0
  return div_rn(wval, add_rn(floor_value<T>(), wsum));
}

// hap_mean over a list held in registers: slot s's index idx[s] (-1 where
// the slot does not count) and weight w[s], for s < k <= kRegs.
template <typename T, int kRegs>
__device__ __forceinline__ T hap_mean_regs(const T* cur, const int (&idx)[kRegs],
                                           const T (&w)[kRegs], int k) {
  T wsum = 0, wval = 0;
#pragma unroll
  for (int s = 0; s < kRegs; ++s) {
    if (s == k) break;
    const T v = cur[max(idx[s], 0)];
    const bool t = idx[s] >= 0 && !isnan(v);
    wsum = t ? add_rn(wsum, w[s]) : wsum;
    wval = t ? add_rn(wval, mul_rn(w[s], v)) : wval;
  }
  return div_rn(wval, add_rn(floor_value<T>(), wsum));
}

// Haplotype h's new value from its old value o, its mean m and its
// sample's irr. Every lane of the warp calls it (the shuffle): the pair's
// mean comes from lane ^ 1, which holds haplotype h ^ 1, and both lanes add
// m_0 + m_1 in that order.
template <typename T>
__device__ __forceinline__ T hap_update(T o, T m, int h, T irr) {
  const T mp = __shfl_xor_sync(kFull, m, 1);
  const T denom = (h & 1) ? add_rn(mp, m) : add_rn(m, mp);
  return denom <= T(0) || isnan(o) ? o : div_rn(mul_rn(irr, m), denom);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the address of this block's shared-memory address `addr` in the shared
// memory of block `rank` of the cluster
__device__ __forceinline__ uint32_t peer_addr(uint32_t addr, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

// one asynchronous store of a sample's two values into a block of the
// cluster (`dst`, aligned to the pair's size), completing the pair's 8
// (float32) or 16 (float64) bytes on its mbarrier `bar`
__device__ __forceinline__ void store_pair(uint32_t dst, float v0, float v1, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 [%0], {%1, %2}, [%3];" ::"r"(
          dst),
      "f"(v0), "f"(v1), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void store_pair(uint32_t dst, double v0, double v1, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f64 [%0], {%1, %2}, [%3];" ::"r"(
          dst),
      "d"(v0), "d"(v1), "r"(bar)
      : "memory");
}

// returns once the phase of parity `parity` of this block's mbarrier has
// completed, with acquire at cluster scope: the peers' stores are visible.
// The blocks of a cluster run together, so a phase that stays open for
// ~10 s (2e10 clocks) means a fault: the kernel traps, and the launch
// fails instead of holding the card.
__device__ __forceinline__ void wait_slices(uint32_t bar, uint32_t parity) {
  const long long start = clock64();
  uint32_t done = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > 20000000000LL) __trap();
  }
}

// All sweeps of replicate blockIdx.x / C in one cluster of C blocks: block
// r updates samples [r * chunk, (r + 1) * chunk) (fewer or none at the end)
// and keeps their lists beside its copy of the whole value vector. init
// [2N] is every replicate's starting vector; idx and w advance by `lists`
// elements a replicate (0: one set of lists for all); out [Bt, 2N].
// kParts is kWhole but for the measurement of a sweep's parts. kRegs:
// where a thread takes one haplotype (2 chunk <= the block's threads) and
// K <= kRegSlots, it loads its list from shared memory into registers
// once, and a sweep's walk reads shared memory only for the neighbors'
// values (kRegs = kRegSlots; else 0, the list read from shared memory each
// sweep).
template <typename T, int kParts, int kRegs>
__global__ void __launch_bounds__(kMaxThreads)
phase_resident_kernel(const T* __restrict__ init, const T* __restrict__ irrs,
                      const int* __restrict__ idx, const T* __restrict__ w,
                      const uint8_t* __restrict__ valid, int n, int k, size_t lists, int n_iters,
                      int chunk, T* __restrict__ out) {
  // [2][C * 2 chunk] values, then idx and w [K][2 chunk], then valid [K][2 chunk]
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* buf = reinterpret_cast<T*>(smem_raw);
  __shared__ __align__(8) unsigned long long bars[2];  // a buffer's slices have landed
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int two_n = 2 * n, rows = 2 * chunk, span = rows * kCluster;
  const int h0 = rank * rows;  // this block's slice of a value buffer
  const int mine = 2 * max(0, min(n - rank * chunk, chunk));  // its haplotypes
  const size_t rep = blockIdx.x / kCluster;
  int* s_idx = reinterpret_cast<int*>(buf + 2 * span);
  T* s_w = reinterpret_cast<T*>(s_idx + rows * k);  // rows is even: 8-byte aligned
  uint8_t* s_valid = reinterpret_cast<uint8_t*>(s_w + rows * k);
  for (int h = threadIdx.x; h < two_n; h += blockDim.x) buf[h] = init[h];
  // the block's lists, read as the callers hold them ([2 chunk, K]
  // contiguous), stored slot-major
  const size_t first = static_cast<size_t>(h0) * k;
  for (int j = threadIdx.x; j < mine * k; j += blockDim.x) {
    const int r = j / k, s = j - r * k;
    s_idx[s * rows + r] = idx[rep * lists + first + j];
    s_w[s * rows + r] = w[rep * lists + first + j];
    s_valid[s * rows + r] = valid[first + j];
  }
  const uint32_t bar0 = smem_addr(&bars[0]);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar0) : "memory");
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar0 + 8) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // every block has started, filled its buffer and set up its mbarriers
  // before any peer stores into it
  cluster.sync();
  int r_idx[kRegs > 0 ? kRegs : 1];
  T r_w[kRegs > 0 ? kRegs : 1];
  if (kRegs > 0) {
    const int t = threadIdx.x;
#pragma unroll
    for (int s = 0; s < kRegs; ++s) {
      const bool on = s < k && t < mine && s_valid[s * rows + t];
      r_idx[s] = on ? s_idx[s * rows + t] : -1;
      r_w[s] = on ? s_w[s * rows + t] : T(0);
    }
  }
  const int passes = (rows + 31) / 32 * 32;  // whole warps: every lane reaches the shuffle
  for (int s = 0; s < n_iters; ++s) {
    const T* cur = buf + (s & 1) * span;
    T* nxt = buf + ((s + 1) & 1) * span;
    const bool last = s + 1 == n_iters;
    const uint32_t bar = bar0 + 8 * ((s + 1) & 1);
    if ((kParts & kExchange) && !last && threadIdx.x == 0) {
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
                   "r"(static_cast<int>(2 * sizeof(T)) * n)
                   : "memory");
    }
    for (int t = threadIdx.x; t < passes; t += blockDim.x) {
      const int h = h0 + t;
      const bool active = t < mine;
      const T o = active ? cur[h] : nan_value<T>();
      T m = 0;
      if (kParts & kWalk) {
        // a sample whose two values are NaN (never phased) walks no list:
        // its values can only stay
        if (active && !(isnan(o) && isnan(cur[h ^ 1]))) {
          if constexpr (kRegs > 0)
            m = hap_mean_regs<T, kRegs>(cur, r_idx, r_w, k);
          else
            m = hap_mean(cur, s_idx + t, s_w + t, s_valid + t, rows, k);
        }
      } else {
        m = o;  // the exchange alone: a value that depends on the last sweep
      }
      const T v = hap_update(o, m, h, active ? __ldg(irrs + (h >> 1)) : T(0));
      if ((kParts & kExchange) && !last) {
        // the even lane stores the pair into the even ranks, the odd lane
        // into the odd ones
        const T vp = __shfl_xor_sync(kFull, v, 1);
        if (active) {
          const int odd = h & 1;
          const uint32_t dst = smem_addr(nxt + (h - odd));
          for (int q = odd; q < kCluster; q += 2)
            store_pair(peer_addr(dst, q), odd ? vp : v, odd ? v : vp, peer_addr(bar, q));
        }
      } else if (active) {
        if (last)
          out[rep * two_n + h] = v;
        else
          nxt[h] = v;
      }
    }
    if (last) break;
    if (kParts & kExchange)
      wait_slices(bar, (s >> 1) & 1);
    else
      __syncthreads();  // the walk alone: each block sweeps its own slice
  }
  // no block leaves while a store into its shared memory may be in flight
  cluster.sync();
}

// All sweeps in one cooperative launch: the blocks stride over the
// (replicate, haplotype) items of [Bt, 2N]; cur [2N] (init, shared by the
// replicates) then the ping-pong buffers out and scratch [Bt, 2N], whose
// last sweep lands in out. A grid barrier between sweeps.
template <typename T>
__global__ void __launch_bounds__(kGridThreads)
phase_grid_kernel(const T* init, const T* __restrict__ irrs, const int* __restrict__ idx,
                  const T* __restrict__ w, const uint8_t* __restrict__ valid, int n, int k,
                  size_t lists, int reps, int n_iters, T* out, T* scratch) {
  cg::grid_group grid = cg::this_grid();
  const size_t two_n = 2 * static_cast<size_t>(n), total = two_n * reps;
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  const T* cur = init;
  size_t cur_rep = 0;
  for (int it = 0; it < n_iters; ++it) {
    T* nxt = ((n_iters - 1 - it) & 1) ? scratch : out;
    for (size_t base = static_cast<size_t>(blockIdx.x) * blockDim.x; base < total;
         base += stride) {
      const size_t item = base + threadIdx.x;
      const bool active = item < total;
      const size_t b = active ? item / two_n : 0;
      const int h = static_cast<int>(active ? item - b * two_n : 0);
      const T* c = cur + b * cur_rep;
      const T o = active ? c[h] : nan_value<T>();
      T m = 0;
      if (active && !(isnan(o) && isnan(c[h ^ 1])))
        m = hap_mean(c, idx + b * lists + static_cast<size_t>(h) * k,
                           w + b * lists + static_cast<size_t>(h) * k,
                           valid + static_cast<size_t>(h) * k, 1, k);
      const T v = hap_update(o, m, h, active ? __ldg(irrs + (h >> 1)) : T(0));
      if (active) nxt[item] = v;
    }
    if (it + 1 < n_iters) grid.sync();
    cur = nxt;
    cur_rep = two_n;
  }
}

template <typename T>
using ResidentKernel = void (*)(const T*, const T*, const int*, const T*, const uint8_t*, int,
                                int, size_t, int, int, T*);

template <typename T, int kRegs>
ResidentKernel<T> resident_kernel_of(int parts) {
  if (parts == kWalk) return phase_resident_kernel<T, kWalk, kRegs>;
  if (parts == kExchange) return phase_resident_kernel<T, kExchange, kRegs>;
  return phase_resident_kernel<T, kWhole, kRegs>;
}

// samples a block: ceil(N / C)
int resident_chunk(int n) { return (n + kCluster - 1) / kCluster; }

int resident_threads(int n) {
  return min(kMaxThreads, (2 * resident_chunk(n) + 31) / 32 * 32);
}

// The resident kernel that runs `parts` of each sweep at N samples and K
// slots: its lists in registers where a thread takes one haplotype and a
// list has at most kRegSlots slots, else read from shared memory.
template <typename T>
ResidentKernel<T> resident_kernel(int parts, int n, int k) {
  return k <= kRegSlots && 2 * resident_chunk(n) <= kMaxThreads
             ? resident_kernel_of<T, kRegSlots>(parts)
             : resident_kernel_of<T, 0>(parts);
}

// Dynamic shared memory of one resident block: the two value buffers of
// C slices and its share of the lists (int32 index, a weight of the value
// type, one validity byte a slot): 16 C chunk + 18 chunk K bytes in
// float32, 32 C chunk + 26 chunk K in float64.
template <typename T>
size_t resident_smem_bytes(int n, int k) {
  const size_t chunk = resident_chunk(n);
  return 4 * sizeof(T) * kCluster * chunk + 2 * (5 + sizeof(T)) * chunk * k;
}

// Sets a resident kernel's attributes: shared memory before L1 once, and
// its dynamic shared-memory limit raised (never lowered) to `smem`, so a
// launch makes no host call for a kernel and size already taken. One entry
// for each of the kernel's six instances of a value type.
template <typename T>
cudaError_t configure_resident(ResidentKernel<T> kernel, size_t smem) {
  constexpr int kInstances = 6;
  static ResidentKernel<T> seen[kInstances] = {};
  static size_t allowed[kInstances] = {};
  int i = 0;
  while (i < kInstances && seen[i] != nullptr && seen[i] != kernel) ++i;
  if (i == kInstances) return cudaErrorInvalidValue;
  cudaError_t err;
  if (seen[i] == nullptr) {
    if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                    cudaSharedmemCarveoutMaxShared)) != cudaSuccess)
      return err;
    seen[i] = kernel;
  }
  if (smem > allowed[i]) {
    if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    static_cast<int>(smem))) != cudaSuccess)
      return err;
    allowed[i] = smem;
  }
  return cudaSuccess;
}

// The resident launch of `reps` replicates: a cluster of C blocks each.
template <typename T>
cudaLaunchConfig_t resident_config(int n, int k, int reps, cudaStream_t s,
                                   cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(reps) * kCluster);
  cfg.blockDim = dim3(resident_threads(n));
  cfg.dynamicSmemBytes = resident_smem_bytes<T>(n, k);
  cfg.stream = s;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kCluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Clusters of the resident mode the card can hold at once (0: none fits or
// can be scheduled).
template <typename T>
cudaError_t resident_clusters(int device, int n, int k, int* clusters) {
  *clusters = 0;
  const ResidentKernel<T> kernel = resident_kernel<T>(kWhole, n, k);
  int optin = 0;
  cudaError_t err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes fa;
  if ((err = cudaFuncGetAttributes(&fa, kernel)) != cudaSuccess) return err;
  if (resident_smem_bytes<T>(n, k) + fa.sharedSizeBytes > static_cast<size_t>(optin))
    return cudaSuccess;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = resident_config<T>(n, k, 1, nullptr, &attr);
  if ((err = configure_resident<T>(kernel, cfg.dynamicSmemBytes)) != cudaSuccess) return err;
  return cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
}

// The persistent grid: as many blocks as the card holds at once, no more
// than the items need; 0 where the card takes no cooperative launch.
template <typename T>
cudaError_t grid_blocks(int device, size_t items, int* blocks) {
  *blocks = 0;
  int coop = 0, sms = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, phase_grid_kernel<T>,
                                                           kGridThreads, 0)) != cudaSuccess)
    return err;
  if (!coop) return cudaSuccess;
  const size_t need = (items + kGridThreads - 1) / kGridThreads;
  *blocks = static_cast<int>(need < static_cast<size_t>(per_sm) * sms
                                 ? need
                                 : static_cast<size_t>(per_sm) * sms);
  return cudaSuccess;
}

// The resident launch of the kernel that runs `parts` of each sweep.
template <typename T>
int launch_resident(int parts, const T* init, const T* irrs, const int* idx, const T* w,
                    const uint8_t* valid, int n, int k, int reps, size_t lists, int n_iters,
                    T* out, cudaStream_t s) {
  if (reps > (1 << 26)) return cudaErrorInvalidValue;
  const ResidentKernel<T> kernel = resident_kernel<T>(parts, n, k);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = resident_config<T>(n, k, reps, s, &attr);
  cudaError_t err = configure_resident<T>(kernel, cfg.dynamicSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaLaunchKernelEx(&cfg, kernel, init, irrs, idx, w, valid, n, k, lists, n_iters,
                           resident_chunk(n), out);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int sweeps_mode(int device, int n, int k, int* mode) {
  *mode = -1;
  if (n <= 0 || k <= 0) return cudaErrorInvalidValue;
  int clusters = 0, blocks = 0;
  cudaError_t err = resident_clusters<T>(device, n, k, &clusters);
  if (err != cudaSuccess) return err;
  if (clusters > 0) {
    *mode = 0;
    return cudaSuccess;
  }
  if ((err = grid_blocks<T>(device, 2 * static_cast<size_t>(n), &blocks)) != cudaSuccess)
    return err;
  if (blocks == 0) return cudaErrorNotSupported;
  *mode = 1;
  return cudaSuccess;
}

template <typename T>
int sweeps_info(int mode, int n, int k, int* out) {
  if (n <= 0 || k < 1 || mode < 0 || mode > 1) return cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  int blocks = 0, clusters = 0, grid = 0;
  size_t smem = 0;
  int threads;
  if (mode == 0) {
    const ResidentKernel<T> kernel = resident_kernel<T>(kWhole, n, k);
    smem = resident_smem_bytes<T>(n, k);
    threads = resident_threads(n);
    grid = kCluster;
    if ((err = resident_clusters<T>(device, n, k, &clusters)) != cudaSuccess) return err;
    if ((err = cudaFuncGetAttributes(&attr, kernel)) != cudaSuccess) return err;
    if (clusters > 0)  // else the block's share does not fit: no block, no occupancy query
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem);
  } else {
    threads = kGridThreads;
    if ((err = grid_blocks<T>(device, 2 * static_cast<size_t>(n), &grid)) != cudaSuccess)
      return err;
    if ((err = cudaFuncGetAttributes(&attr, phase_grid_kernel<T>)) != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, phase_grid_kernel<T>, threads, 0);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = threads;
  out[1] = static_cast<int>(smem);
  out[2] = blocks;
  out[3] = attr.numRegs;
  out[4] = static_cast<int>(attr.localSizeBytes);
  out[5] = mode == 0 ? kCluster : 1;
  out[6] = clusters;
  out[7] = grid;
  return cudaSuccess;
}

template <typename T>
int sweeps_launch(const void* init, const void* irrs, const void* idx, const void* w,
                  const void* valid, int n, int k, int reps, int per_rep, int n_iters, int mode,
                  void* out, void* scratch, void* stream) {
  if (n <= 0 || reps <= 0) return cudaSuccess;
  if (k < 1 || n_iters < 1 || mode < 0 || mode > 1) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t lists = per_rep ? static_cast<size_t>(2) * n * k : 0;
  const T* f_init = static_cast<const T*>(init);
  const T* f_irrs = static_cast<const T*>(irrs);
  const int* i_idx = static_cast<const int*>(idx);
  const T* f_w = static_cast<const T*>(w);
  const uint8_t* u_valid = static_cast<const uint8_t*>(valid);
  T* f_out = static_cast<T*>(out);
  if (mode == 0) {
    return launch_resident<T>(kWhole, f_init, f_irrs, i_idx, f_w, u_valid, n, k, reps, lists,
                              n_iters, f_out, s);
  }
  int device = 0, blocks = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = grid_blocks<T>(device, static_cast<size_t>(2) * n * reps, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (blocks == 0) return cudaErrorNotSupported;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kGridThreads);
  cfg.stream = s;
  attr.id = cudaLaunchAttributeCooperative;
  attr.val.cooperative = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, phase_grid_kernel<T>, f_init, f_irrs, i_idx, f_w, u_valid, n, k,
                           lists, reps, n_iters, f_out, static_cast<T*>(scratch));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The mode that takes N samples with K slots a list on `device`: 0
// (resident: a cluster of kCluster blocks a replicate, each holding the
// value buffers and its share of the lists in shared memory) where that
// fits and can be scheduled, else 1 (persistent: one cooperative launch)
// where the card takes it; cudaErrorNotSupported where neither does.
// Returns the first cudaError_t.
int phase_sweeps_mode(int device, int n, int k, int* mode) {
  return sweeps_mode<float>(device, n, k, mode);
}

// Launch shape of `mode` at N samples and K slots (one replicate): threads
// a block, dynamic shared memory a block, resident blocks per SM,
// registers a thread, local (spill) bytes a thread, blocks a cluster,
// clusters the card holds at once (0 in mode 1) and blocks a launch (mode
// 0: one cluster). Returns the first cudaError_t.
int phase_sweeps_info(int mode, int n, int k, int* out) {
  return sweeps_info<float>(mode, n, k, out);
}

// Run n_iters >= 1 sweeps of `reps` replicates on `stream` without
// synchronising. init [2n] float32; irrs [n] float32; idx [*, 2n, k] int32
// and w [*, 2n, k] float32, advancing by 2n * k a replicate when `per_rep`
// is non-zero (else one set for all); valid [2n, k] bytes; out [reps, 2n]
// float32; scratch [reps, 2n] float32 (mode 1's second buffer; unused in
// mode 0). One launch either way. Returns the first cudaError_t.
int phase_sweeps_launch(const void* init, const void* irrs, const void* idx, const void* w,
                        const void* valid, int n, int k, int reps, int per_rep, int n_iters,
                        int mode, void* out, void* scratch, void* stream) {
  return sweeps_launch<float>(init, irrs, idx, w, valid, n, k, reps, per_rep, n_iters, mode, out,
                              scratch, stream);
}

// The float64 form of the three above: init, irrs, w, out and scratch
// float64.
int phase_sweeps_mode_f64(int device, int n, int k, int* mode) {
  return sweeps_mode<double>(device, n, k, mode);
}

int phase_sweeps_info_f64(int mode, int n, int k, int* out) {
  return sweeps_info<double>(mode, n, k, out);
}

int phase_sweeps_launch_f64(const void* init, const void* irrs, const void* idx, const void* w,
                            const void* valid, int n, int k, int reps, int per_rep, int n_iters,
                            int mode, void* out, void* scratch, void* stream) {
  return sweeps_launch<double>(init, irrs, idx, w, valid, n, k, reps, per_rep, n_iters, mode, out,
                               scratch, stream);
}

// The resident launch with only the list walk (parts 1: each block sweeps
// its own samples, a block barrier between sweeps, no exchange) or only the
// exchange (parts 2: no list walk), or both (3, the kernel
// phase_sweeps_launch runs), to measure what a sweep is made of; arguments
// as phase_sweeps_launch's (float32). The values of parts 1 and 2 are not
// the sweeps'.
int phase_sweeps_probe(int parts, const void* init, const void* irrs, const void* idx,
                       const void* w, const void* valid, int n, int k, int reps, int per_rep,
                       int n_iters, void* out, void* stream) {
  if (n <= 0 || reps <= 0) return cudaSuccess;
  if (k < 1 || n_iters < 1 || parts < kWalk || parts > kWhole) return cudaErrorInvalidValue;
  return launch_resident<float>(parts, static_cast<const float*>(init),
                                static_cast<const float*>(irrs), static_cast<const int*>(idx),
                                static_cast<const float*>(w), static_cast<const uint8_t*>(valid),
                                n, k, reps, per_rep ? static_cast<size_t>(2) * n * k : 0, n_iters,
                                static_cast<float*>(out), static_cast<cudaStream_t>(stream));
}

const char* phase_sweeps_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
