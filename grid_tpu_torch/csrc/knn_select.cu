// Exact sorted k-smallest selection: for each row of a row-major float32
// [N, W] matrix of non-negative values (finfo.max, or anything larger, for
// excluded columns), the k smallest values in ascending order with their
// column positions, ties to the lower position: stable-argsort order, which
// grid_tpu_torch/ops/knn.py:sorted_smallest_k (a stable torch.sort, the plain
// version) and grid_tpu/ops/select.py:sorted_smallest_k give.
//
// Replaces the XLA selections of grid_tpu's cohort step, which have no
// pallas_call: lax.approx_max_k(-d2, k, recall_target=1.0) at
// grid_tpu/models/cohort.py:189 (resident branch), the two-stage lax.top_k
// of grid_tpu/ops/knn.py:168-199 (panels, knn_squared) and the ring merge's
// lax.top_k at grid_tpu/parallel/pknn.py:84; the JAX package's own exact
// form is grid_tpu/ops/select.py:444 (sorted_smallest_k).
//
// Bound on the H100: each row is read once and k (value, position) pairs
// are written: 35.1 MB at N=2504, k=500 (10.5 µs at 3.35 TB/s), 136.2 MB for
// one 512 x 65,536 panel (40.7 µs). The arithmetic (compares, a sort of k)
// is far below the card's integer rate.
//
// What this design does about it (one 128-thread block per row; steps 1-2
// are csrc/dipcn_select.cu's, copied so that its outputs stay bitwise as
// they were):
//
// 1. Load. The row's keys (the float32 bits as int32: non-negative floats
//    order as their bit patterns do; -0.0 is not expected) come into shared
//    memory once, with the block min, max and count of the "body" keys,
//    those below finfo(float32).max. One round.
// 2. k-th key t by histogram radix select from the row's own range, in
//    8-bit digits, gathering the keys still in play once they fit the list
//    buffer (3 histogram rounds and a gather at N=2504). When k reaches past
//    the body, the same select runs over [finfo.max key, INT_MAX]. Yields t
//    and count(keys < t).
// 3. Tie cut and compaction in one block scan: every thread owns a
//    contiguous chunk of columns (an odd stride: no bank conflicts); one
//    exclusive scan of (ties, below t) per chunk gives each column its place.
//    The columns below t, then the first k - count(< t) ties in column
//    order, go into a list of exactly k 64-bit entries key * 2^32 + column.
// 4. A bitonic sort of the list in shared memory, padded with ~0 to the next
//    power of two P >= k: the composite key orders exactly by (value,
//    column), so the sort needs no stability. log2(P) (log2(P) + 1) / 2
//    steps of P / 2 compare-exchanges (45 at k=500), one barrier each.
// 5. Write vals (the key's bits as float32) and positions (int32).
//
// Two modes, one kernel template; knn_select_mode picks one from W, k and
// the card's shared memory:
//
// - resident (above): the row's keys in shared memory, 4 W bytes beside the
//   8 P bytes of the list (14 KB at N=2504, k=500). It takes rows up to
//   ~57,000 columns at k=500: the resident cohort step and the ring merge's
//   [best | d2] rows of k + B columns.
// - wide: the keys stay in device memory and every walk re-reads the row;
//   shared memory holds the list (at least kWideGather entries for the
//   gather). The 65,536-column panel rows of the large-N branch. Step 3
//   becomes two walks by warps, each warp over a contiguous quarter of the
//   row 32 columns at a time (coalesced): it counts first, then places each
//   column by its ballot rank among the step's lanes.
//
//   What bounds the wide mode: the row is read by the load, by each
//   histogram round until the keys in play fit the gather buffer (at least
//   one), by the gather, and twice by step 3: at least 5 walks of 4 W bytes,
//   as dipcn_select's wide mode. A 512 x 65,536 panel is 128 MB, more than
//   the 50 MB L2, so the walks come from device memory: >= 640 MB a panel
//   against the 136 MB of the one-read bound.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 12;           // launch bounds: <= 40 registers a thread
constexpr int kDigitBits = 8;
constexpr int kBins = 1 << kDigitBits;   // == 2 * kThreads: two bins per thread in the scan
constexpr int kBigKey = 0x7F7FFFFF;      // finfo(float32).max, the self and invalid-row columns
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWideGather = 2048;        // least gather capacity of the wide mode
constexpr int kMaxK = 16384;             // the list of 2^14 entries is 128 KB
constexpr unsigned long long kPad = ~0ull;  // sorts after every entry

static_assert(kBins == 2 * kThreads, "the bin scan gives each thread two bins");

// the row's keys: shared memory (resident mode) or device memory (wide)
template <bool kWide>
__device__ __forceinline__ int key_at(const int* keys, int j) {
  if constexpr (kWide) {
    return __ldg(keys + j);
  } else {
    return keys[j];
  }
}

struct Shared {
  int hist[2][kBins];  // one histogram counts while the other is cleared
  int wtot[kWarps];    // int scan scratch
  unsigned long long wtot_l[kWarps];  // packed-count scan scratch
  int rmin[kWarps], rmax[kWarps], rcnt[kWarps];
  int bin, bin_below, bin_count;  // the select round's digit, keys below it and in it
  int n_cand;
};

// Exclusive prefix of v over the block in thread order; `total` gets the
// block's sum. One barrier: the caller guarantees a barrier between the
// last read of `warp_tot` by an earlier scan and this call.
template <typename T>
__device__ __forceinline__ T block_exclusive_scan(T v, T* warp_tot, T& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  T x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_tot[warp] = x;
  __syncthreads();
  T before = 0;
  total = 0;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) {
    const T s = warp_tot[i];
    if (i < warp) before += s;
    total += s;
  }
  return before + x - v;
}

struct Found {
  int t;      // the rank-th smallest key in range
  int below;  // keys in range that are < t
};

// The rank-th smallest (1 <= rank <= keys in range) of the keys in
// [lo, lo + span], by radix select on key - lo in 8-bit digits from the
// top of span. The keys are keys[list[i]], i < n, or keys[i] when list is
// null; then, once a round leaves at most `cap` keys in play, they are
// gathered into `spare` and the later rounds walk only them. hist[parity]
// is all zero on entry and on return. (csrc/dipcn_select.cu's select_rank.)
template <bool kWide>
__device__ Found select_rank(const int* keys, const int* list, int n, int lo, unsigned span,
                             int rank, Shared& sh, int& parity, int* spare, int cap) {
  const int lane = threadIdx.x & 31;
  int bits = span ? 32 - __clz(span) : 0;
  unsigned base = 0;  // key - lo of the bin chosen so far
  int below = 0;
  while (bits > 0) {
    const int d = min(kDigitBits, bits);
    const int shift = bits - d;
    int* h = sh.hist[parity];
    // the other histogram was last read by the previous round's scan,
    // which a barrier has closed; clear it for the next round
    int* other = sh.hist[parity ^ 1];
    for (int b = threadIdx.x; b < kBins; b += kThreads) other[b] = 0;
    if (threadIdx.x == 0) sh.n_cand = 0;
    auto count = [&](int key, bool in) {
      const unsigned v = static_cast<unsigned>(key) - static_cast<unsigned>(lo);
      const unsigned digit = (v - base) >> shift;  // huge when v < base
      in = in && key >= lo && v <= span && digit < (1u << d);
      // a warp whose keys in play share one digit (a hot bin) adds them
      // in one atomic; otherwise each key adds its own
      const unsigned play = __ballot_sync(kFull, in);
      if (play == 0) return;
      const int leader = __ffs(play) - 1;
      const unsigned lead_digit = __shfl_sync(kFull, digit, leader);
      if (__all_sync(kFull, !in || digit == lead_digit)) {
        if (lane == leader) atomicAdd(&h[digit], __popc(play));
      } else if (in) {
        atomicAdd(&h[digit], 1);
      }
    };
    if constexpr (kWide) {
      // keys from device memory: four loads in flight before the votes
      constexpr int kAhead = 4;
      for (int i0 = 0; i0 < n; i0 += kAhead * kThreads) {  // uniform trip count
        int ks[kAhead];
#pragma unroll
        for (int a = 0; a < kAhead; ++a) {
          const int i = i0 + a * kThreads + threadIdx.x;
          ks[a] = i < n ? key_at<kWide>(keys, list ? list[i] : i) : 0;
        }
#pragma unroll
        for (int a = 0; a < kAhead; ++a) count(ks[a], i0 + a * kThreads + threadIdx.x < n);
      }
    } else {
      for (int i0 = 0; i0 < n; i0 += kThreads) {  // uniform trip count: whole warps in the votes
        const int i = i0 + threadIdx.x;
        count(i < n ? (list ? keys[list[i]] : keys[i]) : 0, i < n);
      }
    }
    __syncthreads();
    const int c0 = h[2 * threadIdx.x], c1 = h[2 * threadIdx.x + 1];
    int total;
    const int excl = block_exclusive_scan(c0 + c1, sh.wtot, total);
    const int r = rank - below;
    if (excl < r && r <= excl + c0 + c1) {
      const bool first = r <= excl + c0;
      sh.bin = 2 * threadIdx.x + (first ? 0 : 1);
      sh.bin_below = first ? excl : excl + c0;
      sh.bin_count = first ? c0 : c1;
    }
    __syncthreads();
    base += static_cast<unsigned>(sh.bin) << shift;
    below += sh.bin_below;
    bits = shift;
    parity ^= 1;
    if (list == nullptr && bits > 0 && sh.bin_count <= cap) {
      // gather the keys still in play; the later rounds walk only them
      for (int i = threadIdx.x; i < n; i += kThreads) {
        const int key = key_at<kWide>(keys, i);
        const unsigned v = static_cast<unsigned>(key) - static_cast<unsigned>(lo);
        if (key >= lo && v <= span && ((v - base) >> bits) == 0) {
          spare[atomicAdd(&sh.n_cand, 1)] = i;
        }
      }
      n = sh.bin_count;
      list = spare;
      __syncthreads();
    }
  }
  return {static_cast<int>(static_cast<unsigned>(lo) + base), below};
}

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

// the list's padded length: the next power of two >= k
__host__ __device__ inline int list_pow2(int k) {
  int p = 1;
  while (p < k) p <<= 1;
  return p;
}

__device__ __forceinline__ unsigned long long entry(int key, int col) {
  return (static_cast<unsigned long long>(static_cast<unsigned>(key)) << 32) |
         static_cast<unsigned>(col);
}

// Step 3 of the wide mode: the columns below t, then the first `need` ties
// in column order, into list[0, below + need), by two walks of the row by
// warps. Warp w owns columns [w*q, (w+1)*q), q a multiple of 32, and steps
// through them 32 at a time: the first walk counts (ties, below t) per
// warp; the second places each column at its warp's prefix plus its ballot
// rank among the step's lanes.
__device__ void compact_walks(const int* keys, int w, int t, int n_below, int need,
                              unsigned long long* list, Shared& sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q = round_up((w + kWarps - 1) / kWarps, 32);
  const int j0 = min(warp * q, w), j1 = min(j0 + q, w);
  unsigned long long cnt = 0;  // ties | below t << 32
#pragma unroll 4
  for (int j = j0 + lane; j < j1; j += 32) {
    const int key = __ldg(keys + j);
    cnt += key == t ? 1ull : (key < t ? 1ull << 32 : 0ull);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) cnt += __shfl_xor_sync(kFull, cnt, o);
  if (lane == 0) sh.wtot_l[warp] = cnt;
  __syncthreads();
  unsigned long long pre = 0;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) {
    if (i < warp) pre += sh.wtot_l[i];
  }
  int ties = static_cast<int>(pre & 0xffffffffull);
  int pos_below = static_cast<int>(pre >> 32);
  const unsigned before = (1u << lane) - 1;  // the lanes below this one
#pragma unroll 4
  for (int jb = j0; jb < j1; jb += 32) {  // uniform trip count: whole warps in the votes
    const int j = jb + lane;
    const bool in = j < j1;
    const int key = in ? __ldg(keys + j) : 0;
    const bool below = in && key < t, tie = in && key == t;
    const unsigned b_below = __ballot_sync(kFull, below);
    const unsigned b_tie = __ballot_sync(kFull, tie);
    if (below) list[pos_below + __popc(b_below & before)] = entry(key, j);
    const int rank = ties + __popc(b_tie & before);  // ties before this one, in column order
    if (tie && rank < need) list[n_below + rank] = entry(key, j);
    ties += __popc(b_tie);
    pos_below += __popc(b_below);
  }
}

// Dynamic shared memory of one resident-mode block: keys, then the list
// (the gather buffer before it is filled: 2 P int32 entries).
__host__ __device__ inline size_t resident_smem_bytes(int w, int k) {
  return static_cast<size_t>(round_up(w, 4)) * 4 + static_cast<size_t>(list_pow2(k)) * 8;
}

// Dynamic shared memory of one wide-mode block: the list, which is also the
// gather buffer of at least kWideGather int32 entries.
__host__ __device__ inline size_t wide_smem_bytes(int k) {
  const size_t list = static_cast<size_t>(list_pow2(k)) * 8;
  const size_t gather = static_cast<size_t>(kWideGather) * 4;
  return list > gather ? list : gather;
}

template <bool kWide>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
knn_select_kernel(const float* __restrict__ d2, int w, int k, float* __restrict__ vals,
                  int* __restrict__ pos) {
  extern __shared__ int4 dyn[];
  const int* src = reinterpret_cast<const int*>(d2) + static_cast<size_t>(blockIdx.x) * w;
  const int key_words = kWide ? 0 : round_up(w, 4);
  const int* keys = kWide ? src : reinterpret_cast<const int*>(dyn);  // [w]
  unsigned long long* list =
      reinterpret_cast<unsigned long long*>(reinterpret_cast<int*>(dyn) + key_words);
  __shared__ Shared sh;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int p2 = list_pow2(k);

  // ---- 1. load the row's keys; body min / max / count --------------------
  // (the wide mode leaves the keys in device memory)
  for (int b = tid; b < 2 * kBins; b += kThreads) (&sh.hist[0][0])[b] = 0;
  int mn = INT_MAX, mx = INT_MIN;
  unsigned nb = 0;
  auto see = [&](int key) {
    if (key < kBigKey) {
      mn = min(mn, key);
      mx = max(mx, key);
      ++nb;
    }
  };
  if ((w & 3) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int4* s4 = reinterpret_cast<const int4*>(src);
    int4* k4 = reinterpret_cast<int4*>(dyn);
#pragma unroll 4
    for (int q = tid; q < w / 4; q += kThreads) {
      // resident: streamed, each row is read by one block, once; wide: the
      // later walks read the row again
      const int4 v = kWide ? __ldg(s4 + q) : __ldcs(s4 + q);
      if (!kWide) k4[q] = v;
      see(v.x);
      see(v.y);
      see(v.z);
      see(v.w);
    }
  } else {
    int* ks = reinterpret_cast<int*>(dyn);
#pragma unroll 4
    for (int j = tid; j < w; j += kThreads) {
      const int v = kWide ? __ldg(src + j) : __ldcs(src + j);
      if (!kWide) ks[j] = v;
      see(v);
    }
  }
  mn = __reduce_min_sync(kFull, mn);
  mx = __reduce_max_sync(kFull, mx);
  nb = __reduce_add_sync(kFull, nb);
  if (lane == 0) {
    sh.rmin[warp] = mn;
    sh.rmax[warp] = mx;
    sh.rcnt[warp] = static_cast<int>(nb);
  }
  __syncthreads();
  int body_lo = INT_MAX, body_hi = INT_MIN, n_body = 0;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) {
    body_lo = min(body_lo, sh.rmin[i]);
    body_hi = max(body_hi, sh.rmax[i]);
    n_body += sh.rcnt[i];
  }
  int parity = 0;
  // the list's space, free until step 3, gathers the keys still in play
  int* spare = reinterpret_cast<int*>(list);
  const int cap = kWide ? max(2 * p2, kWideGather) : 2 * p2;

  // ---- 2. t = the k-th smallest key, and count(keys < t) -----------------
  Found f;
  if (k <= n_body) {
    f = select_rank<kWide>(keys, nullptr, w, body_lo,
                           static_cast<unsigned>(body_hi) - static_cast<unsigned>(body_lo), k, sh,
                           parity, spare, cap);
  } else {  // k reaches past the body into the finfo.max (or larger) keys
    f = select_rank<kWide>(keys, nullptr, w, kBigKey,
                           static_cast<unsigned>(INT_MAX) - static_cast<unsigned>(kBigKey),
                           k - n_body, sh, parity, spare, cap);
    f.below += n_body;
  }
  const int t = f.t;
  const int n_below = f.below;
  const int need = k - n_below;  // ties at t to take, lowest columns first: 1 <= need
  // the gather's last reads of `spare` ended at select_rank's last barrier

  // ---- 3. tie cut and compaction into the list, one scan -----------------
  if constexpr (kWide) {
    compact_walks(keys, w, t, n_below, need, list, sh);
  } else {
    const int chunk = ((w + kThreads - 1) / kThreads) | 1;  // odd: conflict-free chunk walks
    const int c0 = min(tid * chunk, w), c1 = min(c0 + chunk, w);
    unsigned long long cnt = 0;  // ties | below t << 32
    for (int j = c0; j < c1; ++j) {
      const int key = keys[j];
      cnt += key == t ? 1ull : (key < t ? 1ull << 32 : 0ull);
    }
    unsigned long long tot;
    const unsigned long long pre = block_exclusive_scan(cnt, sh.wtot_l, tot);
    int ties = static_cast<int>(pre & 0xffffffffull);
    int pos_below = static_cast<int>(pre >> 32);
    for (int j = c0; j < c1; ++j) {
      const int key = keys[j];
      if (key < t) {
        list[pos_below++] = entry(key, j);
      } else if (key == t) {
        if (ties < need) list[n_below + ties] = entry(key, j);
        ++ties;
      }
    }
  }
  for (int i = k + tid; i < p2; i += kThreads) list[i] = kPad;
  __syncthreads();

  // ---- 4. bitonic sort of the p2 entries --------------------------------
  for (int size = 2; size <= p2; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = tid; i < p2 / 2; i += kThreads) {
        const int a = 2 * i - (i & (stride - 1));  // i with a zero bit inserted at `stride`
        const int b = a + stride;
        const unsigned long long x = list[a], y = list[b];
        if ((x > y) == ((a & size) == 0)) {  // ascending where bit `size` of a is clear
          list[a] = y;
          list[b] = x;
        }
      }
      __syncthreads();
    }
  }

  // ---- 5. write -----------------------------------------------------------
  const size_t out = static_cast<size_t>(blockIdx.x) * k;
  for (int i = tid; i < k; i += kThreads) {
    const unsigned long long e = list[i];
    vals[out + i] = __int_as_float(static_cast<int>(e >> 32));
    pos[out + i] = static_cast<int>(e & 0xffffffffull);
  }
}

template <bool kWide>
cudaError_t configure(size_t smem) {
  static bool carveout_set = false;
  if (!carveout_set) {
    // shared memory before L1: the blocks per SM are bound by shared memory
    const cudaError_t err = cudaFuncSetAttribute(
        knn_select_kernel<kWide>, cudaFuncAttributePreferredSharedMemoryCarveout,
        cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    carveout_set = true;
  }
  if (smem > 48 * 1024) {
    return cudaFuncSetAttribute(knn_select_kernel<kWide>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(smem));
  }
  return cudaSuccess;
}

size_t mode_smem_bytes(int mode, int w, int k) {
  return mode == 0 ? resident_smem_bytes(w, k) : wide_smem_bytes(k);
}

template <bool kWide>
int info(int w, int k, int* out) {
  const size_t smem = mode_smem_bytes(kWide, w, k);
  cudaError_t err = configure<kWide>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, knn_select_kernel<kWide>);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, knn_select_kernel<kWide>, kThreads,
                                                      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = kThreads;
  out[1] = static_cast<int>(smem);
  out[2] = static_cast<int>(attr.sharedSizeBytes);
  out[3] = blocks;
  out[4] = attr.numRegs;
  out[5] = static_cast<int>(attr.localSizeBytes);
  return cudaSuccess;
}

// The arguments every launch checks: a mode that takes rows of w columns.
bool valid_shape(int w, int k, int mode) {
  return w > 0 && k >= 1 && k <= w && k <= kMaxK && (mode == 0 || mode == 1);
}

}  // namespace

extern "C" {

// The mode that takes rows of w columns at this k on `device`: 0 (the
// row's keys in shared memory) whenever its shared memory fits, else 1
// (wide: the keys stay in device memory) where that fits, else -1.
// Returns the first cudaError_t.
int knn_select_mode(int device, int w, int k, int* mode) {
  int optin = 0;
  cudaError_t err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes resident, wide;
  if ((err = cudaFuncGetAttributes(&resident, knn_select_kernel<false>)) != cudaSuccess) return err;
  if ((err = cudaFuncGetAttributes(&wide, knn_select_kernel<true>)) != cudaSuccess) return err;
  const size_t avail = static_cast<size_t>(optin);
  if (!valid_shape(w, k, 0)) {
    *mode = -1;
  } else if (resident_smem_bytes(w, k) + resident.sharedSizeBytes <= avail) {
    *mode = 0;
  } else if (wide_smem_bytes(k) + wide.sharedSizeBytes <= avail) {
    *mode = 1;
  } else {
    *mode = -1;
  }
  return cudaSuccess;
}

// Launch shape of `mode` for rows of w columns at this k: threads, dynamic
// and static shared memory per block, resident blocks per SM, registers a
// thread and local (spill) bytes a thread. Returns the first cudaError_t.
int knn_select_info(int mode, int w, int k, int* out) {
  if (!valid_shape(w, k, mode)) return cudaErrorInvalidValue;
  return mode == 0 ? info<false>(w, k, out) : info<true>(w, k, out);
}

// Launch `mode` (from knn_select_mode) on `stream` without synchronising:
// d2 [n, w] float32 row-major in, vals [n, k] float32 and pos [n, k] int32
// out. Returns the first cudaError_t.
int knn_select_launch(const void* d2, int n, int w, int k, int mode, void* vals, void* pos,
                      void* stream) {
  if (n <= 0) return cudaSuccess;
  if (!valid_shape(w, k, mode)) return cudaErrorInvalidValue;
  const size_t smem = mode_smem_bytes(mode, w, k);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (mode == 0) {
    if ((err = configure<false>(smem)) != cudaSuccess) return err;
    knn_select_kernel<false><<<n, kThreads, smem, s>>>(static_cast<const float*>(d2), w, k,
                                                       static_cast<float*>(vals),
                                                       static_cast<int*>(pos));
  } else {
    if ((err = configure<true>(smem)) != cudaSuccess) return err;
    knn_select_kernel<true><<<n, kThreads, smem, s>>>(static_cast<const float*>(d2), w, k,
                                                      static_cast<float*>(vals),
                                                      static_cast<int*>(pos));
  }
  return static_cast<int>(cudaGetLastError());
}

const char* knn_select_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
