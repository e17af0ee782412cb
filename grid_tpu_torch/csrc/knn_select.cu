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
// are written: 35.1 MB at N=2504, k=500 (10.5 us at 3.35 TB/s), 136.2 MB for
// one 512 x 65,536 panel (40.7 us). The arithmetic (compares, a sort of k)
// is far below the card's integer rate. What a row costs beyond its bytes
// is a chain of dependent steps (histogram rounds, a tie cut, a sort), so
// the design keeps every step on-chip and cuts its barriers.
//
// Design (128 threads a block):
//
// 1. Load. A row is split into C contiguous slices, one per block of a
//    thread-block cluster of C = 1, 2, 4 or 8 blocks (C from W: the least
//    that keeps a slice within kSliceTarget columns). Each block copies its
//    slice into its shared memory with one TMA bulk copy (cp.async.bulk,
//    completion on an mbarrier; plain loads where the slice is not 16-byte
//    aligned), so the row crosses device memory once. The keys are the
//    float32 bits as int32 (non-negative floats order as their bit
//    patterns; -0.0 is not expected). Each block's body min, max and count
//    (keys below finfo.max) are merged through distributed shared memory.
// 2. k-th key t by histogram radix select from the row's own range, in
//    8-bit digits: each block counts its slice into its own 256-bin
//    histogram (a shared-memory atomic a key), a cluster barrier, then
//    every block sums the C histograms from distributed shared memory (all
//    C loads in flight at once) and picks the same bin. One cluster barrier
//    a round. Once the row holds at most 2 L keys at or below the chosen
//    bin, each block gathers the indices of its own (16-bit in shared
//    memory; one atomic a warp step) and the later rounds count only them.
//    When k reaches past the body, the same select runs over [finfo.max
//    key, INT_MAX], the body's keys gathered as below t.
// 3. The list. Where the blocks gathered and the row's keys below t and
//    all its ties at t fit the list (the rule on real distances), each
//    block writes its gathered keys <= t straight into the leader block's
//    list as 64-bit entries key * 2^32 + column, at places taken from a
//    fill count in the leader's shared memory (one remote atomic a warp
//    step), in no order. Else (no round ran, no gather, or more ties than
//    the list holds) two walks of each slice by warps, with the counts of
//    the slices before it published to the cluster, place every column
//    below t and the first k - count(< t) ties in column order, by ballot
//    rank. A cluster barrier, and the other blocks leave.
// 4. The leader sorts the list, padded with ~0 to L = max(next power of
//    two >= k, 128) entries: the composite key orders exactly by (value,
//    column), so a bitonic network needs no stability and puts the lowest
//    columns of the ties first. A lane holds 4 consecutive entries in
//    registers and a warp 128: strides 1 and 2 run in registers, strides
//    4-64 by __shfl_xor_sync, and only strides of 128 or more go through
//    shared memory with a block barrier (3 of the 45 steps at L=512).
// 5. Write vals (the key's bits as float32) and positions (int32) from the
//    registers of the last stage.
//
// Modes; knn_select_mode picks one from W, k and the card:
//
// - shared (mode 0): as above, a cluster of C blocks a row, C = 1
//   ("resident": the N=2504 step, the ring merge's [best | d2] rows) up to 8
//   ("cluster": a panel's 65,536 columns take 8 blocks of 8,192; the
//   N=100,000 biobank row 8 of 12,500). Each block holds its slice, the
//   list and the gather buffer: 4 ceil(W / C) + 12 L bytes.
// - wide (mode 1): rows whose slices do not fit a block even over 8 blocks
//   (past 448,192 columns at k=500 on an H100) keep their keys in device memory, one
//   block a row, with the list and a gather buffer of max(L, kWideGather)
//   int32 indices (12 L bytes at most: every k <= 16,384 fits, at any W):
//   the load, each histogram round until the keys in play fit the buffer
//   and the gather re-read the row (at least 3 walks; 5 where the tie cut
//   takes the two walks).
//
// The float64 form (the *_f64 entry points; Keys<double>) runs the same
// kernel on [N, W] float64 rows, as grid_tpu's exact selection does for
// float64 with int64 keys (grid_tpu/ops/select.py:35-40). Its keys are the
// doubles' bits as int64, finfo(float64).max marks the excluded columns,
// and the radix select takes up to 8 digits where float32 takes 4. A key
// fills 64 bits alone, so a list entry is a (key, column) pair of 16 bytes
// that the bitonic network compares as a pair: (value, column) order, as
// the composite orders float32. Its shared mode runs one block a row only
// (C = 1, up to kSliceTarget columns: 8 W + 20 L bytes, 30,272 B for a
// resident N=2504 row at k=500); wider rows take the wide mode, which beat the
// 8-block cluster on a 65,536-column float64 panel on the H100. Lists hold
// up to 2^13 entries (k <= 8,192) so that the wide mode's list and buffer
// fit a block. The float32 form's code is the same text instantiated at
// int keys, so its results are those it gave before.
//
// The bfloat16 form (the *_bf16 entry points; Keys<__nv_bfloat16>) takes
// [N, W] bf16 rows, as grid_tpu's selection takes bf16 with int16 keys
// (grid_tpu/ops/select.py:39). The row is stored and copied as its 16-bit
// patterns (half the bytes of float32: a slice of 8,192 columns is 16 KB)
// and each key is widened to int as it is read, so the select, the
// compaction and the tie order run the float32 form's code on 15-bit keys;
// finfo(bf16).max (0x7F7F) marks the excluded columns, and the radix select
// takes two 8-bit digits. A list entry is key * 2^17 + column in 32 bits
// (W <= 131,072 columns), so the bitonic network moves 4-byte words where
// float32 moves 8-byte ones and compares them as one integer: (value,
// column) order. Modes and cluster sizes are float32's, k <= 16,384. Bound
// at N=2504, k=500: 2 N^2 + 6 N k bytes = 20.1 MB, 6.0 us at 3.35 TB/s.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kDigitBits = 8;
constexpr int kBins = 1 << kDigitBits;   // == 2 * kThreads: two bins per thread in the scan
constexpr unsigned kFull = 0xffffffffu;
constexpr int kE = 4;                    // list entries a lane holds in the sort
constexpr int kSpan = 32 * kE;           // entries a warp sorts in registers
constexpr int kMaxCluster = 8;           // the portable cluster size
constexpr int kSliceTarget = 8192;       // columns a block's slice aims at
constexpr int kWideGather = 2048;        // least gather capacity of the wide mode
constexpr int kAhead = 4;                // keys a thread loads before it counts or votes

static_assert(kBins == 2 * kThreads, "the bin scan gives each thread two bins");
static_assert(kE == 4, "the in-register stages are written out for 4 entries a lane");

// A float64 list entry: the key's bits and the column, compared as a pair.
struct __align__(16) Pair {
  unsigned long long key;
  unsigned long long col;
};

// The keys of a value type: non-negative floats order as their bit
// patterns read as signed integers of the same width (-0.0 is not
// expected); kBig is finfo.max, the self and invalid-row columns; S is a
// key as the row stores it, K as the kernel computes with it; E is a list
// entry, ordered by (value, column).
template <typename T>
struct Keys;

template <>
struct Keys<float> {
  using S = int;
  using K = int;
  using U = unsigned;
  using E = unsigned long long;  // key * 2^32 + column
  static constexpr K kBig = 0x7F7FFFFF;
  static constexpr K kMin = INT_MIN, kMax = INT_MAX;
  static constexpr int kMaxK = 16384;    // a list of 2^14 entries is 128 KB
  static constexpr int kMinBlocks = 12;  // launch bounds: <= 40 registers a thread
  static constexpr int kMaxShared = kMaxCluster;  // the shared mode's largest cluster
};

template <>
struct Keys<double> {
  using S = long long;
  using K = long long;
  using U = unsigned long long;
  using E = Pair;
  static constexpr K kBig = 0x7FEFFFFFFFFFFFFFLL;
  static constexpr K kMin = LLONG_MIN, kMax = LLONG_MAX;
  static constexpr int kMaxK = 8192;     // a list of 2^13 pairs is 128 KB
  static constexpr int kMinBlocks = 8;   // the pairs take twice the sort's registers
  // one block a row: over a cluster the float64 panel row (8 blocks of 64 KB)
  // lost to the wide mode on the H100 (0.634 against 0.379 ms a 512-row panel)
  static constexpr int kMaxShared = 1;
};

template <>
struct Keys<__nv_bfloat16> {
  using S = short;  // the 16-bit pattern; non-negative bf16 read 0 .. 0x7FFF
  using K = int;
  using U = unsigned;
  using E = unsigned;  // key * 2^17 + column
  static constexpr K kBig = 0x7F7F;
  static constexpr K kMin = INT_MIN, kMax = 0x7FFF;
  static constexpr int kMaxK = 16384;    // a list of 2^14 entries is 64 KB
  static constexpr int kMinBlocks = 12;
  static constexpr int kMaxShared = kMaxCluster;
  static constexpr int kMaxCols = 1 << 17;  // the entry's column field
};

// the columns a row may hold: the bf16 entry's column field bounds them
template <typename T>
constexpr long long max_cols() {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return Keys<T>::kMaxCols;
  } else {
    return LLONG_MAX;
  }
}

// a gathered index: a column of the block's slice (at most 65,535 of them
// in shared memory), or of the row in the wide mode
template <bool kWide>
using Index = typename std::conditional<kWide, int, unsigned short>::type;

// a stored key, widened to the type the kernel computes in (int for the
// 16-bit keys of bf16)
template <typename S>
using Wide = typename std::conditional<sizeof(S) == 2, int, S>::type;

template <bool kWide, typename S>
__device__ __forceinline__ Wide<S> key_at(const S* keys, int j) {
  if constexpr (kWide) {
    return __ldg(keys + j);
  } else {
    return keys[j];
  }
}

__device__ __forceinline__ int bit_width(unsigned v) { return 32 - __clz(v); }
__device__ __forceinline__ int bit_width(unsigned long long v) { return 64 - __clzll(v); }

__device__ __forceinline__ int warp_min(int v) { return __reduce_min_sync(kFull, v); }
__device__ __forceinline__ int warp_max(int v) { return __reduce_max_sync(kFull, v); }
__device__ __forceinline__ long long warp_min(long long v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const long long y = __shfl_xor_sync(kFull, v, o);
    v = y < v ? y : v;
  }
  return v;
}
__device__ __forceinline__ long long warp_max(long long v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const long long y = __shfl_xor_sync(kFull, v, o);
    v = y > v ? y : v;
  }
  return v;
}

template <typename K>
struct Shared {
  int hist[2][kBins];  // one histogram counts while the other is read by the cluster
  unsigned long long wtot_l[kWarps];
  int wtot[kWarps];
  K rmin[kWarps], rmax[kWarps];
  int rcnt[kWarps];
  K stat[3];               // this slice's body min, max and count, read by the cluster
  unsigned long long cnt;  // this slice's ties | below t << 32, read by the cluster
  int bin, bin_below, bin_count;  // the select round's digit, keys below it and in it
  int n_cand;
  int fill;                // the leader's: entries placed in its list
  unsigned long long bar;  // the bulk copy's mbarrier
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// one TMA bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from device memory into this block's shared memory, completing on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// returns once the barrier's phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// Exclusive prefix of v over the block in thread order; `total` gets the
// block's sum. One barrier: the caller guarantees a barrier between the
// last read of `warp_tot` by an earlier scan and this call.
__device__ __forceinline__ int block_exclusive_scan(int v, int* warp_tot, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_tot[warp] = x;
  __syncthreads();
  int before = 0;
  total = 0;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) {
    const int s = warp_tot[i];
    if (i < warp) before += s;
    total += s;
  }
  return before + x - v;
}

// The value at `p` in the shared memory of rank q of the cluster, 0 for
// q >= csize; a caller unrolls over q so that every round trip through
// distributed shared memory is in flight before the first is used.
template <typename T>
__device__ __forceinline__ T remote(cg::cluster_group& cluster, int csize, T* p, int q) {
  return q < csize ? *cluster.map_shared_rank(p, q) : T(0);
}

template <typename K>
struct Found {
  K t;           // the rank-th smallest key in range, over the row
  int below;     // keys of the row below t (in range, plus `extra`)
  int ties;      // keys of the row equal to t; -1 where no round ran
  bool gathered; // each block's `spare` holds every key of its slice <= t
  int n;         // this block's gathered indices
};

// The rank-th smallest (1 <= rank <= the row's keys in range) of the row's
// keys in [lo, lo + span], by radix select on key - lo in 8-bit digits from
// the top of span. This block holds keys[0, n) of the row; the cluster's C
// blocks hold the rest, and each round's histograms are summed over them.
// The row has `extra` keys below lo (all of them below t). Once a round
// leaves at most `cap` keys of the row at or below its bin, each block
// gathers the indices of its own into `spare`, and the later rounds walk
// only them. hist[parity] is all zero on entry.
template <typename T, bool kWide>
__device__ Found<typename Keys<T>::K> select_rank(
    cg::cluster_group& cluster, int csize, const typename Keys<T>::S* keys, int n,
    typename Keys<T>::K lo, typename Keys<T>::U span, int rank, int extra,
    Shared<typename Keys<T>::K>& sh, int& parity, Index<kWide>* spare, int cap) {
  using K = typename Keys<T>::K;
  using U = typename Keys<T>::U;
  const int lane = threadIdx.x & 31;
  const Index<kWide>* list = nullptr;  // the gathered indices, once there are any
  int bits = span ? bit_width(span) : 0;
  U base = 0;  // key - lo of the bin chosen so far
  int below = 0, ties = -1;
  while (bits > 0) {
    const int d = min(kDigitBits, bits);
    const int shift = bits - d;
    int* h = sh.hist[parity];
    // a shared-memory atomic a key in play; the lanes of a warp that hit
    // one bin are serialised, which only rows of many equal keys see
    auto count = [&](K key) {
      const U v = static_cast<U>(key) - static_cast<U>(lo);
      const U digit = (v - base) >> shift;  // huge when v < base
      if (key >= lo && v <= span && digit < (1u << d)) atomicAdd(&h[digit], 1);
    };
    if (list != nullptr) {
      for (int i = threadIdx.x; i < n; i += kThreads) count(key_at<kWide>(keys, list[i]));
    } else {
      // four keys in flight before their counts
      for (int i0 = 0; i0 < n; i0 += kAhead * kThreads) {
        K ks[kAhead];
#pragma unroll
        for (int a = 0; a < kAhead; ++a) {
          const int i = i0 + a * kThreads + threadIdx.x;
          ks[a] = i < n ? key_at<kWide>(keys, i) : K(-1);
        }
#pragma unroll
        for (int a = 0; a < kAhead; ++a) {
          if (ks[a] >= 0) count(ks[a]);
        }
      }
    }
    // every block's histogram of this round is complete and visible
    cluster.sync();
    // the other histogram was last read by the cluster in the previous
    // round, before this barrier: clear it for the next round
    int* other = sh.hist[parity ^ 1];
    for (int b = threadIdx.x; b < kBins; b += kThreads) other[b] = 0;
    if (threadIdx.x == 0) sh.n_cand = 0;
    int c0 = 0, c1 = 0;
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q) {
      c0 += remote(cluster, csize, h + 2 * threadIdx.x, q);
      c1 += remote(cluster, csize, h + 2 * threadIdx.x + 1, q);
    }
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
    parity ^= 1;
    base += static_cast<U>(sh.bin) << shift;
    below += sh.bin_below;
    ties = sh.bin_count;  // keys equal to t once bits reaches 0
    bits = shift;
    if (list == nullptr && bits > 0 && extra + below + sh.bin_count <= cap) {
      // gather this block's keys at or below the bin (all the row's keys
      // below t and its ties among them), one atomic a warp step; the later
      // rounds walk only them
      const U end = base + (static_cast<U>(1) << bits);
      const unsigned before = (1u << lane) - 1;  // the lanes below this one
      for (int i0 = 0; i0 < n; i0 += kAhead * kThreads) {  // uniform: whole warps in the votes
        bool take[kAhead];
#pragma unroll
        for (int a = 0; a < kAhead; ++a) {  // four keys in flight before the votes
          const int i = i0 + a * kThreads + threadIdx.x;
          const K key = i < n ? key_at<kWide>(keys, i) : K(0);
          const U v = static_cast<U>(key) - static_cast<U>(lo);
          take[a] = i < n && (key < lo || (v <= span && v < end));
        }
#pragma unroll
        for (int a = 0; a < kAhead; ++a) {
          const unsigned b = __ballot_sync(kFull, take[a]);
          if (b == 0) continue;
          const int leader = __ffs(b) - 1;
          int at = 0;
          if (lane == leader) at = atomicAdd(&sh.n_cand, __popc(b));
          at = __shfl_sync(kFull, at, leader);
          if (take[a]) {
            spare[at + __popc(b & before)] =
                static_cast<Index<kWide>>(i0 + a * kThreads + threadIdx.x);
          }
        }
      }
      __syncthreads();
      n = sh.n_cand;
      list = spare;
    }
  }
  return {static_cast<K>(static_cast<U>(lo) + base), extra + below, ties, list != nullptr, n};
}

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

// keys a row's 16-byte line holds, at least 4: the shared slice's list
// starts 16-byte aligned after round_up(slice, key_align) keys, and a row
// of a multiple of it takes the 16-byte loads
template <typename S>
__host__ __device__ constexpr int key_align() {
  return 16 / static_cast<int>(sizeof(S)) > 4 ? 16 / static_cast<int>(sizeof(S)) : 4;
}

// the sorted list's length: the next power of two >= k, at least a warp's span
__host__ __device__ inline int list_len(int k) {
  int p = kSpan;
  while (p < k) p <<= 1;
  return p;
}

// indices the gather buffer holds: in the shared mode twice the list's
// length (16-bit indices of a slice: half the list's size); in the wide
// mode the list's length (int32 indices: half its size, so that the list
// and the buffer fit a block at k = 16,384), at least kWideGather (every
// round there re-reads device memory). The buffer never holds fewer than
// L: the gathered keys are placed only where the row's entries <= t fit
// the list.
template <bool kWide>
__host__ __device__ inline int gather_cap(int k) {
  const int l = list_len(k);
  return kWide ? (l < kWideGather ? kWideGather : l) : 2 * l;
}

__device__ __forceinline__ unsigned long long entry(int key, int col) {
  return (static_cast<unsigned long long>(static_cast<unsigned>(key)) << 32) |
         static_cast<unsigned>(col);
}

__device__ __forceinline__ unsigned entry16(int key, int col) {
  return (static_cast<unsigned>(key) << 17) | static_cast<unsigned>(col);
}

__device__ __forceinline__ Pair entry(long long key, int col) {
  return {static_cast<unsigned long long>(key),
          static_cast<unsigned long long>(static_cast<unsigned>(col))};
}

// the list entry of type E of a key and its column
template <typename E, typename K>
__device__ __forceinline__ E make_entry(K key, int col) {
  if constexpr (std::is_same<E, unsigned>::value) {
    return entry16(key, col);
  } else {
    return entry(key, col);
  }
}

// the list's padding: sorts after every entry
__device__ __forceinline__ void set_pad(unsigned long long& e) { e = ~0ull; }
__device__ __forceinline__ void set_pad(unsigned& e) { e = ~0u; }
__device__ __forceinline__ void set_pad(Pair& e) { e = {~0ull, ~0ull}; }

// (value, column) order of two entries
__device__ __forceinline__ bool gt(unsigned long long a, unsigned long long b) { return a > b; }
__device__ __forceinline__ bool gt(unsigned a, unsigned b) { return a > b; }
__device__ __forceinline__ bool gt(const Pair& a, const Pair& b) {
  return a.key > b.key || (a.key == b.key && a.col > b.col);
}

__device__ __forceinline__ unsigned long long shfl_xor(unsigned long long v, int m) {
  return __shfl_xor_sync(kFull, v, m);
}
__device__ __forceinline__ unsigned shfl_xor(unsigned v, int m) {
  return __shfl_xor_sync(kFull, v, m);
}
__device__ __forceinline__ Pair shfl_xor(const Pair& v, int m) {
  return {__shfl_xor_sync(kFull, v.key, m), __shfl_xor_sync(kFull, v.col, m)};
}

// an entry's value (the key's bits) and column, for the output
__device__ __forceinline__ void write_entry(unsigned long long e, float* val, int* pos) {
  *val = __int_as_float(static_cast<int>(e >> 32));
  *pos = static_cast<int>(e & 0xffffffffull);
}
__device__ __forceinline__ void write_entry(unsigned e, __nv_bfloat16* val, int* pos) {
  *val = __ushort_as_bfloat16(static_cast<unsigned short>(e >> 17));
  *pos = static_cast<int>(e & 0x1ffffu);
}
__device__ __forceinline__ void write_entry(const Pair& e, double* val, int* pos) {
  *val = __longlong_as_double(static_cast<long long>(e.key));
  *pos = static_cast<int>(e.col);
}

// Step 3: this block's columns below t, then its share of the first `need`
// ties in column order, into the leader's list[0, n_below + need). Warp w
// walks its quarter [w*q, (w+1)*q) of the slice (q a multiple of 32) 32
// columns at a time, twice: it counts (ties, below t) first; after the
// counts of the slices before this one arrive through the cluster, it
// places each column at the prefix plus its ballot rank among the step's
// lanes. `j0` is the slice's first column in the row.
template <bool kWide, typename S, typename K, typename E>
__device__ void compact(cg::cluster_group& cluster, int rank, const S* keys, int n, int j0,
                        K t, int n_below, int need, E* list, Shared<K>& sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q = round_up((n + kWarps - 1) / kWarps, 32);
  const int i0 = min(warp * q, n), i1 = min(i0 + q, n);
  unsigned long long cnt = 0;  // ties | below t << 32
#pragma unroll 4
  for (int i = i0 + lane; i < i1; i += 32) {
    const K key = key_at<kWide>(keys, i);
    cnt += key == t ? 1ull : (key < t ? 1ull << 32 : 0ull);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) cnt += __shfl_xor_sync(kFull, cnt, o);
  if (lane == 0) sh.wtot_l[warp] = cnt;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long block = 0;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) block += sh.wtot_l[i];
    sh.cnt = block;
  }
  // every slice's counts are published
  cluster.sync();
  unsigned long long pre = 0;
#pragma unroll
  for (int q = 0; q < kMaxCluster; ++q) pre += remote(cluster, rank, &sh.cnt, q);  // slices before
#pragma unroll
  for (int i = 0; i < kWarps; ++i) {
    if (i < warp) pre += sh.wtot_l[i];
  }
  E* out = cluster.map_shared_rank(list, 0);
  int ties = static_cast<int>(pre & 0xffffffffull);
  int pos_below = static_cast<int>(pre >> 32);
  const unsigned before = (1u << lane) - 1;  // the lanes below this one
#pragma unroll 4
  for (int ib = i0; ib < i1; ib += 32) {  // uniform trip count: whole warps in the votes
    const int i = ib + lane;
    const bool in = i < i1;
    const K key = in ? key_at<kWide>(keys, i) : K(0);
    const bool below = in && key < t, tie = in && key == t;
    const unsigned b_below = __ballot_sync(kFull, below);
    const unsigned b_tie = __ballot_sync(kFull, tie);
    if (below) out[pos_below + __popc(b_below & before)] = make_entry<E>(key, j0 + i);
    const int r = ties + __popc(b_tie & before);  // ties before this one, in column order
    if (tie && r < need) out[n_below + r] = make_entry<E>(key, j0 + i);
    ties += __popc(b_tie);
    pos_below += __popc(b_below);
  }
}

// Step 3, where every block gathered its keys at or below t and the list
// holds all of the row's (below t and every tie): this block's gathered
// keys <= t go into the leader's list at places taken from its fill count
// (one remote atomic a warp step), in no order: the sort orders them, and
// puts the lower columns of the ties first.
template <bool kWide, typename S, typename K, typename E>
__device__ void place_gathered(cg::cluster_group& cluster, const S* keys,
                               const Index<kWide>* cand, int m, int j0, K t, E* list,
                               Shared<K>& sh) {
  const int lane = threadIdx.x & 31;
  int* fill = cluster.map_shared_rank(&sh.fill, 0);
  E* out = cluster.map_shared_rank(list, 0);
  const unsigned before = (1u << lane) - 1;  // the lanes below this one
  for (int i0 = 0; i0 < m; i0 += kThreads) {  // uniform trip count: whole warps in the votes
    const int i = i0 + threadIdx.x;
    const int j = i < m ? cand[i] : 0;
    const K key = i < m ? key_at<kWide>(keys, j) : K(0);
    const bool take = i < m && key <= t;
    const unsigned b = __ballot_sync(kFull, take);
    if (b == 0) continue;
    const int leader = __ffs(b) - 1;
    int at = 0;
    if (lane == leader) at = atomicAdd(fill, __popc(b));
    at = __shfl_sync(kFull, at, leader);
    if (take) out[at + __popc(b & before)] = make_entry<E>(key, j0 + j);
  }
}

template <typename E>
__device__ __forceinline__ void compare_exchange(E& a, E& b, bool ascending) {
  const bool swap = gt(a, b) == ascending;
  const E low = swap ? b : a;
  b = swap ? a : b;
  a = low;
}

// The bitonic steps of stage `size` with strides `top` down to 1 (top <
// kSpan) on a lane's entries x[e] = list[i0 + e], i0 = seg + lane * kE:
// strides of kE or more pair this lane with lane ^ (stride / kE) by a
// shuffle, strides 2 and 1 pair two of its own registers. Entry i goes
// ascending where bit `size` of i is clear; for size >= kE that bit is
// i0's for all of a lane's entries.
template <typename E>
__device__ __forceinline__ void warp_stages(E (&x)[kE], int i0, int size, int top) {
  const int lane = threadIdx.x & 31;
  const bool ascending = (i0 & size) == 0;
  for (int s = top; s >= kE; s >>= 1) {
    const int m = s / kE;
    const bool keep_min = ((lane & m) == 0) == ascending;  // the pair's lower entry here
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      const E y = shfl_xor(x[e], m);
      x[e] = gt(x[e], y) == keep_min ? y : x[e];
    }
  }
  if (top >= 2) {
    compare_exchange(x[0], x[2], ascending);
    compare_exchange(x[1], x[3], ascending);
  }
  const bool upper = size == 2 ? ((i0 + 2) & size) == 0 : ascending;  // entries 2 and 3
  compare_exchange(x[0], x[1], ascending);
  compare_exchange(x[2], x[3], upper);
}

// Step 4-5: sort list[0, L) (L a power of two >= kSpan) and write its first
// k entries to vals / pos. Each warp takes segments of kSpan entries: the
// stages up to kSpan run on them in registers; a later stage first runs
// its strides of kSpan or more on the whole list in shared memory, one
// block barrier each, then its smaller strides on the segments again. The
// last stage writes from registers.
template <typename T, typename E>
__device__ void sort_list(E* list, int L, int k, T* vals, int* pos) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr bool kPacked = std::is_same<E, unsigned long long>::value;  // two entries in 16 bytes
  auto segment = [&](int size, int top, bool first) {
    for (int seg = warp * kSpan; seg < L; seg += kWarps * kSpan) {
      const int i0 = seg + lane * kE;
      E x[kE];
      if constexpr (kPacked) {
        const ulonglong2* src = reinterpret_cast<const ulonglong2*>(list + i0);
        const ulonglong2 a = src[0], b = src[1];
        x[0] = a.x;
        x[1] = a.y;
        x[2] = b.x;
        x[3] = b.y;
      } else {
#pragma unroll
        for (int e = 0; e < kE; ++e) x[e] = list[i0 + e];
      }
      if (first) {
        for (int s = 2; s <= kSpan; s <<= 1) warp_stages(x, i0, s, s / 2);
      } else {
        warp_stages(x, i0, size, top);
      }
      if (size == L) {
#pragma unroll
        for (int e = 0; e < kE; ++e) {
          if (i0 + e < k) write_entry(x[e], vals + i0 + e, pos + i0 + e);
        }
      } else if constexpr (kPacked) {
        ulonglong2* dst = reinterpret_cast<ulonglong2*>(list + i0);
        dst[0] = make_ulonglong2(x[0], x[1]);
        dst[1] = make_ulonglong2(x[2], x[3]);
      } else {
#pragma unroll
        for (int e = 0; e < kE; ++e) list[i0 + e] = x[e];
      }
    }
  };
  segment(kSpan, kSpan / 2, true);
  for (int size = 2 * kSpan; size <= L; size <<= 1) {
    __syncthreads();
    for (int s = size / 2; s >= kSpan; s >>= 1) {
      for (int i = threadIdx.x; i < L / 2; i += kThreads) {
        const int a = 2 * i - (i & (s - 1));  // i with a zero bit inserted at `s`
        compare_exchange(list[a], list[a + s], (a & size) == 0);
      }
      __syncthreads();
    }
    segment(size, kSpan / 2, false);
  }
}

// One row per cluster of C blocks (C = 1 in the wide mode): block `rank`
// holds columns [rank * slice, (rank + 1) * slice) of row blockIdx.x / C.
template <typename T, bool kWide>
__global__ void __launch_bounds__(kThreads, Keys<T>::kMinBlocks)
knn_select_kernel(const T* __restrict__ d2, int w, int k, int slice, T* __restrict__ vals,
                  int* __restrict__ pos) {
  using S = typename Keys<T>::S;
  using K = typename Keys<T>::K;
  using U = typename Keys<T>::U;
  using E = typename Keys<T>::E;
  constexpr K kBigKey = Keys<T>::kBig;
  extern __shared__ int4 dyn[];
  __shared__ Shared<K> sh;
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const size_t row = blockIdx.x / csize;
  const int j0 = min(rank * slice, w), n = min(slice, w - j0);
  const S* src = reinterpret_cast<const S*>(d2) + row * w + j0;
  S* skeys = reinterpret_cast<S*>(dyn);  // [slice] (shared mode)
  const S* keys = kWide ? src : skeys;
  const int L = list_len(k);
  E* list = reinterpret_cast<E*>(skeys + (kWide ? 0 : round_up(slice, key_align<S>())));  // [L]
  // [gather_cap(k)]: the gathered indices
  Index<kWide>* spare = reinterpret_cast<Index<kWide>*>(list + L);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // ---- 1. load the slice; body min / max / count over the row ------------
  for (int b = tid; b < 2 * kBins; b += kThreads) (&sh.hist[0][0])[b] = 0;
  if (tid == 0) sh.fill = 0;
  K mn = Keys<T>::kMax, mx = Keys<T>::kMin;
  unsigned nb = 0;
  auto see = [&](K key) {
    if (key < kBigKey) {
      mn = min(mn, key);
      mx = max(mx, key);
      ++nb;
    }
  };
  const bool aligned =
      n % key_align<S>() == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0;
  if constexpr (kWide) {
    // the keys stay in device memory; the later walks read the row again
    if (aligned) {
      if constexpr (sizeof(S) == 2) {  // eight 16-bit keys a load
        const int4* s4 = reinterpret_cast<const int4*>(src);
#pragma unroll 4
        for (int q = tid; q < n / 8; q += kThreads) {
          const int4 v = __ldg(s4 + q);
          const int words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int h = 0; h < 4; ++h) {
            see(static_cast<short>(words[h] & 0xffff));
            see(static_cast<short>(words[h] >> 16));
          }
        }
      } else if constexpr (sizeof(S) == 4) {
        const int4* s4 = reinterpret_cast<const int4*>(src);
#pragma unroll 4
        for (int q = tid; q < n / 4; q += kThreads) {
          const int4 v = __ldg(s4 + q);
          see(v.x);
          see(v.y);
          see(v.z);
          see(v.w);
        }
      } else {
        const longlong2* s2 = reinterpret_cast<const longlong2*>(src);
#pragma unroll 4
        for (int q = tid; q < n / 2; q += kThreads) {
          const longlong2 v = __ldg(s2 + q);
          see(v.x);
          see(v.y);
        }
      }
    } else {
      for (int j = tid; j < n; j += kThreads) see(__ldg(src + j));
    }
  } else {
    if (aligned && n > 0) {
      const uint32_t bar = smem_addr(&sh.bar);
      if (tid == 0) {
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar) : "memory");
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      }
      __syncthreads();
      if (tid == 0) {
        bulk_load(smem_addr(skeys), src, static_cast<uint32_t>(n) * sizeof(S), bar);
      }
      mbar_wait(bar, 0);
    } else {
      for (int j = tid; j < n; j += kThreads) skeys[j] = __ldcs(src + j);
      __syncthreads();
    }
    for (int j = tid; j < n; j += kThreads) see(skeys[j]);
  }
  mn = warp_min(mn);
  mx = warp_max(mx);
  nb = __reduce_add_sync(kFull, nb);
  if (lane == 0) {
    sh.rmin[warp] = mn;
    sh.rmax[warp] = mx;
    sh.rcnt[warp] = static_cast<int>(nb);
  }
  __syncthreads();
  if (tid == 0) {
    K lo = Keys<T>::kMax, hi = Keys<T>::kMin;
    int cnt = 0;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) {
      lo = min(lo, sh.rmin[i]);
      hi = max(hi, sh.rmax[i]);
      cnt += sh.rcnt[i];
    }
    sh.stat[0] = lo;
    sh.stat[1] = hi;
    sh.stat[2] = cnt;
  }
  // every slice's statistics are published (and the histograms cleared)
  cluster.sync();
  // lane q of each warp reads rank q's statistics; the warp reduces them
  K body_lo = Keys<T>::kMax, body_hi = Keys<T>::kMin;
  int n_body = 0;
  if (lane < csize) {
    const K* st = cluster.map_shared_rank(sh.stat, lane);
    body_lo = st[0];
    body_hi = st[1];
    n_body = static_cast<int>(st[2]);
  }
  body_lo = warp_min(body_lo);
  body_hi = warp_max(body_hi);
  n_body = __reduce_add_sync(kFull, n_body);
  int parity = 0;
  const int cap = gather_cap<kWide>(k);

  // ---- 2. t = the row's k-th smallest key, and count(keys < t) -----------
  Found<K> f;
  if (k <= n_body) {
    f = select_rank<T, kWide>(cluster, csize, keys, n, body_lo,
                              static_cast<U>(body_hi) - static_cast<U>(body_lo), k, 0, sh, parity,
                              spare, cap);
  } else {  // k reaches past the body into the finfo.max (or larger) keys
    f = select_rank<T, kWide>(cluster, csize, keys, n, kBigKey,
                              static_cast<U>(Keys<T>::kMax) - static_cast<U>(kBigKey), k - n_body,
                              n_body, sh, parity, spare, cap);
  }

  // ---- 3. the list: every entry below t, then the ties --------------------
  int filled = k;
  if (f.gathered && f.below + f.ties <= L) {
    // all of the row's ties fit beside the entries below t: no tie cut
    place_gathered<kWide>(cluster, keys, spare, f.n, j0, f.t, list, sh);
    filled = f.below + f.ties;
  } else {
    // the first k - count(< t) ties in column order, by two walks
    compact<kWide>(cluster, rank, keys, n, j0, f.t, f.below, k - f.below, list, sh);
  }
  if (rank == 0) {
    for (int i = filled + tid; i < L; i += kThreads) set_pad(list[i]);
  }
  // every entry has landed in the leader's list; the others are done
  cluster.sync();
  if (rank != 0) return;

  // ---- 4-5. sort the list, write ---------------------------------------
  sort_list(list, L, k, vals + row * k, pos + row * k);
}

// Dynamic shared memory of one shared-mode block: its slice's keys, the
// list and the gather buffer.
template <typename T>
size_t shared_smem_bytes(int slice, int k) {
  using S = typename Keys<T>::S;
  return static_cast<size_t>(round_up(slice, key_align<S>())) * sizeof(S) +
         static_cast<size_t>(list_len(k)) * sizeof(typename Keys<T>::E) +
         static_cast<size_t>(gather_cap<false>(k)) * sizeof(Index<false>);
}

// Dynamic shared memory of one wide-mode block: the list and the gather
// buffer.
template <typename T>
size_t wide_smem_bytes(int k) {
  return static_cast<size_t>(list_len(k)) * sizeof(typename Keys<T>::E) +
         static_cast<size_t>(gather_cap<true>(k)) * sizeof(Index<true>);
}

// the cluster size of rows of w columns: the least power of two that keeps
// a slice within kSliceTarget columns, at most kMaxCluster
int default_cluster(int w) {
  int c = 1;
  while (c < kMaxCluster && (w + c - 1) / c > kSliceTarget) c <<= 1;
  return c;
}

// the columns a block holds over a cluster of c: multiples of 4 (16 bytes
// of float32; 8 of bf16) where c > 1, so each block's slice starts 16-byte
// aligned in an aligned row
template <typename T>
int slice_of(int w, int c) {
  return c == 1 ? w : round_up((w + c - 1) / c, key_align<typename Keys<T>::S>());
}

template <typename T, bool kWide>
cudaError_t configure(size_t smem) {
  static bool carveout_set = false;
  if (!carveout_set) {
    // shared memory before L1: the blocks per SM are bound by shared memory
    const cudaError_t err = cudaFuncSetAttribute(
        knn_select_kernel<T, kWide>, cudaFuncAttributePreferredSharedMemoryCarveout,
        cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    carveout_set = true;
  }
  // the dynamic shared memory a launch may take, raised (never lowered) to
  // this launch's: the default, 48 KB less the static shared memory, is
  // below some shapes' (a wide block at k = 4,096 takes exactly 48 KB)
  static size_t allowed = 0;
  if (smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        knn_select_kernel<T, kWide>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    allowed = smem;
  }
  return cudaSuccess;
}

// The launch of n rows in `mode` over clusters of c blocks (1 in the wide
// mode), its slice and its shared memory.
struct Plan {
  int c, slice;
  size_t smem;
};

template <typename T>
Plan plan_of(int mode, int w, int k) {
  if (mode == 1) return {1, w, wide_smem_bytes<T>(k)};
  const int c = default_cluster(w);
  const int slice = slice_of<T>(w, c);
  return {c, slice, shared_smem_bytes<T>(slice, k)};
}

cudaLaunchConfig_t launch_config(int n, const Plan& p, cudaStream_t s, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(n) * p.c);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = s;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = p.c;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Clusters of this plan the card holds at once (0: none can be scheduled).
template <typename T, bool kWide>
cudaError_t max_clusters(const Plan& p, int* clusters) {
  cudaError_t err = configure<T, kWide>(p.smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(1, p, nullptr, &attr);
  return cudaOccupancyMaxActiveClusters(clusters, knn_select_kernel<T, kWide>, &cfg);
}

// The arguments every launch checks: a mode and rows of w columns it can
// take at this k (the shared mode only over clusters of up to kMaxShared
// blocks).
template <typename T>
bool valid_shape(int w, int k, int mode) {
  return w > 0 && w <= max_cols<T>() && k >= 1 && k <= w && k <= Keys<T>::kMaxK &&
         (mode == 1 || (mode == 0 && default_cluster(w) <= Keys<T>::kMaxShared));
}

// Whether `p` (in mode 0 or 1) fits a block's shared memory on a card that
// lets a block opt in to `optin` bytes and can be scheduled.
template <typename T, bool kWide>
cudaError_t fits(const Plan& p, size_t optin, bool* ok) {
  *ok = false;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, knn_select_kernel<T, kWide>);
  if (err != cudaSuccess || p.smem + attr.sharedSizeBytes > optin) return err;
  int clusters = 0;
  if ((err = max_clusters<T, kWide>(p, &clusters)) != cudaSuccess) return err;
  *ok = clusters > 0;
  return cudaSuccess;
}

template <typename T>
int select_mode(int device, int w, int k, int* mode, int* cluster) {
  *mode = -1;
  *cluster = 0;
  if (!valid_shape<T>(w, k, 1)) return cudaSuccess;
  int optin = 0;
  cudaError_t err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  bool ok = false;
  const Plan shared = plan_of<T>(0, w, k);
  if (valid_shape<T>(w, k, 0) &&
      (err = fits<T, false>(shared, static_cast<size_t>(optin), &ok)) != cudaSuccess) {
    return err;
  }
  if (ok) {
    *mode = 0;
    *cluster = shared.c;
    return cudaSuccess;
  }
  if ((err = fits<T, true>(plan_of<T>(1, w, k), static_cast<size_t>(optin), &ok)) != cudaSuccess) {
    return err;
  }
  if (ok) {
    *mode = 1;
    *cluster = 1;
  }
  return cudaSuccess;
}

template <typename T>
int select_info(int device, int mode, int w, int k, int* out) {
  if (!valid_shape<T>(w, k, mode)) return cudaErrorInvalidValue;
  const Plan p = plan_of<T>(mode, w, k);
  int optin = 0;
  cudaError_t err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  int blocks = 0, clusters = 0;
  if (mode == 0) {
    if ((err = cudaFuncGetAttributes(&attr, knn_select_kernel<T, false>)) != cudaSuccess) return err;
    if (p.smem + attr.sharedSizeBytes <= static_cast<size_t>(optin)) {
      if ((err = max_clusters<T, false>(p, &clusters)) != cudaSuccess) return err;
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, knn_select_kernel<T, false>,
                                                          kThreads, p.smem);
    }
  } else {
    if ((err = cudaFuncGetAttributes(&attr, knn_select_kernel<T, true>)) != cudaSuccess) return err;
    if (p.smem + attr.sharedSizeBytes <= static_cast<size_t>(optin)) {
      if ((err = max_clusters<T, true>(p, &clusters)) != cudaSuccess) return err;
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, knn_select_kernel<T, true>,
                                                          kThreads, p.smem);
    }
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = kThreads;
  out[1] = static_cast<int>(p.smem);
  out[2] = static_cast<int>(attr.sharedSizeBytes);
  out[3] = blocks;
  out[4] = attr.numRegs;
  out[5] = static_cast<int>(attr.localSizeBytes);
  out[6] = p.c;
  out[7] = clusters;
  out[8] = p.slice;
  return cudaSuccess;
}

template <typename T>
int select_launch(const void* d2, int n, int w, int k, int mode, void* vals, void* pos,
                  void* stream) {
  if (n <= 0) return cudaSuccess;
  if (!valid_shape<T>(w, k, mode)) return cudaErrorInvalidValue;
  const Plan p = plan_of<T>(mode, w, k);
  if (static_cast<long long>(n) * p.c > INT_MAX) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr;
  cudaError_t err;
  const T* in = static_cast<const T*>(d2);
  T* v = static_cast<T*>(vals);
  int* ix = static_cast<int*>(pos);
  if (mode == 0) {
    if ((err = configure<T, false>(p.smem)) != cudaSuccess) return err;
    const cudaLaunchConfig_t cfg = launch_config(n, p, s, &attr);
    err = cudaLaunchKernelEx(&cfg, knn_select_kernel<T, false>, in, w, k, p.slice, v, ix);
  } else {
    if ((err = configure<T, true>(p.smem)) != cudaSuccess) return err;
    const cudaLaunchConfig_t cfg = launch_config(n, p, s, &attr);
    err = cudaLaunchKernelEx(&cfg, knn_select_kernel<T, true>, in, w, k, p.slice, v, ix);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The mode that takes rows of w columns at this k on `device` and its
// cluster size: 0 (shared: a cluster of `cluster` blocks a row, each block
// its slice of the keys in shared memory) whenever that fits and can be
// scheduled, else 1 (wide: the keys stay in device memory, cluster 1)
// where that fits, else -1. Returns the first cudaError_t.
int knn_select_mode(int device, int w, int k, int* mode, int* cluster) {
  return select_mode<float>(device, w, k, mode, cluster);
}

// Launch shape of `mode` (0: shared, over the cluster size W picks; 1:
// wide) for rows of w columns at this k on `device`: threads, dynamic and static
// shared memory per block, resident blocks per SM, registers a thread,
// local (spill) bytes a thread, blocks a cluster, clusters the card holds
// at once (0, and no blocks per SM, where the blocks' shared memory does
// not fit) and columns a block. Returns the first cudaError_t.
int knn_select_info(int device, int mode, int w, int k, int* out) {
  return select_info<float>(device, mode, w, k, out);
}

// Launch `mode` (from knn_select_mode; the shared mode over the cluster
// size W picks) on `stream` without synchronising: d2 [n, w] float32
// row-major in, vals [n, k] float32 and pos [n, k] int32 out. Returns the
// first cudaError_t.
int knn_select_launch(const void* d2, int n, int w, int k, int mode, void* vals, void* pos,
                      void* stream) {
  return select_launch<float>(d2, n, w, k, mode, vals, pos, stream);
}

// The float64 form of the three above: d2 [n, w] and vals [n, k] float64,
// k <= 8,192, the shared mode at w <= 8,192 only (one block a row).
int knn_select_mode_f64(int device, int w, int k, int* mode, int* cluster) {
  return select_mode<double>(device, w, k, mode, cluster);
}

int knn_select_info_f64(int device, int mode, int w, int k, int* out) {
  return select_info<double>(device, mode, w, k, out);
}

int knn_select_launch_f64(const void* d2, int n, int w, int k, int mode, void* vals, void* pos,
                          void* stream) {
  return select_launch<double>(d2, n, w, k, mode, vals, pos, stream);
}

// The bfloat16 form of the three above: d2 [n, w] and vals [n, k] bf16,
// w <= 131,072, k <= 16,384; modes and cluster sizes as float32's.
int knn_select_mode_bf16(int device, int w, int k, int* mode, int* cluster) {
  return select_mode<__nv_bfloat16>(device, w, k, mode, cluster);
}

int knn_select_info_bf16(int device, int mode, int w, int k, int* out) {
  return select_info<__nv_bfloat16>(device, mode, w, k, out);
}

int knn_select_launch_bf16(const void* d2, int n, int w, int k, int mode, void* vals, void* pos,
                           void* stream) {
  return select_launch<__nv_bfloat16>(d2, n, w, k, mode, vals, pos, stream);
}

const char* knn_select_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
