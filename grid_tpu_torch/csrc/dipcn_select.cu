// Threshold dipCN straight from the [N, W] squared-distance matrix: for each
// row, the k nearest columns (ties to the lower column), then the first
// n_nbr usable columns among them, then dipcn = rnorm / mean(nbr_w over
// those), ok = valid & (m_eff > 0). It selects exactly the set of
// grid_tpu_torch/ops/select.py:dipcn_from_distances (the same int32 key
// order, ties to the lower column).
//
// Replaces grid_tpu/ops/pallas_select.py:dipcn_from_distances_pallas
// (line 111; _dipcn_kernel, pallas_call at line 130).
//
// Bound on the H100: d2 read once, 25.1 MB at N=2504 (4·N² bytes plus the
// N- and W-long vectors), 7.5 µs at 3.35 TB/s; the selection's arithmetic is
// far below the card's integer rate.
//
// What held the first kernel back: one 256-thread block per row ran ~90
// serial block-wide rounds, each a compare-and-count over the whole row
// ending in two barriers: two 31-round bisections over the whole int32 key
// range, two 12-round column tie-cut bisections (run even when one key sat
// at the threshold) and four counting passes. That is ~180 barriers and
// ~0.5 G shared-memory reads per call, in ~3 waves of blocks.
//
// What this design does about it (one 128-thread block per row):
//
// 1. Load. The row's keys come into shared memory once (16-byte loads when
//    the row is 16-byte aligned, else 4-byte ones), with the usable mask as
//    ballot bits. The same pass takes the block min, max and count of the
//    "body" keys: those below finfo(float32).max, which self and invalid-row
//    columns carry and which would otherwise stretch the key range to 31
//    bits. One round.
// 2. k-th key by histogram from the row's own range. A radix select on
//    key - min over [min, max of the body] (on this cohort ~22 bits, where
//    the top byte of the raw key puts ~2,501 of 2,504 keys in one bin) in
//    8-bit digits: each round counts the keys still in play into a 256-bin
//    shared histogram and one block scan over the bins finds the digit and
//    the count below it. A warp whose keys in play all share one digit (a
//    hot bin) adds them with one atomic; otherwise each key adds its own
//    (warp-aggregating every increment with __match_any_sync was slower:
//    here a warp's digits are mostly distinct). After the first round the few keys left in play
//    (~20 here) are gathered into the list buffer, so the later rounds walk
//    only them. When k reaches past the body, the same select runs over
//    [finfo.max key, INT_MAX]. Yields t and count(keys < t) with no extra
//    pass: 3 histogram rounds and one gather here.
// 3. Tie cut and compaction in one scan. Each thread owns a contiguous
//    chunk of columns (an odd stride, so the chunk walks are free of bank
//    conflicts). One block exclusive scan of (keys == t, usable & < t,
//    usable & == t) per chunk gives every column its tie rank and its
//    place: the usable members below t, then the usable ties of rank <=
//    need, go in column order into a uint16 list of at most k columns. The
//    thread that holds the need-th tie publishes the list length. One round.
// 4. Second selection on the list only (<= k entries instead of W): the
//    m_eff-th key over [row min, t] by the same histogram rounds (3 here),
//    skipped when m_eff is the whole list. Ties at t2 all come from one of
//    the list's two column-ordered halves, so list order is column order
//    among them.
// 5. One scan of the ties at t2 over list chunks, then one block sum of
//    nbr_w over the take-set in a fixed order (deterministic). Two rounds.
//
// Serial block-wide rounds per row at N=2504, k=500, n_nbr=300: 1 + (3 + 1)
// + 1 + 3 + 2 = 11 (a histogram round is a counting pass and a bin scan,
// three barriers), down from ~90. Shared memory per block: 4·W (keys) + W/8
// (usable bits) + 2·min(k, W) (list) + 2 KB (two histograms, one cleared
// while the other counts): 13.5 KB at N=2504. 40 registers a thread give 12
// blocks per SM (1,584 rows in flight of 2,504); a 32-register bound gives
// 16 but ran no faster in a trial, so its instructions and barriers bound
// it, not its waves. dipcn_select_info reports the count the card grants.
//
// Two modes, one kernel template; dipcn_select_mode picks one from W, k
// and the blocks an SM the card grants the resident mode:
//
// - resident (above): the row's keys in shared memory, a uint16 list. It
//   fits whenever dyn_smem_bytes(W, k) fits and W <= 65,536 (up to
//   ~37,000 float32 columns at k = W, ~55,000 at k = 500), and runs where
//   at least kResidentMinBlocks of its blocks fit an SM: a block walks its
//   row in serial rounds, and with fewer blocks an SM too few rows are in
//   flight to hide them, so the wide mode, at 11-12 blocks an SM, is the
//   faster (both modes timed on the same rows in float32, float64 and
//   bfloat16 by chip_smoke.py; PERF.md). Float32 keeps the resident mode
//   up to ~12,000 columns at k=500, float64 to ~6,000, bf16 to ~24,000.
// - wide: for the row panels of the large-N branch (65,536 columns at
//   N=65,536) and up to ~1.7 M columns. The keys stay in device memory and
//   every walk re-reads the row; shared memory holds the usable bits (W/8
//   bytes), the int32 list (column indices past 65,535) and the gather
//   buffer (at least kWideGather entries, so a first digit that leaves up
//   to 2,048 keys in play is gathered). Step 3 becomes two walks by warps:
//   each warp owns a contiguous quarter of the row and steps through it 32
//   columns at a time (coalesced), counting first, then placing each
//   column by ballot ranks. The sets, their tie order and the fixed-order
//   sum of steps 4-5 are those of the resident mode.
//
//   What bounds the wide mode: the row is read once by the load (step 1),
//   once per histogram round until the keys in play fit the gather buffer
//   (at least one), once by the gather, and twice by step 3: at least 5
//   walks of 4*W bytes. A 512 x 65,536 panel is 128 MB, more than the 50
//   MB L2, so every walk comes from device memory: >= 640 MB per panel
//   against the 128 MB the one-read bound counts, i.e. >= 24.5 ms per step
//   of 128 panels at 3.35 TB/s against 5.1 ms. 512 rows are one wave (11
//   blocks per SM hold 1,452), so the walks of all rows stream together
//   and none finds its row in L2. Measured on an H100 80GB HBM3 at 700 W
//   (chip_smoke.py, phase 7): 0.61 ms per panel, about 1 TB/s if the walks
//   move 640 MB, so they are bound by the loads a block keeps in flight,
//   not by the memory's rate: 512 blocks of 4 warps are ~16 warps per SM,
//   and each walk step waits on its loads.
//
// The multi-weight form (kMulti; dipcn_select_multi_launch) takes L loci's
// weights on the same distances, as the multi-locus sweep needs: rnorm and
// valid [N, L], nbr_w [W, L], dipcn and ok [N, L]. Steps 1-4 are those of
// the binary form: the take-set is locus-independent. Step 5 becomes:
//
// 5m. Compaction: rounds of 128 list entries; one block scan per round of
//    (key == t2, key < t2) gives every entry its tie rank and the count of
//    taken entries before it, and each taken entry moves to that place in
//    the same list. An entry never moves up (its place is at most its
//    index) and a round's reads finish at the scan's barrier, so the list
//    compacts in place and keeps its order. Then threads stride over the L
//    loci and sum nbr_w[col * L + l] over the m_eff listed columns in list
//    order: a fixed order (deterministic), and each read of W's row col is
//    one coalesced line across the block's threads. Each thread's sum is
//    serial, so it adds in float64 (its error then stays far below one
//    float32 rounding; the FP64 adds cost nothing beside the loads), where
//    the binary form adds in float32 along a tree. dipcn = rnorm / (sum /
//    max(m_eff, 1)) and ok = valid & (m_eff > 0), per (row, l).
//
//    The sums read at most n_nbr rows of W per sample (N * n_nbr * L * 4
//    bytes, 1.48 GB at N=2504, n_nbr=300, L=492, mostly from L2) instead of
//    the [N, N] @ [N, L] product of the take mask (2 N^2 L operations, in
//    FP32 because the weights need float32 accuracy). The binary form's
//    code is not shared, so its outputs stay bitwise as they were.
//
// The float64 forms (the *_f64 entry points; binary and multi-weight, both
// modes) run the same kernel on float64 d2, rnorm and nbr_w: its keys are
// the doubles' bits as int64 (grid_tpu/ops/select.py:35-40 takes int64
// keys for float64), finfo(float64).max marks self and invalid rows, the
// radix selections take up to 8 digits, and step 5 sums in float64. In the
// multi-weight form steps 1-4 are the float64 binary form's, and step 5m
// compacts the same uint16 or int32 lists and reads float64 rows of W [W, L]:
// its float64 sum is the float32 form's, and the quotient is taken in
// float64 (the multi-locus sweep at device.dtype float64; its JAX twin,
// grid_tpu/ops/select.py:291 dipcn_from_distances_multi, computes in the
// distances' dtype). Bound by bytes as the float32 form, at 8 bytes a
// value: d2, rnorm, nbr_w and dipcn twice the bytes. The resident mode
// holds 8 W bytes of keys, so its edge falls to ~26,000 columns at k=500
// (20 KB a row at N=2504) in both forms; the 65,536-column panels take the
// wide mode, as in float32. The float32 forms' code is the same text
// instantiated at int keys, so their results are those they gave before.
//
// The bfloat16 binary form (the *_bf16 entry points, both modes) takes bf16
// d2, rnorm and nbr_w, as grid_tpu's step under device.dtype: bfloat16 does
// (grid_tpu/ops/select.py:dipcn_from_distances, int16 keys at :39). The row
// is stored as its 16-bit patterns (the resident mode's keys take 2 W
// bytes) and each key is widened to int as it is read, so steps 1-5 run the
// float32 form's code on 15-bit keys: finfo(bf16).max (0x7F7F) marks self
// and invalid rows, and each radix selection takes two 8-bit digits. The
// sum rounds where grid_tpu's does (select.py:203-206): the weights are
// bf16, the sum is kept in float32 and rounded to bf16 once, m_eff is
// rounded to bf16, and the mean and the quotient are each rounded. Bound
// at N=2504: 2 N^2 bytes of d2 and the vectors, 12.6 MB, 3.8 us at 3.35
// TB/s. The multi-weight form has no bf16 form: the multi-locus sweep's
// batched dipCN reads the written matrix in float32 (grid_tpu's reads it in
// float64), whatever device.dtype says.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kDigitBits = 8;
constexpr int kBins = 1 << kDigitBits;   // == 2 * kThreads: two bins per thread in the scan
constexpr int kField = 21;               // bit width of one count in the packed k-set scan
constexpr unsigned long long kFieldMask = (1ull << kField) - 1;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kResidentMaxCols = 65536;  // uint16 list entries
constexpr int kWideGather = 2048;        // least gather capacity of the wide mode
constexpr int kWideMaxCols = 1 << kField;  // packed counts hold up to 2^21 - 1
constexpr int kResidentMinBlocks = 4;      // the resident mode's least blocks an SM

// The keys of a value type: non-negative floats order as their bit
// patterns read as signed integers of the same width; kBig is finfo.max,
// the self and invalid-row columns.
template <typename T>
struct Keys;

template <>
struct Keys<float> {
  using S = int;    // a key as the row stores it
  using K = int;    // as the kernel computes with it
  using A = float;  // the binary form's sum
  using U = unsigned;
  static constexpr K kBig = 0x7F7FFFFF;
  static constexpr K kMin = INT_MIN, kMax = INT_MAX;
  static constexpr int kMinBlocks = 12;  // launch bounds: <= 40 registers a thread
};

template <>
struct Keys<double> {
  using S = long long;
  using K = long long;
  using A = double;
  using U = unsigned long long;
  static constexpr K kBig = 0x7FEFFFFFFFFFFFFFLL;
  static constexpr K kMin = LLONG_MIN, kMax = LLONG_MAX;
  static constexpr int kMinBlocks = 8;  // <= 64 registers a thread: 64-bit keys take two
};

template <>
struct Keys<__nv_bfloat16> {
  using S = short;  // the 16-bit pattern; non-negative bf16 read 0 .. 0x7FFF
  using K = int;
  using A = float;
  using U = unsigned;
  static constexpr K kBig = 0x7F7F;
  static constexpr K kMin = INT_MIN, kMax = 0x7FFF;
  static constexpr int kMinBlocks = 12;
};

template <typename T>
constexpr bool kHasMulti = !std::is_same<T, __nv_bfloat16>::value;

// keys a 16-byte line holds, at least 4: the resident keys end 16-byte
// aligned after round_up(w, key_align) keys, and a row of a multiple of it
// takes the 16-byte loads
template <typename S>
__host__ __device__ constexpr int key_align() {
  return 16 / static_cast<int>(sizeof(S)) > 4 ? 16 / static_cast<int>(sizeof(S)) : 4;
}

// a weight as the binary form sums it
__device__ __forceinline__ float to_acc(float v) { return v; }
__device__ __forceinline__ double to_acc(double v) { return v; }
__device__ __forceinline__ float to_acc(__nv_bfloat16 v) { return __bfloat162float(v); }

// dipcn = rnorm / (total / max(m_eff, 1)), in T; in bf16 as grid_tpu rounds
// it: the float32 total rounded once, m_eff rounded, the mean and the
// quotient each rounded
template <typename T>
__device__ __forceinline__ T finish(typename Keys<T>::A total, int m_eff, T rnorm) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const float tot = __bfloat162float(__float2bfloat16_rn(total));
    const float denom = __bfloat162float(__int2bfloat16_rn(max(m_eff, 1)));
    const float mean = __bfloat162float(__float2bfloat16_rn(tot / denom));
    return __float2bfloat16_rn(__bfloat162float(rnorm) / mean);
  } else {
    const T nbr_mean = total / static_cast<T>(max(m_eff, 1));
    return rnorm / nbr_mean;
  }
}

// a stored key, widened to the type the kernel computes in (int for the
// 16-bit keys of bf16)
template <typename S>
using Wide = typename std::conditional<sizeof(S) == 2, int, S>::type;

// the row's keys: shared memory (resident mode) or device memory (wide)
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

static_assert(kBins == 2 * kThreads, "the bin scan gives each thread two bins");

template <typename T>
struct Shared {
  using K = typename Keys<T>::K;
  int hist[2][kBins];  // one histogram counts while the other is cleared
  int wtot[kWarps];    // int scan scratch
  unsigned long long wtot_l[kWarps];  // packed-count scan scratch
  K rmin[kWarps], rmax[kWarps];
  int rcnt[kWarps];
  typename Keys<T>::A fsum[kWarps];
  int bin, bin_below, bin_count;  // the select round's digit, keys below it and in it
  int n_cand;
  int list_len;
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

template <typename K>
struct Found {
  K t;        // the rank-th smallest key in range
  int below;  // keys in range that are < t
};

// The rank-th smallest (1 <= rank <= keys in range) of the keys in
// [lo, lo + span], by radix select on key - lo in 8-bit digits from the
// top of span. The keys are keys[list[i]], i < n, or keys[i] when list is
// null; then, once a round leaves at most `cap` keys in play, they are
// gathered into `spare` and the later rounds walk only them. hist[parity]
// is all zero on entry and on return.
template <typename T, bool kWide, typename ListT>
__device__ Found<typename Keys<T>::K> select_rank(const typename Keys<T>::S* keys,
                                                  const ListT* list, int n,
                                                  typename Keys<T>::K lo, typename Keys<T>::U span,
                                                  int rank, Shared<T>& sh, int& parity,
                                                  ListT* spare, int cap) {
  using K = typename Keys<T>::K;
  using U = typename Keys<T>::U;
  const int lane = threadIdx.x & 31;
  int bits = span ? bit_width(span) : 0;
  U base = 0;  // key - lo of the bin chosen so far
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
    if constexpr (kWide) {
      auto count = [&](K key, bool in) {  // the resident loop's body, below
        const U v = static_cast<U>(key) - static_cast<U>(lo);
        const U digit = (v - base) >> shift;
        in = in && key >= lo && v <= span && digit < (1u << d);
        const unsigned play = __ballot_sync(kFull, in);
        if (play == 0) return;
        const int leader = __ffs(play) - 1;
        const U lead_digit = __shfl_sync(kFull, digit, leader);
        if (__all_sync(kFull, !in || digit == lead_digit)) {
          if (lane == leader) atomicAdd(&h[digit], __popc(play));
        } else if (in) {
          atomicAdd(&h[digit], 1);
        }
      };
      // keys from device memory: four loads in flight before the votes
      constexpr int kAhead = 4;
      for (int i0 = 0; i0 < n; i0 += kAhead * kThreads) {  // uniform trip count
        K ks[kAhead];
#pragma unroll
        for (int a = 0; a < kAhead; ++a) {
          const int i = i0 + a * kThreads + threadIdx.x;
          ks[a] = i < n ? key_at<kWide>(keys, list ? list[i] : i) : K(0);
        }
#pragma unroll
        for (int a = 0; a < kAhead; ++a) count(ks[a], i0 + a * kThreads + threadIdx.x < n);
      }
    } else {
      // kept apart from the wide mode's loop: the lambda form of this loop
      // ran ~4% slower in the resident mode on the H100
      for (int i0 = 0; i0 < n; i0 += kThreads) {  // uniform trip count: whole warps in the votes
        const int i = i0 + threadIdx.x;
        bool in = i < n;
        const K key = in ? (list ? keys[list[i]] : keys[i]) : K(0);
        const U v = static_cast<U>(key) - static_cast<U>(lo);
        const U digit = (v - base) >> shift;  // huge when v < base
        in = in && key >= lo && v <= span && digit < (1u << d);
        // a warp whose keys in play share one digit (a hot bin) adds them
        // in one atomic; otherwise each key adds its own
        const unsigned play = __ballot_sync(kFull, in);
        if (play == 0) continue;
        const int leader = __ffs(play) - 1;
        const U lead_digit = __shfl_sync(kFull, digit, leader);
        if (__all_sync(kFull, !in || digit == lead_digit)) {
          if (lane == leader) atomicAdd(&h[digit], __popc(play));
        } else if (in) {
          atomicAdd(&h[digit], 1);
        }
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
    base += static_cast<U>(sh.bin) << shift;
    below += sh.bin_below;
    bits = shift;
    parity ^= 1;
    if (list == nullptr && bits > 0 && sh.bin_count <= cap) {
      // gather the keys still in play; the later rounds walk only them
      for (int i = threadIdx.x; i < n; i += kThreads) {
        const K key = key_at<kWide>(keys, i);
        const U v = static_cast<U>(key) - static_cast<U>(lo);
        if (key >= lo && v <= span && ((v - base) >> bits) == 0) {
          spare[atomicAdd(&sh.n_cand, 1)] = static_cast<ListT>(i);
        }
      }
      n = sh.bin_count;
      list = spare;
      __syncthreads();
    }
  }
  return {static_cast<K>(static_cast<U>(lo) + base), below};
}

__device__ __forceinline__ bool usable_at(const unsigned* ubits, int j) {
  return (ubits[j >> 5] >> (j & 31)) & 1u;
}

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Step 3 of the wide mode (see the resident mode's in the kernel): the tie
// cut and the compaction of the usable k-set in column order, as two walks
// of the row by warps. Warp w owns columns [w*q, (w+1)*q), q a multiple of
// 32, and steps through them 32 at a time: the first walk counts (ties,
// usable below t, usable ties) per warp; the second places each column at
// its warp's prefix plus its ballot rank among the step's lanes.
template <typename T, typename S, typename K>
__device__ void tie_cut_walks(const S* keys, const unsigned* ubits, int w, K t, int need,
                              int* list, Shared<T>& sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q = round_up((w + kWarps - 1) / kWarps, 32);
  const int j0 = min(warp * q, w), j1 = min(j0 + q, w);
  unsigned long long cnt = 0;  // ties | usable below t << 21 | usable ties << 42
#pragma unroll 4
  for (int j = j0 + lane; j < j1; j += 32) {
    const K key = __ldg(keys + j);
    const unsigned long long u = usable_at(ubits, j);
    cnt += key == t ? 1ull + (u << (2 * kField)) : (key < t ? u << kField : 0ull);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) cnt += __shfl_xor_sync(kFull, cnt, o);
  if (lane == 0) sh.wtot_l[warp] = cnt;
  __syncthreads();
  unsigned long long pre = 0, tot = 0;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) {
    const unsigned long long c = sh.wtot_l[i];
    if (i < warp) pre += c;
    tot += c;
  }
  const int n_below_usable = static_cast<int>((tot >> kField) & kFieldMask);
  int ties = static_cast<int>(pre & kFieldMask);
  int pos_below = static_cast<int>((pre >> kField) & kFieldMask);
  int pos_tie = n_below_usable + static_cast<int>((pre >> (2 * kField)) & kFieldMask);
  const unsigned before = (1u << lane) - 1;  // the lanes below this one
#pragma unroll 4
  for (int jb = j0; jb < j1; jb += 32) {  // uniform trip count: whole warps in the votes
    const int j = jb + lane;
    const bool in = j < j1;
    const K key = in ? __ldg(keys + j) : K(0);
    const bool u = in && usable_at(ubits, j);
    const bool tie = in && key == t;
    const unsigned b_tie = __ballot_sync(kFull, tie);
    const int rank = ties + __popc(b_tie & before) + 1;  // among all ties, in column order
    const bool take_tie = tie && rank <= need;
    const bool below_u = in && key < t && u;
    const unsigned b_below = __ballot_sync(kFull, below_u);
    const unsigned b_take = __ballot_sync(kFull, take_tie && u);
    if (below_u) list[pos_below + __popc(b_below & before)] = j;
    const int at = pos_tie + __popc(b_take & before);
    if (take_tie && u) list[at] = j;
    if (take_tie && rank == need) sh.list_len = at + (u ? 1 : 0);
    ties += __popc(b_tie);
    pos_below += __popc(b_below);
    pos_tie += __popc(b_take);
  }
}

// Dynamic shared memory of one resident-mode block: keys, usable bits,
// column list.
template <typename T>
__host__ __device__ inline size_t dyn_smem_bytes(int w, int k) {
  using S = typename Keys<T>::S;
  return static_cast<size_t>(round_up(w, key_align<S>())) * sizeof(S) +
         static_cast<size_t>((w + 31) / 32) * 4 +
         static_cast<size_t>(round_up(k < w ? k : w, 8)) * 2;
}

// Entries of the wide mode's int32 list: the k-set's usable columns (at
// most min(k, w)), and before them the gather buffer.
__host__ __device__ inline int wide_list_len(int w, int k) {
  const int list = k < w ? k : w;
  const int gather = kWideGather < w ? kWideGather : w;
  return list > gather ? list : gather;
}

// Dynamic shared memory of one wide-mode block: usable bits, int32 list.
__host__ __device__ inline size_t wide_smem_bytes(int w, int k) {
  return static_cast<size_t>((w + 31) / 32) * 4 + static_cast<size_t>(wide_list_len(w, k)) * 4;
}

// kMulti: n_loci weights per column (see 5m above); the binary form
// ignores n_loci
template <typename T, bool kWide, bool kMulti>
__global__ void __launch_bounds__(kThreads, Keys<T>::kMinBlocks)
dipcn_select_kernel(const T* __restrict__ d2, const T* __restrict__ rnorm,
                    const T* __restrict__ nbr_w, const uint8_t* __restrict__ usable,
                    const uint8_t* __restrict__ valid, int w, int n_loci, int k, int n_nbr,
                    T* __restrict__ dipcn, uint8_t* __restrict__ ok) {
  using S = typename Keys<T>::S;
  using K = typename Keys<T>::K;
  using U = typename Keys<T>::U;
  constexpr K kBigKey = Keys<T>::kBig;
  using ListT = typename std::conditional<kWide, int, uint16_t>::type;
  extern __shared__ int4 dyn[];
  // d2 >= 0, so its bit pattern read as a signed integer keeps the order
  const S* src = reinterpret_cast<const S*>(d2) + static_cast<size_t>(blockIdx.x) * w;
  const int key_bytes = kWide ? 0 : round_up(w, key_align<S>()) * static_cast<int>(sizeof(S));
  const S* keys = kWide ? src : reinterpret_cast<const S*>(dyn);            // [w]
  unsigned* ubits = reinterpret_cast<unsigned*>(
      reinterpret_cast<uint8_t*>(dyn) + key_bytes);                         // [ceil(w / 32)]
  ListT* list = reinterpret_cast<ListT*>(ubits + (w + 31) / 32);            // see *_smem_bytes
  __shared__ Shared<T> sh;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row = blockIdx.x;

  // ---- 1. load the row's keys and usable bits; body min / max / count ----
  // (the wide mode leaves the keys in device memory)
  for (int b = tid; b < 2 * kBins; b += kThreads) (&sh.hist[0][0])[b] = 0;
  if (tid == 0) sh.list_len = 0;
  K mn = Keys<T>::kMax, mx = Keys<T>::kMin;
  unsigned nb = 0;
  auto see = [&](K key) {
    if (key < kBigKey) {
      mn = min(mn, key);
      mx = max(mx, key);
      ++nb;
    }
  };
  if (w % key_align<S>() == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    // resident: streamed, each row is read by one block, once; wide: the
    // later walks read the row again
    if constexpr (sizeof(S) == 2) {  // eight 16-bit keys a load
      const int4* s4 = reinterpret_cast<const int4*>(src);
      int4* k4 = reinterpret_cast<int4*>(dyn);
#pragma unroll 4
      for (int q = tid; q < w / 8; q += kThreads) {
        const int4 v = kWide ? __ldg(s4 + q) : __ldcs(s4 + q);
        if (!kWide) k4[q] = v;
        const int words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          see(static_cast<short>(words[h] & 0xffff));
          see(static_cast<short>(words[h] >> 16));
        }
      }
    } else if constexpr (sizeof(S) == 4) {
      const int4* s4 = reinterpret_cast<const int4*>(src);
      int4* k4 = reinterpret_cast<int4*>(dyn);
#pragma unroll 4
      for (int q = tid; q < w / 4; q += kThreads) {
        const int4 v = kWide ? __ldg(s4 + q) : __ldcs(s4 + q);
        if (!kWide) k4[q] = v;
        see(v.x);
        see(v.y);
        see(v.z);
        see(v.w);
      }
    } else {
      const longlong2* s2 = reinterpret_cast<const longlong2*>(src);
      longlong2* k2 = reinterpret_cast<longlong2*>(dyn);
#pragma unroll 4
      for (int q = tid; q < w / 2; q += kThreads) {
        const longlong2 v = kWide ? __ldg(s2 + q) : __ldcs(s2 + q);
        if (!kWide) k2[q] = v;
        see(v.x);
        see(v.y);
      }
    }
  } else {
    S* ks = reinterpret_cast<S*>(dyn);
#pragma unroll 4
    for (int j = tid; j < w; j += kThreads) {
      const S v = kWide ? __ldg(src + j) : __ldcs(src + j);
      if (!kWide) ks[j] = v;
      see(v);
    }
  }
  for (int i0 = 0; i0 < w; i0 += kThreads) {
    const int j = i0 + tid;
    const unsigned bal = __ballot_sync(kFull, j < w && usable[j]);
    if (lane == 0 && j < w) ubits[j >> 5] = bal;
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
  K body_lo = Keys<T>::kMax, body_hi = Keys<T>::kMin;
  int n_body = 0;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) {
    body_lo = min(body_lo, sh.rmin[i]);
    body_hi = max(body_hi, sh.rmax[i]);
    n_body += sh.rcnt[i];
  }
  int parity = 0;
  // the list's length, free until step 3 for the gather
  const int cap = kWide ? wide_list_len(w, k) : min(k, w);

  // ---- 2. t = the k-th smallest key, and count(keys < t) -----------------
  Found<K> f;
  if (k <= n_body) {
    f = select_rank<T, kWide, ListT>(keys, nullptr, w, body_lo,
                    static_cast<U>(body_hi) - static_cast<U>(body_lo), k, sh, parity, list, cap);
  } else {  // k reaches past the body into the finfo.max (or larger) keys
    f = select_rank<T, kWide, ListT>(keys, nullptr, w, kBigKey,
                    static_cast<U>(Keys<T>::kMax) - static_cast<U>(kBigKey), k - n_body, sh,
                    parity, list, cap);
    f.below += n_body;
  }
  const K t = f.t;
  const int need = k - f.below;  // ties at t to take, lowest columns first: 1 <= need

  // ---- 3. tie cut and compaction of the usable k-set, one scan ----------
  if constexpr (kWide) {
    tie_cut_walks(keys, ubits, w, t, need, list, sh);
  } else {
    const int chunk = ((w + kThreads - 1) / kThreads) | 1;  // odd: conflict-free chunk walks
    const int c0 = min(tid * chunk, w), c1 = min(c0 + chunk, w);
    unsigned long long cnt = 0;  // ties | usable below t << 21 | usable ties << 42
    for (int j = c0; j < c1; ++j) {
      const K key = keys[j];
      const unsigned long long u = usable_at(ubits, j);
      cnt += key == t ? 1ull + (u << (2 * kField)) : (key < t ? u << kField : 0ull);
    }
    unsigned long long tot;
    const unsigned long long pre = block_exclusive_scan(cnt, sh.wtot_l, tot);
    const int n_below_usable = static_cast<int>((tot >> kField) & kFieldMask);
    int ties = static_cast<int>(pre & kFieldMask);
    int pos_below = static_cast<int>((pre >> kField) & kFieldMask);
    int pos_tie = n_below_usable + static_cast<int>((pre >> (2 * kField)) & kFieldMask);
    for (int j = c0; j < c1; ++j) {
      const K key = keys[j];
      if (key < t) {
        if (usable_at(ubits, j)) list[pos_below++] = static_cast<uint16_t>(j);
      } else if (key == t && ++ties <= need) {
        if (usable_at(ubits, j)) list[pos_tie++] = static_cast<uint16_t>(j);
        if (ties == need) sh.list_len = pos_tie;
      }
    }
  }
  __syncthreads();
  const int len = sh.list_len;
  const int m_eff = min(len, n_nbr);

  // ---- 4. the m_eff nearest usable members, on the list only ------------
  const bool take_all = m_eff == len;  // also m_eff == 0
  K t2 = t;
  int need2 = 0;
  if (!take_all) {
    const K lo2 = n_body > 0 ? body_lo : kBigKey;  // the row's min key
    const Found<K> f2 = select_rank<T, kWide, ListT>(keys, list, len, lo2,
                                 static_cast<U>(t) - static_cast<U>(lo2), m_eff, sh,
                                 parity, static_cast<ListT*>(nullptr), 0);
    t2 = f2.t;
    need2 = m_eff - f2.below;
  }

  if constexpr (kMulti) {
    // ---- 5m. compact the take-set in place, then one sum per locus ------
    if (!take_all) {
      int ties_before = 0, below_before = 0;  // in the rounds before this one
      for (int i0 = 0; i0 < len; i0 += kThreads) {  // uniform trip count: whole block in the scan
        const int i = i0 + tid;
        int col = 0;
        K key = 0;
        if (i < len) {
          col = list[i];
          key = key_at<kWide>(keys, col);
        }
        const bool tie = i < len && key == t2, below = i < len && key < t2;
        int round_tot;  // ties in the low 16 bits, below t2 in the high: <= 128 each
        const int pre = block_exclusive_scan((tie ? 1 : 0) | (below ? 1 << 16 : 0), sh.wtot,
                                             round_tot);
        const int tie_rank = ties_before + (pre & 0xffff);  // ties before this entry
        if (below || (tie && tie_rank < need2)) {
          // taken entries before this one: all below t2, the first need2 ties
          list[below_before + (pre >> 16) + min(tie_rank, need2)] = static_cast<ListT>(col);
        }
        ties_before += round_tot & 0xffff;
        below_before += round_tot >> 16;
        __syncthreads();  // this round's places are written and its scan scratch is free
      }
    }
    const T denom = static_cast<T>(max(m_eff, 1));
    for (int l = tid; l < n_loci; l += kThreads) {
      const T* wl = nbr_w + l;
      double s = 0.0;  // a serial sum of up to n_nbr terms, in float64 (see 5m)
#pragma unroll 4
      for (int i = 0; i < m_eff; ++i) s += wl[static_cast<size_t>(list[i]) * n_loci];
      const size_t o = static_cast<size_t>(row) * n_loci + l;
      dipcn[o] = rnorm[o] / (static_cast<T>(s) / denom);
      ok[o] = valid[o] && m_eff > 0;
    }
    return;
  }

  // ---- 5. sum nbr_w over the take-set ------------------------------------
  const int chunk2 = ((len + kThreads - 1) / kThreads) | 1;
  const int l0 = min(tid * chunk2, len), l1 = min(l0 + chunk2, len);
  int ties2 = 0;
  if (!take_all) {
    int c = 0;
    for (int i = l0; i < l1; ++i) c += key_at<kWide>(keys, list[i]) == t2;
    int unused;
    ties2 = block_exclusive_scan(c, sh.wtot, unused);
  }
  typename Keys<T>::A s = 0;
  for (int i = l0; i < l1; ++i) {
    const int col = list[i];
    bool take = take_all;
    if (!take) {
      const K key = key_at<kWide>(keys, col);
      take = key < t2 || (key == t2 && ++ties2 <= need2);
    }
    if (take) s += to_acc(nbr_w[col]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
  if (lane == 0) sh.fsum[warp] = s;
  __syncthreads();
  if (tid == 0) {
    typename Keys<T>::A total = 0;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) total += sh.fsum[i];
    dipcn[row] = finish<T>(total, m_eff, rnorm[row]);
    ok[row] = valid[row] && m_eff > 0;
  }
}

// The larger static shared memory of the mode's two forms, binary and
// multi, in either value type.
template <typename T, bool kWide>
cudaError_t static_smem_bytes(size_t* bytes) {
  cudaFuncAttributes binary, multi;
  cudaError_t err = cudaFuncGetAttributes(&binary, dipcn_select_kernel<T, kWide, false>);
  if (err != cudaSuccess) return err;
  *bytes = binary.sharedSizeBytes;
  if constexpr (kHasMulti<T>) {
    if ((err = cudaFuncGetAttributes(&multi, dipcn_select_kernel<T, kWide, true>)) != cudaSuccess)
      return err;
    if (multi.sharedSizeBytes > *bytes) *bytes = multi.sharedSizeBytes;
  }
  return cudaSuccess;
}

template <typename T, bool kWide, bool kMulti>
cudaError_t configure(size_t smem) {
  static bool carveout_set = false;
  if (!carveout_set) {
    // shared memory before L1: the blocks per SM are bound by shared memory
    const cudaError_t err = cudaFuncSetAttribute(
        dipcn_select_kernel<T, kWide, kMulti>, cudaFuncAttributePreferredSharedMemoryCarveout,
        cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    carveout_set = true;
  }
  if (smem > 48 * 1024) {
    return cudaFuncSetAttribute(dipcn_select_kernel<T, kWide, kMulti>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(smem));
  }
  return cudaSuccess;
}

template <typename T>
size_t mode_smem_bytes(int mode, int w, int k) {
  return mode == 0 ? dyn_smem_bytes<T>(w, k) : wide_smem_bytes(w, k);
}

// The largest shared memory a block of this card may take.
cudaError_t optin_smem_bytes(size_t* bytes) {
  int device = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  *bytes = static_cast<size_t>(optin);
  return err;
}

// Blocks of one form an SM at `smem` bytes of dynamic shared memory.
template <typename T, bool kWide, bool kMulti>
cudaError_t blocks_per_sm(size_t smem, int* blocks) {
  const cudaError_t err = configure<T, kWide, kMulti>(smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, dipcn_select_kernel<T, kWide, kMulti>, kThreads, smem);
}

// The launch shape; a mode that does not take rows of w columns, or whose
// shared memory does not fit the card, reports 0 blocks an SM.
template <typename T, bool kWide, bool kMulti>
int info(int w, int k, int* out) {
  const size_t smem = mode_smem_bytes<T>(kWide, w, k);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, dipcn_select_kernel<T, kWide, kMulti>);
  if (err != cudaSuccess) return static_cast<int>(err);
  size_t avail = 0;
  if ((err = optin_smem_bytes(&avail)) != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  const bool takes = kWide ? w < kWideMaxCols : w <= kResidentMaxCols;
  if (takes && smem + attr.sharedSizeBytes <= avail &&
      (err = blocks_per_sm<T, kWide, kMulti>(smem, &blocks)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  out[0] = kThreads;
  out[1] = static_cast<int>(smem);
  out[2] = static_cast<int>(attr.sharedSizeBytes);
  out[3] = blocks;
  out[4] = attr.numRegs;
  out[5] = static_cast<int>(attr.localSizeBytes);
  return cudaSuccess;
}

template <typename T, bool kWide, bool kMulti>
int launch(const void* d2, const void* rnorm, const void* nbr_w, const void* usable,
           const void* valid, int n, int w, int n_loci, int k, int n_nbr, void* dipcn, void* ok,
           cudaStream_t stream) {
  const size_t smem = mode_smem_bytes<T>(kWide, w, k);
  const cudaError_t err = configure<T, kWide, kMulti>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dipcn_select_kernel<T, kWide, kMulti><<<n, kThreads, smem, stream>>>(
      static_cast<const T*>(d2), static_cast<const T*>(rnorm), static_cast<const T*>(nbr_w),
      static_cast<const uint8_t*>(usable), static_cast<const uint8_t*>(valid), w, n_loci, k,
      n_nbr, static_cast<T*>(dipcn), static_cast<uint8_t*>(ok));
  return static_cast<int>(cudaGetLastError());
}

// The arguments every launch checks: a mode that takes rows of w columns.
bool valid_shape(int w, int k, int mode) {
  return w > 0 && k >= 1 && k <= w && (mode == 0 || mode == 1) &&
         !(mode == 0 && w > kResidentMaxCols) && !(mode == 1 && w >= kWideMaxCols);
}

// The resident mode where its shared memory fits and at least
// kResidentMinBlocks of its blocks (of the fewer of its two forms) fit an
// SM, else the wide mode where that fits, else the resident mode where
// only it fits, else -1.
template <typename T>
int select_mode(int device, int w, int k, int* mode) {
  int optin = 0;
  cudaError_t err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  size_t stat_resident = 0, stat_wide = 0;
  if ((err = static_smem_bytes<T, false>(&stat_resident)) != cudaSuccess) return err;
  if ((err = static_smem_bytes<T, true>(&stat_wide)) != cudaSuccess) return err;
  const size_t avail = static_cast<size_t>(optin), smem = dyn_smem_bytes<T>(w, k);
  const bool resident = w <= kResidentMaxCols && smem + stat_resident <= avail;
  const bool wide = w < kWideMaxCols && wide_smem_bytes(w, k) + stat_wide <= avail;
  int blocks = 0;
  if (resident) {
    if ((err = blocks_per_sm<T, false, false>(smem, &blocks)) != cudaSuccess) return err;
    if constexpr (kHasMulti<T>) {
      int multi = 0;
      if ((err = blocks_per_sm<T, false, true>(smem, &multi)) != cudaSuccess) return err;
      if (multi < blocks) blocks = multi;
    }
  }
  *mode = resident && (blocks >= kResidentMinBlocks || !wide) ? 0 : wide ? 1 : -1;
  return cudaSuccess;
}

template <typename T>
int binary_launch(const void* d2, const void* rnorm, const void* nbr_w, const void* usable,
                  const void* valid, int n, int w, int k, int n_nbr, int mode, void* dipcn,
                  void* ok, void* stream) {
  if (n <= 0) return cudaSuccess;
  if (!valid_shape(w, k, mode)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return mode == 0 ? launch<T, false, false>(d2, rnorm, nbr_w, usable, valid, n, w, 1, k, n_nbr,
                                             dipcn, ok, s)
                   : launch<T, true, false>(d2, rnorm, nbr_w, usable, valid, n, w, 1, k, n_nbr,
                                            dipcn, ok, s);
}

template <typename T>
int multi_launch(const void* d2, const void* rnorm, const void* nbr_w, const void* usable,
                 const void* valid, int n, int w, int n_loci, int k, int n_nbr, int mode,
                 void* dipcn, void* ok, void* stream) {
  if (n <= 0) return cudaSuccess;
  if (n_loci < 1 || !valid_shape(w, k, mode)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return mode == 0 ? launch<T, false, true>(d2, rnorm, nbr_w, usable, valid, n, w, n_loci, k,
                                            n_nbr, dipcn, ok, s)
                   : launch<T, true, true>(d2, rnorm, nbr_w, usable, valid, n, w, n_loci, k,
                                           n_nbr, dipcn, ok, s);
}

template <typename T>
int info_of(int mode, int multi, int w, int k, int* out) {
  if (mode != 0 && mode != 1) return cudaErrorInvalidValue;
  if (multi) {
    if constexpr (kHasMulti<T>) {
      return mode == 0 ? info<T, false, true>(w, k, out) : info<T, true, true>(w, k, out);
    }
    return cudaErrorInvalidValue;  // no multi-weight form in bf16
  }
  return mode == 0 ? info<T, false, false>(w, k, out) : info<T, true, false>(w, k, out);
}

}  // namespace

extern "C" {

// The mode that takes rows of w columns at this k on `device`, in either
// form: 0 (the row's keys in shared memory) where its shared memory fits,
// w <= 65,536 and at least kResidentMinBlocks of its blocks fit an SM, else
// 1 (wide: the keys stay in device memory) where that fits, else 0 where
// only it fits, else -1. Returns the first cudaError_t.
int dipcn_select_mode(int device, int w, int k, int* mode) {
  return select_mode<float>(device, w, k, mode);
}

// Launch shape of `mode` (of the multi-weight form when `multi` is
// non-zero) for rows of w columns at this k on the current device: threads,
// dynamic and static shared memory per block, resident blocks per SM (0
// where the mode's shared memory does not fit), registers a thread and
// local (spill) bytes a thread. Returns the first cudaError_t.
int dipcn_select_info(int mode, int multi, int w, int k, int* out) {
  return info_of<float>(mode, multi, w, k, out);
}

// Launch the binary form in `mode` (from dipcn_select_mode) on `stream`
// without synchronising; returns the first cudaError_t.
int dipcn_select_launch(const void* d2, const void* rnorm, const void* nbr_w, const void* usable,
                        const void* valid, int n, int w, int k, int n_nbr, int mode, void* dipcn,
                        void* ok, void* stream) {
  return binary_launch<float>(d2, rnorm, nbr_w, usable, valid, n, w, k, n_nbr, mode, dipcn, ok,
                              stream);
}

// Launch the multi-weight form in `mode`: rnorm and valid [n, n_loci],
// nbr_w [w, n_loci], dipcn and ok [n, n_loci], all row-major. Returns the
// first cudaError_t.
int dipcn_select_multi_launch(const void* d2, const void* rnorm, const void* nbr_w,
                              const void* usable, const void* valid, int n, int w, int n_loci,
                              int k, int n_nbr, int mode, void* dipcn, void* ok, void* stream) {
  return multi_launch<float>(d2, rnorm, nbr_w, usable, valid, n, w, n_loci, k, n_nbr, mode,
                             dipcn, ok, stream);
}

// The float64 forms: the mode, launch shapes and launches above with d2,
// rnorm, nbr_w and dipcn float64.
int dipcn_select_mode_f64(int device, int w, int k, int* mode) {
  return select_mode<double>(device, w, k, mode);
}

int dipcn_select_info_f64(int mode, int multi, int w, int k, int* out) {
  return info_of<double>(mode, multi, w, k, out);
}

int dipcn_select_launch_f64(const void* d2, const void* rnorm, const void* nbr_w,
                            const void* usable, const void* valid, int n, int w, int k, int n_nbr,
                            int mode, void* dipcn, void* ok, void* stream) {
  return binary_launch<double>(d2, rnorm, nbr_w, usable, valid, n, w, k, n_nbr, mode, dipcn, ok,
                               stream);
}

int dipcn_select_multi_launch_f64(const void* d2, const void* rnorm, const void* nbr_w,
                                  const void* usable, const void* valid, int n, int w,
                                  int n_loci, int k, int n_nbr, int mode, void* dipcn, void* ok,
                                  void* stream) {
  return multi_launch<double>(d2, rnorm, nbr_w, usable, valid, n, w, n_loci, k, n_nbr, mode,
                              dipcn, ok, stream);
}

// The bfloat16 binary form: the mode, launch shape (multi must be 0) and
// launch above with d2, rnorm, nbr_w and dipcn bf16.
int dipcn_select_mode_bf16(int device, int w, int k, int* mode) {
  return select_mode<__nv_bfloat16>(device, w, k, mode);
}

int dipcn_select_info_bf16(int mode, int multi, int w, int k, int* out) {
  return info_of<__nv_bfloat16>(mode, multi, w, k, out);
}

int dipcn_select_launch_bf16(const void* d2, const void* rnorm, const void* nbr_w,
                             const void* usable, const void* valid, int n, int w, int k,
                             int n_nbr, int mode, void* dipcn, void* ok, void* stream) {
  return binary_launch<__nv_bfloat16>(d2, rnorm, nbr_w, usable, valid, n, w, k, n_nbr, mode,
                                      dipcn, ok, stream);
}

const char* dipcn_select_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
