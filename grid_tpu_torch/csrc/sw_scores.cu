// Smith-Waterman scores of every read against every reference: for Q reads
// of Lq codes and T references of Lr codes (A=0 C=1 G=2 T=3, anything else
// a code that never matches when it is 4 in a reference), the best
// linear-gap local-alignment score of each (read, reference) pair, [Q, T]
// int32:
//
//   H[i, j] = max(0, H[i-1, j-1] + sub, H[i-1, j] + gap, H[i, j-1] + gap)
//
// with sub = match where the two codes are equal and the reference's is not
// 4, else mismatch. A read position with code 4 (pad, N, IUPAC) leaves the
// row as it is and scores nothing. Exactly the integers of
// grid_tpu_torch/ops/align.py:sw_scores_plain.
//
// Replaces grid_tpu/ops/align.py:sw_scores (line 42): an XLA lax.scan over
// query positions (line 95) that advances a [Q, T, Lr] int32 slab a step; it
// has no pallas_call.
//
// What bounds it on the H100: reads, references and scores are a few MB, so
// the SMs' integer instructions do. A cell is 9 integer operations (the
// substitution's compare and select, three adds, three maxes with the zero
// clamp, the running best); Hopper's DPX forms do 5 of them in 2
// instructions, so 6 instructions a cell over Q*T*Lq*Lr cells, at 132 SMs x
// 4 warp instructions a clock x the SM clock: ~0.12 ms for one sample of
// the KIV-2 window (Q ~ 8,000 reads of 150 bases, three references of
// 160-182, ~0.65 G cells). Where two cells share a register (the packed
// form below), they take a prmt for both substitutions, three 16x2 max-adds
// and half a three-way max into the best: 2.25 instructions a cell, ~0.045
// ms. The max-adds, three-way maxes, compares,
// selects and byte permutes all take the integer ALU, 16 lanes a scheduler:
// half the issue rate, which the times measured on the card follow more
// closely (PERF.md). So every ALU instruction a cell counts, and every
// instruction a row costs beyond its cells (shuffles, scans, idle lanes, a
// chain between lanes).
//
// Design: lane groups on a row wavefront, with no cross-lane scan, and two
// cells an instruction where the scores fit 16 bits.
//
// - G lanes (8, 16 or 32) work one unit, so 32/G units share a warp and
//   128/G a block. Lane g owns the strip of S columns [g*S, g*S + S) in
//   registers, S = ceil(Lr/G) rounded up to an even number: a value a
//   column for its reference code and one for its H. (G, S) are template
//   arguments; the wrapper (ops/gpu_align.py:sw_shape) picks them from Lr
//   and the unit count, and the table below holds every instance it may
//   ask for. Even strips halve the table (and its build) against one of
//   every S, for at most one padded column a lane.
// - At step t lane g computes row i = t - g of its strip, so a group runs
//   Lq + G - 1 steps, of which G - 1 fill and drain. The left dependency
//   runs serially inside the lane, a DPX max-add a cell, after the row's
//   bases max(up + gap, diag + sub, 0) are computed right to left in place
//   (a column's old H feeds its own base and its right neighbour's).
// - One shuffle a step: __shfl_up_sync(last, 1, G) hands lane g the last
//   column of lane g-1's row i, computed the step before. That is lane g's
//   left edge for row i; held one step, it is its diagonal edge for row i+1.
//   Lane 0 of a group takes 0 for both.
// - Each lane loads its row's read code itself (a byte, one step ahead; the
//   read stays in L1). A row of code 4, and a step outside 0 <= i < Lq, is
//   skipped: the strip, the best and the last column passed on stay as they
//   are. The shuffle runs on every lane.
// - The packed form (sw_duo_kernel), where the wrapper finds every value of
//   the recurrence inside int16 and the scores a byte each (ops/
//   gpu_align.py:packed_fits): a unit is two reads against one reference,
//   one in each 16-bit half of every register, and the max-adds and
//   three-way maxes are DPX's 16x2 forms, two cells an instruction. A
//   column's register holds its profile, the substitution for read codes
//   0-3 a byte each; one prmt a column gives both halves' substitutions,
//   sign-extended. A half whose read has a 4 takes -32768 as its
//   substitution and 0 as its up gap, so each base is the old H; the left
//   chain keeps it, since every row has H[j] >= H[j-1] + gap. So its row
//   stays exactly as it was while the other half moves on. A warp with a
//   read code past 4 (none from encode_seqs) scores its two reads in turn
//   in the int32 form instead.
// - The int32 form (sw_group_kernel) for all else: a unit is one (read,
//   reference) pair, the substitution a compare and a select. The columns
//   past Lr (the last strip's padding) lie right of every valid column, so
//   no valid cell reads them; they are kept out of the best, since with a
//   positive gap or mismatch they could exceed it. With gap <= 0 and
//   mismatch <= 0 they never can, so the packed form counts them all.
// - A group's best is a __shfl_xor_sync max over its G lanes. Groups past
//   the last unit repeat it (their warp's shuffles need every lane) and
//   write nothing; a warp with no unit at all leaves at once.
// - Rows longer than 512 (extract-reference writes any length) take the
//   shared-memory mode: the row lives in shared memory, 4*Lr bytes a warp,
//   and is walked in chunks of 32 columns, one a lane, with a shuffle
//   max-scan of the decayed values (u = H - j*gap is a running max, exact
//   for any integer gap) and a carry between chunks. Each lane touches only
//   its own columns, so the row needs no barrier. Rows up to the block's
//   opt-in shared memory / 4 (58,112 columns on an H100).
//
// The kernel allocates nothing, launches on the caller's stream and returns
// cudaGetLastError(). The wrapper (grid_tpu_torch/ops/gpu_align.py) checks
// the inputs and the int32 range, and gives empty shapes zeros without a
// launch.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 128;      // threads a block in the register mode
constexpr int kWarps = 4;          // pairs (warps) a block in the shared mode
constexpr int kRegisterMaxLr = 512;  // the register mode's longest reference
constexpr int kNever = 1 << 20;    // a reference's 4: equal to no read code
constexpr int kSharedWarpBytes = 48 * 1024;  // the shared mode's row budget before opt-in

// The strips of the template table: S a multiple of kStripStep up to the
// longest a lane holds at G lanes a unit (G * S <= 512).
constexpr int kStripStep = 2;
constexpr int max_strip(int g) { return g == 32 ? 16 : 32; }

// Steps an iteration of the packed form's loop: two, which overlaps one
// step's read loads and selector with the other's cells, except at S=16
// with G=8 or 16, where ptxas then spills 4 bytes.
__host__ __device__ constexpr int packed_unroll(int g, int s) {
  return s == 16 && g < 32 ? 1 : 2;
}

// A reference's code as the read's raw byte it equals, or kNever: past Lr,
// a 4, or (where one tensor is int8 and the other uint8) a byte of 128 or
// more, which the two read as different numbers. Every mode compares the
// read's raw byte with it: equal bytes are equal codes in one type, and a
// read's 4 is the byte 4 in both.
__device__ __forceinline__ int raw_ref_code(const uint8_t* p, int j, int lr, bool mixed) {
  if (j >= lr) return kNever;
  const int c = __ldg(p + j);
  return c == 4 || (mixed && c >= 128) ? kNever : c;
}

// The byte permute: byte n of the result is the byte (of b:a) that nibble n
// of the selector names, or with the nibble's high bit that byte's sign.
__device__ __forceinline__ unsigned prmt(unsigned a, unsigned b, unsigned selector) {
  unsigned r;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(selector));
  return r;
}

// ---- the int32 form: one (read, reference) pair a group ----

// The wavefront: Lq + G - 1 steps, lane g on row t - g; codes[] holds the
// raw reference codes; the columns from `valid` on are left out of the best.
template <int G, int S>
__device__ __forceinline__ int wavefront(const uint8_t* qrow, int lq, const int (&codes)[S],
                                         int g, int valid, int match, int mismatch, int gap) {
  int h[S];
#pragma unroll
  for (int s = 0; s < S; ++s) h[s] = 0;
  int best = 0;
  int last = 0;  // this lane's last column of the row it computed last
  int held = 0;  // lane g-1's last column one row up: the diagonal edge
  int i = -g;
  int qc_next = i == 0 ? __ldg(qrow) : 4;
  for (int t = lq + G - 1; t > 0; --t, ++i) {
    const int qc = qc_next;  // the read's raw byte
    qc_next = static_cast<unsigned>(i + 1) < static_cast<unsigned>(lq) ? __ldg(qrow + i + 1) : 4;
    int left = __shfl_up_sync(kFull, last, 1, G);
    if (g == 0) left = 0;
    const int diag = held;
    held = left;
    if (qc == 4) continue;  // also every step outside 0 <= i < Lq: the row stays
#pragma unroll
    for (int s = S - 1; s > 0; --s) {
      h[s] = __viaddmax_s32_relu(h[s], gap, h[s - 1] + (codes[s] == qc ? match : mismatch));
    }
    h[0] = __viaddmax_s32_relu(h[0], gap, diag + (codes[0] == qc ? match : mismatch));
#pragma unroll
    for (int s = 0; s < S; ++s) {
      left = __viaddmax_s32(left, gap, h[s]);
      h[s] = left;
      if (s < valid) best = max(best, left);
    }
    last = h[S - 1];
  }
  return best;
}

template <int G, int S>
__global__ void __launch_bounds__(kThreads)
sw_group_kernel(const uint8_t* __restrict__ queries, const uint8_t* __restrict__ refs,
                bool mixed, long long n_q, int n_t, int lq, int lr, int match, int mismatch,
                int gap, int* __restrict__ out) {
  const long long n_pairs = n_q * n_t;
  const long long first = static_cast<long long>(blockIdx.x) * (kThreads / G);
  if (first + (threadIdx.x >> 5) * (32 / G) >= n_pairs) return;  // the whole warp leaves
  const int g = threadIdx.x % G;
  long long pair = first + threadIdx.x / G;
  const bool live = pair < n_pairs;
  if (!live) pair = n_pairs - 1;  // repeat the last pair: the shuffles need every lane
  const long long qi = pair / n_t;
  const int ti = static_cast<int>(pair - qi * n_t);
  const uint8_t* rrow = refs + static_cast<long long>(ti) * lr;
  const int j0 = g * S;
  int codes[S];
#pragma unroll
  for (int s = 0; s < S; ++s) codes[s] = raw_ref_code(rrow, j0 + s, lr, mixed);
  // past Lr a column only loses unless the gap or the mismatch is positive
  const int valid = gap > 0 || mismatch > 0 ? min(max(lr - j0, 0), S) : S;
  int best = wavefront<G, S>(queries + qi * lq, lq, codes, g, valid, match, mismatch, gap);
#pragma unroll
  for (int d = G / 2; d > 0; d >>= 1) best = max(best, __shfl_xor_sync(kFull, best, d, G));
  if (g == 0 && live) out[pair] = best;
}

// ---- the packed form: two reads against one reference a group ----

// One half's two selector nibbles: byte qc of the profile and its sign, or
// for a 4 (the row stays) bytes 0x00 and 0x80 of kSkip's 0x8000: -32768.
__device__ __forceinline__ unsigned half_selector(unsigned qc) {
  return qc == 4 ? 0x54u : qc * 0x11u + 0x80u;
}

constexpr unsigned kSkip = 0x8000u;  // bytes 4 and 5 of the permute

template <int G, int S>
__device__ __forceinline__ unsigned wavefront_packed(const uint8_t* qa, const uint8_t* qb, int lq,
                                                     const unsigned (&profile)[S], int g,
                                                     int gap) {
  unsigned h[S];
#pragma unroll
  for (int s = 0; s < S; ++s) h[s] = 0;
  unsigned best = 0, last = 0, held = 0;
  const unsigned gap16 = static_cast<unsigned>(gap) & 0xffffu, gap2 = gap16 | gap16 << 16;
  // 0 (lq >= 1) in one register the compiler cannot rebuild: a literal 0
  // costs a PRMT before every max-add that takes it
  const unsigned zero = static_cast<unsigned>(lq) >> 31;
  int i = -g;
  unsigned a_next = i == 0 ? __ldg(qa) : 4u, b_next = i == 0 ? __ldg(qb) : 4u;
#pragma unroll (packed_unroll(G, S))
  for (int t = lq + G - 1; t > 0; --t, ++i) {
    const unsigned ca = a_next, cb = b_next;
    const bool more = static_cast<unsigned>(i + 1) < static_cast<unsigned>(lq);
    a_next = more ? __ldg(qa + i + 1) : 4u;
    b_next = more ? __ldg(qb + i + 1) : 4u;
    unsigned left = __shfl_up_sync(kFull, last, 1, G);
    if (g == 0) left = 0;
    const unsigned diag = held;
    held = left;
    if (ca == 4 && cb == 4) continue;
    const unsigned selector = half_selector(ca) | half_selector(cb) << 8;
    const unsigned gap_up = (ca == 4 ? 0u : gap16) | (cb == 4 ? 0u : gap16) << 16;
    // base = max(diag + sub, max(up + gap, 0)), right to left in place
#pragma unroll
    for (int s = S - 1; s > 0; --s) {
      h[s] = __viaddmax_s16x2(h[s - 1], prmt(profile[s], kSkip, selector),
                              __viaddmax_s16x2_relu(h[s], gap_up, zero));
    }
    h[0] = __viaddmax_s16x2(diag, prmt(profile[0], kSkip, selector),
                            __viaddmax_s16x2_relu(h[0], gap_up, zero));
#pragma unroll
    for (int s = 0; s < S; ++s) {
      left = __viaddmax_s16x2(left, gap2, h[s]);
      h[s] = left;
    }
#pragma unroll
    for (int s = 0; s + 1 < S; s += 2) best = __vimax3_s16x2(best, h[s], h[s + 1]);
    if (S % 2) best = __vmaxs2(best, h[S - 1]);
    last = h[S - 1];
  }
  return best;
}

template <int G, int S>
__global__ void __launch_bounds__(kThreads)
sw_duo_kernel(const uint8_t* __restrict__ queries, const uint8_t* __restrict__ refs,
              bool mixed, long long n_q, int n_t, int lq, int lr, int match, int mismatch,
              int gap, int* __restrict__ out) {
  const long long n_duos = (n_q + 1) / 2 * n_t;
  const long long first = static_cast<long long>(blockIdx.x) * (kThreads / G);
  if (first + (threadIdx.x >> 5) * (32 / G) >= n_duos) return;  // the whole warp leaves
  const int g = threadIdx.x % G;
  long long duo = first + threadIdx.x / G;
  const bool live = duo < n_duos;
  if (!live) duo = n_duos - 1;  // repeat the last unit: the shuffles need every lane
  const long long q2 = duo / n_t;
  const int ti = static_cast<int>(duo - q2 * n_t);
  const long long qa = 2 * q2, qb = min(qa + 1, n_q - 1);  // an odd Q's last read twice
  const uint8_t* arow = queries + qa * lq;
  const uint8_t* brow = queries + qb * lq;
  const uint8_t* rrow = refs + static_cast<long long>(ti) * lr;
  const int j0 = g * S;
  int codes[S];
#pragma unroll
  for (int s = 0; s < S; ++s) codes[s] = raw_ref_code(rrow, j0 + s, lr, mixed);
  bool past4 = false;
  for (int i = g; i < lq; i += G) past4 |= (__ldg(arow + i) > 4) | (__ldg(brow + i) > 4);
  int best_a, best_b;
  if (!__any_sync(kFull, past4)) {
    unsigned profile[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      profile[s] = 0;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        profile[s] |= (static_cast<unsigned>(codes[s] == c ? match : mismatch) & 0xffu) << 8 * c;
      }
    }
    unsigned best = wavefront_packed<G, S>(arow, brow, lq, profile, g, gap);
#pragma unroll
    for (int d = G / 2; d > 0; d >>= 1) best = __vmaxs2(best, __shfl_xor_sync(kFull, best, d, G));
    best_a = static_cast<short>(best & 0xffffu);
    best_b = static_cast<short>(best >> 16);
  } else {  // the int32 form, read by read (no positive gap or mismatch here)
    best_a = best_b = 0;
#pragma unroll 1
    for (int k = 0; k < 2; ++k) {
      int best = wavefront<G, S>(k ? brow : arow, lq, codes, g, S, match, mismatch, gap);
#pragma unroll
      for (int d = G / 2; d > 0; d >>= 1) best = max(best, __shfl_xor_sync(kFull, best, d, G));
      (k ? best_b : best_a) = best;
    }
  }
  if (g == 0 && live) {
    out[qa * n_t + ti] = best_a;
    if (qb != qa) out[qb * n_t + ti] = best_b;
  }
}

__global__ void __launch_bounds__(kWarps * 32)
sw_shared_kernel(const uint8_t* __restrict__ queries, const uint8_t* __restrict__ refs,
                 bool mixed, long long n_pairs, int n_t, int lq, int lr, int match,
                 int mismatch, int gap, int* __restrict__ out) {
  extern __shared__ int rows[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const long long pair = static_cast<long long>(blockIdx.x) * warps + warp;
  if (pair >= n_pairs) return;
  const long long qi = pair / n_t;
  const int ti = static_cast<int>(pair - qi * n_t);
  const uint8_t* qrow = queries + qi * lq;
  const uint8_t* rrow = refs + static_cast<long long>(ti) * lr;
  int* row = rows + static_cast<long long>(warp) * lr;
  for (int j = lane; j < lr; j += 32) row[j] = 0;  // a lane's own columns: no barrier
  const int chunks = (lr + 31) / 32;
  int best = 0;
  for (int i0 = 0; i0 < lq; i0 += 32) {
    const int mine = i0 + lane < lq ? __ldg(qrow + i0 + lane) : 4;
    const int n = min(32, lq - i0);
    for (int k = 0; k < n; ++k) {
      const int qc = __shfl_sync(kFull, mine, k);
      if (qc == 4) continue;
      int edge = 0;     // the previous row's H left of the chunk
      int carry = 0;    // the decayed maximum of the chunks to the left
      for (int c = 0; c < chunks; ++c) {
        const int j = c * 32 + lane;
        const bool valid = j < lr;
        const int up = valid ? row[j] : 0;
        int diag = __shfl_up_sync(kFull, up, 1);
        if (lane == 0) diag = edge;
        edge = __shfl_sync(kFull, up, 31);
        const int sub = raw_ref_code(rrow, j, lr, mixed) == qc ? match : mismatch;
        int u = __viaddmax_s32_relu(up, gap, diag + sub) - j * gap;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const int v = __shfl_up_sync(kFull, u, d);
          if (lane >= d) u = max(u, v);
        }
        if (c > 0) u = max(u, carry);
        const int hj = u + j * gap;
        if (valid) {
          row[j] = hj;
          best = max(best, hj);
        }
        carry = __shfl_sync(kFull, u, 31);
      }
    }
  }
  best = __reduce_max_sync(kFull, best);
  if (lane == 0) out[pair] = best;
}

using RegisterKernel = void (*)(const uint8_t*, const uint8_t*, bool, long long, int, int, int,
                                int, int, int, int*);

template <int G, int S>
RegisterKernel register_kernel_from(int s, bool packed) {
  if constexpr (S > max_strip(G)) {
    return nullptr;
  } else {
    if (s != S) return register_kernel_from<G, S + kStripStep>(s, packed);
    return packed ? &sw_duo_kernel<G, S> : &sw_group_kernel<G, S>;
  }
}

// The register mode's instance for G lanes a unit, strips of S columns and
// the form, or nullptr where the table has none.
RegisterKernel register_kernel(int g, int s, bool packed) {
  switch (g) {
    case 8: return register_kernel_from<8, kStripStep>(s, packed);
    case 16: return register_kernel_from<16, kStripStep>(s, packed);
    case 32: return register_kernel_from<32, kStripStep>(s, packed);
    default: return nullptr;
  }
}

// Warps a block and dynamic shared memory of the shared mode at this Lr.
void shared_shape(int lr, int* warps, int* smem) {
  const long long row = 4LL * lr;
  long long w = kSharedWarpBytes / row;
  w = w < 1 ? 1 : (w > kWarps ? kWarps : w);
  *warps = static_cast<int>(w);
  *smem = static_cast<int>(w * row);
}

cudaError_t optin_smem(int device, int* bytes) {
  return cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
}

}  // namespace

extern "C" {

// The longest reference the kernel takes on `device` (the shared mode's
// row must fit one block's opt-in shared memory). Returns the cudaError_t.
int sw_scores_max_lr(int device, int* max_lr) {
  int optin = 0;
  const cudaError_t err = optin_smem(device, &optin);
  if (err != cudaSuccess) return err;
  *max_lr = optin / 4;
  return cudaSuccess;
}

// The launch shape at this Lr with (g, s, packed) from the wrapper (read
// only in the register mode): mode (0 registers, 1 shared memory), form (0
// int32, 1 packed), lanes a unit, columns a lane (the strip, or 32-column
// chunks), pairs a block, dynamic shared memory a block, registers a
// thread, local (spill) bytes a thread and the blocks an SM takes at once.
int sw_scores_info(int lr, int g, int s, int packed, int* out) {
  if (lr <= 0) return cudaErrorInvalidValue;
  cudaFuncAttributes attr{};
  const void* kernel;
  int threads, smem;
  if (lr <= kRegisterMaxLr) {
    const RegisterKernel k = register_kernel(g, s, packed != 0);
    if (k == nullptr || g * s < lr) return cudaErrorInvalidValue;
    kernel = reinterpret_cast<const void*>(k);
    threads = kThreads;
    smem = 0;
    out[0] = 0;
    out[1] = packed != 0;
    out[2] = g;
    out[3] = s;
    out[4] = kThreads / g * (packed ? 2 : 1);
  } else {
    int warps = 0;
    shared_shape(lr, &warps, &smem);
    kernel = reinterpret_cast<const void*>(&sw_shared_kernel);
    threads = warps * 32;
    out[0] = 1;
    out[1] = 0;
    out[2] = 32;
    out[3] = (lr + 31) / 32;
    out[4] = warps;
    if (smem > kSharedWarpBytes) {
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return err;
    }
  }
  out[5] = smem;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  out[6] = attr.numRegs;
  out[7] = static_cast<int>(attr.localSizeBytes);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[8], kernel, threads, smem);
}

// Launch on `stream` without synchronising: queries [n_q, lq] and refs
// [n_t, lr] bytes (`mixed` where one is int8 and the other uint8), out
// [n_q, n_t] int32;
// (g, s, packed) the register mode's lanes a unit, strip and form, from the
// wrapper (unread past 512 columns). Empty shapes launch nothing. Returns
// cudaGetLastError().
int sw_scores_launch(const void* queries, const void* refs, int mixed, long long n_q, int n_t,
                     int lq, int lr, int match, int mismatch, int gap, int g, int s, int packed,
                     void* out, void* stream) {
  if (n_q <= 0 || n_t <= 0 || lq <= 0 || lr <= 0) return cudaSuccess;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* q = static_cast<const uint8_t*>(queries);
  const auto* r = static_cast<const uint8_t*>(refs);
  auto* o = static_cast<int*>(out);
  if (lr <= kRegisterMaxLr) {
    const RegisterKernel kernel = register_kernel(g, s, packed != 0);
    if (kernel == nullptr || g * s < lr) return cudaErrorInvalidValue;
    const long long units = packed ? (n_q + 1) / 2 * n_t : n_q * n_t;
    const long long per_block = kThreads / g;
    const long long blocks = (units + per_block - 1) / per_block;
    if (blocks > INT_MAX) return cudaErrorInvalidValue;
    kernel<<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
        q, r, mixed != 0, n_q, n_t, lq, lr, match, mismatch, gap, o);
    return cudaGetLastError();
  }
  const long long pairs = n_q * n_t;
  int warps = 0, smem = 0;
  shared_shape(lr, &warps, &smem);
  int device = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = optin_smem(device, &optin);
  if (err != cudaSuccess) return err;
  if (smem > optin) return cudaErrorInvalidValue;
  if (smem > kSharedWarpBytes) {
    err = cudaFuncSetAttribute(reinterpret_cast<const void*>(&sw_shared_kernel),
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const long long blocks = (pairs + warps - 1) / warps;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  sw_shared_kernel<<<static_cast<unsigned>(blocks), warps * 32, smem, st>>>(
      q, r, mixed != 0, pairs, n_t, lq, lr, match, mismatch, gap, o);
  return cudaGetLastError();
}

const char* sw_scores_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
