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
// Bound on the H100: reads, references and scores are a few MB, so the
// card's instruction issue rate bounds it. A cell is 9 integer operations
// (the substitution's compare and select, three adds, three maxes with the
// zero clamp, the running best); the DPX forms below do 5 of them in 2
// instructions, so 6 instructions a cell over Q*T*Lq*Lr cells, at 132 SMs x
// 4 warp instructions a clock x the SM clock. One sample of the KIV-2
// window (Q ~ 8,000 reads of 150 bases, three references of 160-182) is
// ~0.65 G cells, ~0.12 ms.
//
// Design (simple and right first):
//
// - One warp per (read, reference) pair, four pairs a block. A lane holds a
//   strip of W = ceil(Lr/32) neighbouring columns (W a template argument up
//   to 16, so rows up to 512 columns live in registers), with the strip's
//   reference codes, the previous row and each column's running best.
// - A read code comes from one 32-byte coalesced load per 32 positions and a
//   __shfl_sync; a code of 4 skips the row, a branch uniform across the warp.
// - Per row: the diagonal's left edge from the neighbouring lane
//   (__shfl_up_sync); base = max(up + gap, diag + sub, 0) as one DPX
//   __viaddmax_s32_relu; the left dependency inside the strip by
//   __viaddmax_s32 (max(H[j-1] + gap, base[j])); across lanes through the
//   JAX package's decay transform (u = H - j*gap is a running max, exact for
//   any integer gap): a 5-step __shfl_up_sync max-scan of the strips'
//   decayed maxima gives each lane the H left of its strip, and one more
//   __viaddmax_s32 pass applies it.
// - Columns past Lr (the last strip's padding) never reach a valid column
//   (they lie to its right) and are left out of the best once, at the end;
//   the warp's best is one __reduce_max_sync, written by lane 0.
// - Rows longer than 512 (extract-reference writes any length) take the
//   shared-memory mode: the row lives in shared memory, 4*Lr bytes a warp,
//   and is walked in chunks of 32 columns, one a lane, with the same
//   shuffles, scan and a carry between chunks. Each lane touches only its
//   own columns, so the row needs no barrier. Rows up to the block's opt-in
//   shared memory / 4 (58,112 columns on an H100).
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
constexpr int kWarps = 4;          // pairs a block in the register mode
constexpr int kMaxStrip = 16;      // columns a lane: rows up to 512 in registers
constexpr int kNever = 1 << 20;    // a reference's 4: equal to no read code
constexpr int kSharedWarpBytes = 48 * 1024;  // the shared mode's row budget before opt-in

__device__ __forceinline__ int code_at(const uint8_t* p, long long i, bool is_signed) {
  const uint8_t b = __ldg(p + i);
  return is_signed ? static_cast<int>(static_cast<int8_t>(b)) : static_cast<int>(b);
}

__device__ __forceinline__ int ref_code(const uint8_t* p, int j, int lr, bool is_signed) {
  if (j >= lr) return kNever;
  const int c = code_at(p, j, is_signed);
  return c == 4 ? kNever : c;
}

template <int W>
__global__ void __launch_bounds__(kWarps * 32)
sw_strip_kernel(const uint8_t* __restrict__ queries, const uint8_t* __restrict__ refs,
                bool q_signed, bool r_signed, long long n_pairs, int n_t, int lq, int lr,
                int match, int mismatch, int gap, int* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long pair = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (pair >= n_pairs) return;  // the whole warp leaves together
  const long long qi = pair / n_t;
  const int ti = static_cast<int>(pair - qi * n_t);
  const uint8_t* qrow = queries + qi * lq;
  const uint8_t* rrow = refs + static_cast<long long>(ti) * lr;
  const int j0 = lane * W;
  const int edge_decay = (j0 - 1) * gap;  // H left of the strip = its decayed max + this

  int rc[W], h[W], colbest[W];
#pragma unroll
  for (int s = 0; s < W; ++s) {
    rc[s] = ref_code(rrow, j0 + s, lr, r_signed);
    h[s] = 0;
    colbest[s] = 0;
  }
  for (int i0 = 0; i0 < lq; i0 += 32) {
    const int mine = i0 + lane < lq ? code_at(qrow, i0 + lane, q_signed) : 4;
    const int n = min(32, lq - i0);
    for (int k = 0; k < n; ++k) {
      const int qc = __shfl_sync(kFull, mine, k);
      if (qc == 4) continue;  // the row is carried unchanged
      int diag = __shfl_up_sync(kFull, h[W - 1], 1);
      if (lane == 0) diag = 0;
      int base[W];  // max(up + gap, diag + sub, 0), from the previous row
      base[0] = __viaddmax_s32_relu(h[0], gap, diag + (rc[0] == qc ? match : mismatch));
#pragma unroll
      for (int s = 1; s < W; ++s) {
        base[s] = __viaddmax_s32_relu(h[s], gap, h[s - 1] + (rc[s] == qc ? match : mismatch));
      }
      int run = base[0];
#pragma unroll
      for (int s = 1; s < W; ++s) run = __viaddmax_s32(run, gap, base[s]);
      int u = run - (j0 + W - 1) * gap;  // the strip's decayed maximum
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(kFull, u, d);
        if (lane >= d) u = max(u, v);
      }
      const int left = __shfl_up_sync(kFull, u, 1) + edge_decay;  // H at column j0 - 1
      h[0] = lane ? __viaddmax_s32(left, gap, base[0]) : base[0];
#pragma unroll
      for (int s = 1; s < W; ++s) h[s] = __viaddmax_s32(h[s - 1], gap, base[s]);
#pragma unroll
      for (int s = 0; s < W; ++s) colbest[s] = max(colbest[s], h[s]);
    }
  }
  int best = 0;
#pragma unroll
  for (int s = 0; s < W; ++s) {
    if (j0 + s < lr) best = max(best, colbest[s]);
  }
  best = __reduce_max_sync(kFull, best);
  if (lane == 0) out[pair] = best;
}

__global__ void __launch_bounds__(kWarps * 32)
sw_shared_kernel(const uint8_t* __restrict__ queries, const uint8_t* __restrict__ refs,
                 bool q_signed, bool r_signed, long long n_pairs, int n_t, int lq, int lr,
                 int match, int mismatch, int gap, int* __restrict__ out) {
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
    const int mine = i0 + lane < lq ? code_at(qrow, i0 + lane, q_signed) : 4;
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
        const int sub = ref_code(rrow, j, lr, r_signed) == qc ? match : mismatch;
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

using StripKernel = void (*)(const uint8_t*, const uint8_t*, bool, bool, long long, int, int,
                             int, int, int, int, int*);

template <int W>
StripKernel strip_kernel(int w) {
  if constexpr (W > kMaxStrip) {
    return nullptr;
  } else {
    return w == W ? &sw_strip_kernel<W> : strip_kernel<W + 1>(w);
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

// The launch shape at this Lr: mode (0 registers, 1 shared memory), columns
// a lane (the strip, or 32-column chunks), warps a block, dynamic shared
// memory a block, registers a thread and local (spill) bytes a thread.
int sw_scores_info(int lr, int* out) {
  if (lr <= 0) return cudaErrorInvalidValue;
  cudaFuncAttributes attr{};
  cudaError_t err;
  if (lr <= 32 * kMaxStrip) {
    const int w = (lr + 31) / 32;
    err = cudaFuncGetAttributes(&attr, reinterpret_cast<const void*>(strip_kernel<1>(w)));
    out[0] = 0;
    out[1] = w;
    out[2] = kWarps;
    out[3] = 0;
  } else {
    int warps = 0, smem = 0;
    shared_shape(lr, &warps, &smem);
    err = cudaFuncGetAttributes(&attr, reinterpret_cast<const void*>(&sw_shared_kernel));
    out[0] = 1;
    out[1] = (lr + 31) / 32;
    out[2] = warps;
    out[3] = smem;
  }
  out[4] = attr.numRegs;
  out[5] = static_cast<int>(attr.localSizeBytes);
  return err;
}

// Launch on `stream` without synchronising: queries [n_q, lq] and refs
// [n_t, lr] bytes (int8 where *_signed, else uint8), out [n_q, n_t] int32.
// Empty shapes launch nothing. Returns cudaGetLastError().
int sw_scores_launch(const void* queries, const void* refs, int q_signed, int r_signed,
                     long long n_q, int n_t, int lq, int lr, int match, int mismatch, int gap,
                     void* out, void* stream) {
  if (n_q <= 0 || n_t <= 0 || lq <= 0 || lr <= 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* q = static_cast<const uint8_t*>(queries);
  const auto* r = static_cast<const uint8_t*>(refs);
  auto* o = static_cast<int*>(out);
  const long long pairs = n_q * n_t;
  if (lr <= 32 * kMaxStrip) {
    const long long blocks = (pairs + kWarps - 1) / kWarps;
    if (blocks > INT_MAX) return cudaErrorInvalidValue;
    const StripKernel kernel = strip_kernel<1>((lr + 31) / 32);
    kernel<<<static_cast<unsigned>(blocks), kWarps * 32, 0, s>>>(
        q, r, q_signed != 0, r_signed != 0, pairs, n_t, lq, lr, match, mismatch, gap, o);
    return cudaGetLastError();
  }
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
  sw_shared_kernel<<<static_cast<unsigned>(blocks), warps * 32, smem, s>>>(
      q, r, q_signed != 0, r_signed != 0, pairs, n_t, lq, lr, match, mismatch, gap, o);
  return cudaGetLastError();
}

const char* sw_scores_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
