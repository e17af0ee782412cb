// G = P * P^T with P = where(mask, clip(z, -zmax, zmax), 0) * region, for
// z [N, R] float32: the Gram matrix of the prepared z rows, from which the
// cohort step's squared distances follow.
//
// Replaces grid_tpu/ops/pallas_kernels.py:zprep_gram (_zprep_tile and
// _gram_kernel; pallas_call at line 93).
//
// What bounds it on the H100: the symmetric product's N*(N+1)*R flops
// (12.8 GFLOP at N=2504, R=2048) against N*R*5 bytes of input, so it is
// compute-bound. The
// neighbor lists must agree with a float32 Gram product up to ties, and
// plain TF32 (10 mantissa bits) misses that by far, while the float32 FMA
// units peak at ~67 TFLOP/s against the TF32 tensor cores' 495.
//
// What the design does about it: split precision on the tensor cores
// ("3xTF32"). A split pass writes P_big = tf32(P) and P_small =
// tf32(P - P_big) (round to nearest); G = big*small + small*big + big*big
// then carries ~21 bits of every product, as float32 does, in three TF32
// wgmma products. The tensor cores' own float32 accumulation truncates, so
// a long sum kept there drifts (50x the float32 error at R=2048, measured
// on the H100): each K-stage of 32 columns is summed into a fresh
// accumulator, the stage sums into `mid`, and every 8 of those into `acc`,
// with round-to-nearest float32 adds. At N=2504, R=2048 that lands at
// 0.56-0.77x the error of a cuBLAS float32 product against a float64 Gram.
//
// - Split pass: one block per row reads z, mask and region once and writes
//   both halves as float32 [N, R_pad], R_pad a multiple of the K-stage with
//   zero padding, so every TMA row stride is 16-byte aligned and the
//   padding adds exactly 0. The Pallas kernel's "P never reaches HBM" was a
//   TPU-side choice: writing P (~40 MB) is what lets TMA and wgmma take the
//   tiles unchanged.
// - Gram kernel: one block per 128x128 tile of the upper triangle (i <= j),
//   mapped from the linear block index, so half of G's tiles are computed.
//   A producer warpgroup (one issuing thread, registers given up with
//   setmaxnreg) keeps a 3-stage ring of shared memory full by TMA (128-byte
//   swizzle, mbarrier completion, zero fill past row N); two consumer
//   warpgroups each run m64n128k8 TF32 wgmma on 64 rows of the tile. A
//   diagonal tile loads its rows once and uses them as both operands. The
//   epilogue stages the tile in shared memory and writes G[i,j] and
//   G[j,i] = G[i,j]^T with coalesced rows, so G is exactly symmetric.
// - Bounds of this design: at N=2504 there are 210 upper tiles for 132 SMs
//   at one block per SM (192 KB of ring), i.e. two waves, the second 59%
//   full; each stage moves 64 KB from L2 for 3.1 MFLOP, and each consumer
//   waits for its stage's wgmma before adding the stage sum, so the
//   tensor cores idle while both warpgroups add or wait for data.
//
// Four modes share the split pass and the tile code; each has one C entry
// point that returns its cudaError_t:
//
// - triangle (zprep_gram_launch): the split, then G [N, N] as above.
// - split (zprep_split_launch): the split once per step of the row-panel
//   branch, then the diagonal tiles only, of which the kernel stores the
//   diagonal: the squared norms |P_i|^2 [N] from the same 3xTF32 product,
//   bitwise equal to the diagonal the triangle mode writes. d2 = |a|^2 +
//   |b|^2 - 2 G then cancels errors of one arithmetic, and two identical
//   rows are at distance exactly 0, as in the resident branch.
// - panel (zprep_gram_panel_launch): G[i0:i0+B, 0:N] [B, N] from the split
//   halves, one block per (row tile of the panel) x (column tile), with no
//   triangle mapping and no mirror store. The four row tiles of a 512-row
//   panel that share a column tile are neighbours in the launch order, so
//   the column tile is read from device memory about once per panel: each
//   panel streams the 2*N*R_pad float32 halves once (512 MB at N=65,536,
//   R=1024), against 3 * 2*B*N*R TF32 operations, 384 per byte at B=512
//   (the card's TF32 ridge is ~148), so the panels stay compute-bound: a
//   step's 128 panels do 2*N^2*R = 8.8 TFLOP of float32-accurate product,
//   17.8 ms at the 495 TFLOP/s peak. Measured on an H100 80GB HBM3 at
//   700 W (chip_smoke.py, phase 7): 0.56 ms per 512-row panel, 123 TFLOP/s
//   as 2*B*N*R (370 of TF32 work), 72 ms per step.
// - cross (zprep_gram_cross_launch): G = P_a P_b^T [Ba, Bb] for two row
//   blocks, each split by zprep_split_launch into a buffer of its own: the
//   sharded ring's product of a rank's rows with the visiting block
//   (grid_tpu/parallel/pknn.py computes it with jnp.dot outside Pallas).
//   Two pairs of tensor maps, one per buffer, take the place of the panel
//   mode's one; the tiles, the K-stage order and the accumulation are the
//   panel mode's, so every entry is bitwise the entry zprep_gram_panel
//   gives for the same two rows, given the blocks' global first rows a_off
//   and b_off. The panel mode takes the lower half of a diagonal tile from
//   its upper half (global rows i > j of one 128-row tile): a second launch
//   recomputes the few tiles that hold such pairs with the blocks' roles
//   swapped, one block per global tile both blocks touch, and stores those
//   entries only (one tile per 128 rows for a rank's own block, at most
//   two for the block just before it, none otherwise).
//
// The bfloat16 form is csrc/zprep_gram16.cu, the float64 form
// csrc/zprep_gram64.cu.

#include <cuda.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>
#include <stdio.h>

namespace {

constexpr int kTile = 128;        // rows and columns of G per block
constexpr int kTileK = 32;        // R columns per stage: one 128-byte swizzle row
constexpr int kStages = 3;        // depth of the shared-memory ring
constexpr int kMidStages = 8;     // stage sums added into acc in groups of this many
constexpr int kConsumers = 256;   // two warpgroups of wgmma
constexpr int kThreads = kConsumers + 128;  // + one producer warpgroup
constexpr int kOperandBytes = kTile * kTileK * 4;         // one 128 x 32 float32 tile
constexpr int kStageBytes = 4 * kOperandBytes;            // A big, A small, B big, B small
constexpr int kSmemBytes = kStages * kStageBytes + 1024;  // + slack to align to 1024
constexpr int kSplitThreads = 256;
constexpr int kEncodeError = 10000;  // + CUresult of a failed cuTensorMapEncodeTiled

enum Mode { kTriangle = 0, kPanel = 1, kDiagonal = 2, kCross = 3, kCrossMirror = 4 };

// Where a block's tile goes: G [n, n] (kTriangle), the panel G[i0:i0+rows]
// as [rows, n] (kPanel), the diagonal [n] (kDiagonal), or the cross block
// G [na, nb] (kCross, and kCrossMirror's entries of it).
struct Out {
  int mode;
  int n;
  int i0, rows;  // the panel's first row and its row count (kPanel)
  float* g;
  int na, nb;        // the cross blocks' row counts
  int a_off, b_off;  // their global first rows
  int t_lo;          // kCrossMirror: the global tile of block 0
};

static_assert(kTile * (kTile + 1) * 4 <= kStages * kStageBytes, "epilogue tile must fit the ring");

// nearest TF32 value, ties away from zero (cvt.rna.tf32.f32): the low 13
// mantissa bits are zero, so the tensor cores read it exactly
__device__ __forceinline__ float tf32_round(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
}

__global__ void __launch_bounds__(kSplitThreads)
split_kernel(const float* __restrict__ z, const uint8_t* __restrict__ mask,
             const uint8_t* __restrict__ region, float zmax, int r, int r_pad,
             float* __restrict__ big, float* __restrict__ small) {
  // a null mask or region keeps every entry: z is then prepared already
  const size_t in = static_cast<size_t>(blockIdx.x) * r;
  const size_t out = static_cast<size_t>(blockIdx.x) * r_pad;
  for (int c = threadIdx.x; c < r_pad; c += kSplitThreads) {
    float p = 0.f;
    if (c < r) {
      // the plain version's where(mask, clamp(z), 0) * region, NaN included
      const float v = z[in + c];
      const float clipped = isnan(v) ? v : fminf(fmaxf(v, -zmax), zmax);
      p = (!mask || mask[in + c] ? clipped : 0.f) * (!region || region[c] ? 1.f : 0.f);
    }
    const float b = tf32_round(p);
    big[out + c] = b;
    small[out + c] = tf32_round(p - b);  // p - b is exact
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
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

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile with 128-byte swizzle:
// rows of 128 bytes, 8-row groups 1024 bytes apart (SBO); LBO is unused
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3ffff) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// d (+)= A[64 x 8] * B[128 x 8]^T in TF32, float32 accumulators; d is
// overwritten when scale_d is 0
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma
__device__ __forceinline__ void fence_operands(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The two consumer warpgroups: the mainloop and the epilogue.
__device__ __forceinline__ void consume(uint32_t ring, uint32_t raw, uint8_t* smem_raw,
                                        uint64_t* full, uint64_t* empty, bool diag, int k_tiles,
                                        int row0, int col0, const Out out) {
  const int tid = threadIdx.x;
  const int wg = tid / 128;  // this warpgroup's rows: wg*64 .. wg*64+63 of the tile
  const int warp = (tid % 128) / 32, lane = tid % 32;
  float acc[64], mid[64], part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = mid[i] = part[i] = 0.f;

  for (int kt = 0; kt < k_tiles; ++kt) {
    const int s = kt % kStages;
    mbar_wait(smem_addr(&full[s]), (kt / kStages) & 1);
    const uint32_t stage = ring + s * kStageBytes;
    const uint32_t b_big = diag ? stage : stage + 2 * kOperandBytes;
    const uint64_t a_big_d = sw128_desc(stage + wg * 64 * kTileK * 4);
    const uint64_t a_small_d = sw128_desc(stage + kOperandBytes + wg * 64 * kTileK * 4);
    const uint64_t b_big_d = sw128_desc(b_big);
    const uint64_t b_small_d = sw128_desc(b_big + kOperandBytes);
    fence_operands(part);
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
    // small terms first; each k-step of 8 columns is 32 bytes further along
    // the swizzled row, i.e. +2 in the descriptor's 16-byte address units
#pragma unroll
    for (int j = 0; j < kTileK / 8; ++j) wgmma_tf32(part, a_big_d + 2 * j, b_small_d + 2 * j, j);
#pragma unroll
    for (int j = 0; j < kTileK / 8; ++j) wgmma_tf32(part, a_small_d + 2 * j, b_big_d + 2 * j, 1);
#pragma unroll
    for (int j = 0; j < kTileK / 8; ++j) wgmma_tf32(part, a_big_d + 2 * j, b_big_d + 2 * j, 1);
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    fence_operands(part);
    if (lane == 0) mbar_arrive(smem_addr(&empty[s]));  // the stage may be refilled
#pragma unroll
    for (int i = 0; i < 64; ++i) mid[i] += part[i];
    if ((kt + 1) % kMidStages == 0 || kt + 1 == k_tiles) {
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        acc[i] += mid[i];
        mid[i] = 0.f;
      }
    }
  }

  // Epilogue: both warpgroups are past their last wgmma and every copy has
  // landed, so the ring is free to stage the tile as [kTile][kTile + 1]
  // (the +1 keeps row and column reads free of bank conflicts).
  float* tile = reinterpret_cast<float*>(smem_raw + (ring - raw));
  constexpr int kLd = kTile + 1;
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    // wgmma's accumulator layout: warp w holds rows 16w..16w+15 of the 64
    const int row = wg * 64 + warp * 16 + lane / 4 + 8 * ((i >> 1) & 1);
    const int col = 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
    tile[row * kLd + col] = acc[i];
  }
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
  const int n = out.n;
  float* __restrict__ g = out.g;
  if (out.mode == kDiagonal) {
    for (int r = tid; r < kTile; r += kConsumers) {
      if (row0 + r < n) g[row0 + r] = tile[r * kLd + r];
    }
    return;
  }
  if (out.mode == kCross) {
    for (int idx = tid; idx < kTile * kTile; idx += kConsumers) {
      const int r = idx / kTile, c = idx % kTile;
      if (row0 + r < out.na && col0 + c < out.nb) {
        g[static_cast<size_t>(row0 + r) * out.nb + col0 + c] = tile[r * kLd + c];
      }
    }
    return;
  }
  if (out.mode == kCrossMirror) {
    // the tile's rows are b's rows j, its columns a's rows i: entry (i, j)
    // of G where the panel mode mirrors it, i > j in one global tile
    const int t = out.t_lo + static_cast<int>(blockIdx.x);
    for (int idx = tid; idx < kTile * kTile; idx += kConsumers) {
      const int r = idx / kTile, c = idx % kTile;
      const int jl = row0 + r, il = col0 + c;
      const long long j = static_cast<long long>(out.b_off) + jl;
      const long long i = static_cast<long long>(out.a_off) + il;
      if (jl < out.nb && il < out.na && i > j && i / kTile == t && j / kTile == t) {
        g[static_cast<size_t>(il) * out.nb + jl] = tile[r * kLd + c];
      }
    }
    return;
  }
  // the panel stores its rows i0 .. i0+rows-1 as rows 0 .. rows-1
  const int row_end = out.mode == kPanel ? out.i0 + out.rows : n;
  const int row_off = out.mode == kPanel ? out.i0 : 0;
  for (int idx = tid; idx < kTile * kTile; idx += kConsumers) {
    const int r = idx / kTile, c = idx % kTile;
    // a diagonal tile takes its lower half from its upper half: the two
    // cross terms meet in another order there
    const float v = diag && r > c ? tile[c * kLd + r] : tile[r * kLd + c];
    if (row0 + r < row_end && col0 + c < n) {
      g[static_cast<size_t>(row0 + r - row_off) * n + col0 + c] = v;
    }
  }
  if (out.mode == kTriangle && !diag) {  // G[j,i] = G[i,j]^T: the tile's columns become rows of G
    for (int idx = tid; idx < kTile * kTile; idx += kConsumers) {
      const int c = idx / kTile, r = idx % kTile;
      const float v = tile[r * kLd + c];
      if (row0 + r < n && col0 + c < n) g[static_cast<size_t>(col0 + c) * n + row0 + r] = v;
    }
  }
}

// The A operand's rows come from a_big/a_small, the B operand's from
// b_big/b_small; every mode but the two cross modes passes one buffer's
// maps as both.
__global__ void __launch_bounds__(kThreads, 1)
gram_kernel(const __grid_constant__ CUtensorMap a_big, const __grid_constant__ CUtensorMap a_small,
            const __grid_constant__ CUtensorMap b_big, const __grid_constant__ CUtensorMap b_small,
            int k_tiles, int tiles, int panel_row_tiles, const Out out) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages];   // TMA bytes of a stage have landed
  __shared__ __align__(8) uint64_t empty[kStages];  // every consumer warp is done with it
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t ring = (raw + 1023) & ~1023u;  // swizzle atoms are 1024-byte aligned

  int row0, col0;
  if (out.mode == kTriangle) {
    // upper-triangle tile (ti, tj), ti <= tj, in row-major order
    int ti = 0, rem = blockIdx.x;
    while (rem >= tiles - ti) {
      rem -= tiles - ti;
      ++ti;
    }
    row0 = ti * kTile;
    col0 = (ti + rem) * kTile;
  } else if (out.mode == kPanel) {
    // the panel's row tiles of one column tile are neighbours in the launch
    // order, so they share that column tile's loads through L2
    row0 = out.i0 + (blockIdx.x % panel_row_tiles) * kTile;
    col0 = (blockIdx.x / panel_row_tiles) * kTile;
  } else if (out.mode == kCross) {
    // as in the panel mode: a's row tiles of one b tile are neighbours
    row0 = (blockIdx.x % panel_row_tiles) * kTile;
    col0 = (blockIdx.x / panel_row_tiles) * kTile;
  } else if (out.mode == kCrossMirror) {
    // A is b's rows, B is a's rows, each from where global tile t starts
    const int t0 = (out.t_lo + static_cast<int>(blockIdx.x)) * kTile;
    row0 = max(t0, out.b_off) - out.b_off;
    col0 = max(t0, out.a_off) - out.a_off;
  } else {
    row0 = col0 = blockIdx.x * kTile;
  }
  // a diagonal tile reads its rows once; the cross modes' operands are
  // two buffers, whatever their rows
  const bool diag = row0 == col0 && out.mode != kCross && out.mode != kCrossMirror;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(smem_addr(&full[s]), 1);
      mbar_init(smem_addr(&empty[s]), kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {  // the producer warpgroup; one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (tid == kConsumers) {
      const uint32_t bytes = (diag ? 2 : 4) * kOperandBytes;
      for (int kt = 0; kt < k_tiles; ++kt) {
        const int s = kt % kStages, round = kt / kStages;
        if (round > 0) mbar_wait(smem_addr(&empty[s]), (round - 1) & 1);
        const uint32_t stage = ring + s * kStageBytes, bar = smem_addr(&full[s]);
        mbar_expect_tx(bar, bytes);
        tma_load(stage, &a_big, bar, kt * kTileK, row0);
        tma_load(stage + kOperandBytes, &a_small, bar, kt * kTileK, row0);
        if (!diag) {
          tma_load(stage + 2 * kOperandBytes, &b_big, bar, kt * kTileK, col0);
          tma_load(stage + 3 * kOperandBytes, &b_small, bar, kt * kTileK, col0);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    consume(ring, raw, smem_raw, full, empty, diag, k_tiles, row0, col0, out);
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, found through the runtime so that
// nothing links against libcuda
int encode_tiled(EncodeTiled* out) {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || p == nullptr) return cudaErrorSymbolNotFound;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  *out = fn;
  return cudaSuccess;
}

// [n, r_pad] float32 rows, read as 128 x 32 boxes with 128-byte swizzle;
// rows past n read as zeros
int make_map(CUtensorMap* map, float* base, int n, int r_pad) {
  EncodeTiled encode;
  const int err = encode_tiled(&encode);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(r_pad), static_cast<cuuint64_t>(n)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(r_pad) * sizeof(float)};
  const cuuint32_t box[2] = {kTileK, kTile};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, base, dims, strides, box,
                              elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : kEncodeError + static_cast<int>(res);
}

long long upper_tiles(int n) {
  const long long t = (n + kTile - 1) / kTile;
  return t * (t + 1) / 2;
}

int split(const void* z, const void* mask, const void* region, float zmax, int n, int r,
          int r_pad, float* big, float* small, cudaStream_t s) {
  split_kernel<<<n, kSplitThreads, 0, s>>>(static_cast<const float*>(z),
                                            static_cast<const uint8_t*>(mask),
                                            static_cast<const uint8_t*>(region), zmax, r, r_pad,
                                            big, small);
  return static_cast<int>(cudaGetLastError());
}

// The Gram kernel over `blocks` tiles: A's rows from the halves of `na`
// rows at a_big / a_small, B's from those of `nb` rows at b_big / b_small
// (the same buffer but in the cross modes).
int gram(float* a_big, float* a_small, int na, float* b_big, float* b_small, int nb, int r_pad,
         int blocks, int panel_row_tiles, const Out& out, cudaStream_t s) {
  CUtensorMap maps[4];
  float* bases[4] = {a_big, a_small, b_big, b_small};
  const int rows[4] = {na, na, nb, nb};
  int err;
  for (int m = 0; m < 4; ++m) {
    if ((err = make_map(&maps[m], bases[m], rows[m], r_pad)) != cudaSuccess) return err;
  }
  err = cudaFuncSetAttribute(gram_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  gram_kernel<<<blocks, kThreads, kSmemBytes, s>>>(maps[0], maps[1], maps[2], maps[3],
                                                   r_pad / kTileK, (na + kTile - 1) / kTile,
                                                   panel_row_tiles, out);
  return static_cast<int>(cudaGetLastError());
}

// One buffer's halves as both operands.
int gram(float* big, float* small, int n, int r_pad, int blocks, int panel_row_tiles,
         const Out& out, cudaStream_t s) {
  return gram(big, small, n, big, small, n, r_pad, blocks, panel_row_tiles, out, s);
}

bool bad_shape(int n, int r, int r_pad) {
  return r_pad < r || r_pad <= 0 || r_pad % kTileK != 0 || upper_tiles(n) > INT_MAX;
}

}  // namespace

extern "C" {

// Launch the split pass and the Gram kernel on `stream` without
// synchronising. `split_buf` is scratch of 2 * n * r_pad float32 (r_pad >=
// r, a multiple of 32); returns a cudaError_t, or 10000 + the CUresult of a
// failed tensor-map encoding.
int zprep_gram_launch(const void* z, const void* mask, const void* region, float zmax, int n,
                      int r, int r_pad, void* split_buf, void* g, void* stream) {
  if (n <= 0) return cudaSuccess;
  if (bad_shape(n, r, r_pad)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* big = static_cast<float*>(split_buf);
  float* small = big + static_cast<size_t>(n) * r_pad;
  int err = split(z, mask, region, zmax, n, r, r_pad, big, small, s);
  if (err != cudaSuccess) return err;
  const Out out{kTriangle, n, 0, n, static_cast<float*>(g)};
  return gram(big, small, n, r_pad, static_cast<int>(upper_tiles(n)), 1, out, s);
}

// The row-panel branch's pass once per step: the split into `split_buf`
// (as above; a null mask or region keeps every entry), then the squared
// norms of P's rows, norms [n], as the diagonal of the 3xTF32 Gram product.
int zprep_split_launch(const void* z, const void* mask, const void* region, float zmax, int n,
                       int r, int r_pad, void* split_buf, void* norms, void* stream) {
  if (n <= 0) return cudaSuccess;
  if (bad_shape(n, r, r_pad)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* big = static_cast<float*>(split_buf);
  float* small = big + static_cast<size_t>(n) * r_pad;
  int err = split(z, mask, region, zmax, n, r, r_pad, big, small, s);
  if (err != cudaSuccess) return err;
  const Out out{kDiagonal, n, 0, n, static_cast<float*>(norms)};
  return gram(big, small, n, r_pad, (n + kTile - 1) / kTile, 1, out, s);
}

// One row panel, G[i0:i0+rows, 0:n] into g [rows, n], from the halves that
// zprep_split_launch wrote into `split_buf`.
int zprep_gram_panel_launch(void* split_buf, int n, int r_pad, int i0, int rows, void* g,
                            void* stream) {
  if (rows <= 0) return cudaSuccess;
  if (bad_shape(n, 0, r_pad) || i0 < 0 || rows > n - i0) return cudaErrorInvalidValue;
  float* big = static_cast<float*>(split_buf);
  float* small = big + static_cast<size_t>(n) * r_pad;
  const long long row_tiles = (rows + kTile - 1) / kTile;
  const long long blocks = row_tiles * ((n + kTile - 1) / kTile);
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  const Out out{kPanel, n, i0, rows, static_cast<float*>(g)};
  return gram(big, small, n, r_pad, static_cast<int>(blocks), static_cast<int>(row_tiles), out,
              static_cast<cudaStream_t>(stream));
}

// The ring's block product, G = P_a P_b^T into g [na, nb], from the halves
// that zprep_split_launch wrote into `a_buf` (na rows) and `b_buf` (nb
// rows), with the entries zprep_gram_panel_launch gives rows a_off + i and
// b_off + j of one split of all rows: the cross tiles, then the tiles whose
// entries the panel mode mirrors (see the header).
int zprep_gram_cross_launch(void* a_buf, int na, void* b_buf, int nb, int r_pad, int a_off,
                            int b_off, void* g, void* stream) {
  if (na <= 0 || nb <= 0) return cudaSuccess;
  if (bad_shape(na, 0, r_pad) || bad_shape(nb, 0, r_pad) || a_off < 0 || b_off < 0 ||
      a_off > INT_MAX - na || b_off > INT_MAX - nb) {
    return cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* a_big = static_cast<float*>(a_buf);
  float* a_small = a_big + static_cast<size_t>(na) * r_pad;
  float* b_big = static_cast<float*>(b_buf);
  float* b_small = b_big + static_cast<size_t>(nb) * r_pad;
  const long long row_tiles = (na + kTile - 1) / kTile;
  const long long blocks = row_tiles * ((nb + kTile - 1) / kTile);
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  Out out{kCross, nb, 0, na, static_cast<float*>(g), na, nb, a_off, b_off, 0};
  int err = gram(a_big, a_small, na, b_big, b_small, nb, r_pad, static_cast<int>(blocks),
                 static_cast<int>(row_tiles), out, s);
  if (err != cudaSuccess) return err;
  // the global tiles that hold rows of both blocks
  const int a_last = (a_off + na - 1) / kTile, b_last = (b_off + nb - 1) / kTile;
  const int t_lo = a_off / kTile > b_off / kTile ? a_off / kTile : b_off / kTile;
  const int t_hi = a_last < b_last ? a_last : b_last;
  if (t_lo > t_hi) return cudaSuccess;
  out.mode = kCrossMirror;
  out.t_lo = t_lo;
  return gram(b_big, b_small, nb, a_big, a_small, na, r_pad, t_hi - t_lo + 1, 1, out, s);
}

// The Gram kernel's launch shape for n rows, for reports: out = {tile,
// k_tile, stages, threads per block, dynamic shared memory per block,
// blocks (upper tiles), resident blocks per SM}. Returns a cudaError_t.
int zprep_gram_info(int n, int* out) {
  int err = cudaFuncSetAttribute(gram_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kSmemBytes);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gram_kernel, kThreads, kSmemBytes);
  if (err != cudaSuccess) return err;
  const int info[7] = {kTile, kTileK, kStages, kThreads, kSmemBytes,
                       static_cast<int>(upper_tiles(n)), per_sm};
  for (int i = 0; i < 7; ++i) out[i] = info[i];
  return cudaSuccess;
}

const char* zprep_gram_error_string(int err) {
  if (err >= kEncodeError) {
    static thread_local char msg[64];
    snprintf(msg, sizeof msg, "cuTensorMapEncodeTiled failed, CUresult %d", err - kEncodeError);
    return msg;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
