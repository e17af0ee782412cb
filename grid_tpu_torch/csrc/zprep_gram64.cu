// The float64 form of csrc/zprep_gram.cu: G = P * P^T with
// P = where(mask, clip(z, -zmax, zmax), 0) * region, for z [N, R] float64,
// on the H100's FP64 tensor cores.
//
// Replaces grid_tpu/ops/pallas_kernels.py:zprep_gram (_zprep_tile and
// _gram_kernel; pallas_call at line 93) at device.dtype float64, where the
// JAX step computes the same product in float64.
//
// What bounds it on the H100: the symmetric product's N*(N+1)*R flops
// (12.8 GFLOP at N=2504, R=2048; a panel needs every product, 2*B*N*R =
// 68.7 GFLOP per 512-row panel at N=65,536, R=1024) against N*R*9 bytes of
// input: compute-bound, at the FP64 tensor cores' 67 TFLOP/s (NVIDIA's
// H100 SXM data sheet), 0.19 ms and 1.03 ms. wgmma has no f64 form; the
// f64 tensor-core instructions are mma.sync m8n8k4 (sm_80) and m16n8k4,
// m16n8k8, m16n8k16 (sm_90), whose products and sums are IEEE float64, so
// no split (the float32 kernel's 3xTF32) is needed for the float64
// contract.
//
// Design (scripts/dmma_shapes.py measured what it rests on, on an H100
// 80GB HBM3 at 700 W; PERF.md):
//
// - The mma shape: m16n8k16. Alone, with no memory traffic, m8n8k4 (the
//   first design's) reaches half the FP64 tensor rate, 33 TFLOP/s, and
//   m16n8k4, m16n8k8 and m16n8k16 all of it, 66-67, within noise of one
//   another. In this kernel m16n8k16 was the fastest of the three (a
//   512-row panel at N=65,536 in 1.175 ms, against 1.187 for m16n8k8 and
//   1.195 for m16n8k4). Its fragments follow CuTe's
//   SM90_16x8x16_F64F64F64F64_TN layout: lane (g, t) = (lane / 4, lane % 4)
//   holds A[g + 8h][t + 4q] as a[h + 2q], B[t + 4q][g] as b[q] and
//   D[g + 8h][2t + e] as d[2h + e].
// - Tiles: one block per 128x128 tile of G, 8 consumer warps of a 64x32
//   part each as 4x4 m16n8 tiles: 64 float64 accumulators (128 registers) a
//   thread, half the SM's register file, so one block an SM. A tile does
//   2*128*128*R flops on (128 + 128)*R*8 bytes from L2: 16 flops a byte,
//   twice the 64x64 tiles' 8 (4.3 GB of L2 reads per 512-row panel at
//   N=65,536 where 64x64 tiles read 8.6 GB). A 128x256 tile would need the
//   whole register file for its accumulators. L2 does not set the pace: a
//   probe that loads one operand a tile (half the bytes) ran the panel in
//   the same time.
// - The ring: 4 stages of 16 R columns, 128 x 16 float64 of
//   each operand (32 KB a stage), in dynamic shared memory. A producer
//   warpgroup fills it by TMA (one issuing thread; 128-byte swizzle, zero
//   fill past row N) on a `full` mbarrier a stage, and each consumer warp
//   arrives on the stage's `empty` mbarrier when it is done with it: one
//   barrier a stage, none block-wide in the loop. The producers give their
//   registers to the consumers (setmaxnreg: 232 a consumer thread, no
//   spill; a lone producer warp's 288-thread block is capped at 168 and
//   spilled). The first design had the consumer warps start 8 cp.async
//   copies a thread a stage behind a __syncthreads a stage: 1.58 ms a
//   panel, 1.29 without the copies, 1.19 without the barriers too; with
//   the TMA ring 1.22 (the same epilogue). Six stages ran within 1.3% of
//   four (3 as 5 in the first design): with one block an SM, three stages
//   in flight cover the copies. A diagonal tile
//   (the split's every tile) loads its rows once and uses them as both
//   operands. ldmatrix has no 64-bit form.
// - Shared-memory banks: TMA writes each operand's 128-byte rows dense,
//   their 16-byte chunks XORed with the row's index mod 8. Lane t's value
//   q of a stage (its K = t + 4q) is read from column 8(t / 2) + 2q + t % 2
//   (chunk 4(t / 2) + q), one permutation of a stage's 16 columns for every
//   row, operand and mode: a half-warp's 16 8-byte loads (rows g = 0..3,
//   lanes t = 0..3) then hit 16 distinct chunk halves, all 32 banks.
// - Filling the card: one tile a block, as many blocks as tiles. At
//   N=2504 the upper triangle is 20*21/2 = 210 tiles, 1.59 waves on 132
//   SMs; the second wave is 59% full (~0.05 ms of idle SMs at peak). A
//   persistent walk does not change that count, a smaller tile halves the
//   flops a byte, and split-K would have to split the split's norms the
//   same way and add a second pass; the N=2504 step is host-bound, so the
//   tail stays. A 512-row panel at N=65,536 is 4 x 512 = 2,048 tiles, 15.5
//   waves; its 4 row tiles of one column tile are neighbours in the
//   launch order, so P (537 MB) leaves device memory about once a panel.
// - One sum order: every entry is summed stage by stage in K order, the
//   stage's columns in the permuted order above, in all three modes, so
//   the split's norms are bitwise the diagonal of the triangle's G and of
//   each panel's G[i, i].
// - Epilogue: a panel's tile off the diagonal has no mirror, and each lane
//   stores its pairs of G from its registers (a warp's store covers 8 rows
//   of 64 whole bytes): 1.175 ms a panel, against 1.224 when it was staged
//   as below (a probe that stored nothing ran in 1.177). Otherwise the
//   ring, free after the last stage, stages the tile as [128][129] float64
//   (the odd stride keeps row and column reads free of bank conflicts),
//   written with coalesced rows: G[i, j], and in the triangle G[j, i] from
//   the tile's columns. A diagonal tile takes its lower half from its
//   upper half (in the triangle and the panels, as the float32 kernel
//   does), so G is exactly symmetric.
//
// Four modes share the tile code (the first three the prep pass too); each
// has one C entry point that returns its cudaError_t, or 10000 + the
// CUresult of a failed tensor-map encoding:
//
// - triangle (zprep_gram64_launch): the prep, then the upper-triangle tiles
//   (i <= j) of G [N, N], each with its mirror.
// - split (zprep_split64_launch): the prep once per step of the row-panel
//   branch (P stays in the buffer for the panels), then the diagonal tiles
//   only, of which the kernel stores the diagonal: the squared norms
//   |P_i|^2 [N].
// - panel (zprep_gram64_panel_launch): G[i0:i0+B, 0:N] [B, N] from P, one
//   block per (row tile of the panel) x (column tile).
// - cross (zprep_gram64_cross_launch): G = P_a P_b^T [Ba, Bb] for two row
//   blocks, each prepared by zprep_split64_launch into a P of its own: the
//   sharded ring's product of a rank's rows with the visiting block at
//   device.dtype float64 (grid_tpu/parallel/pknn.py:74 computes it with
//   jnp.dot in z's dtype, outside Pallas). B's rows come through a second
//   tensor map; the tiles, the K order and the stores from registers are
//   the panel mode's (a's row tiles of one b tile neighbours in the launch
//   order), so every entry is bitwise the entry zprep_gram64_panel_launch
//   gives rows a_off + i and b_off + j of one P of all rows. The panel mode
//   takes the lower half of a diagonal tile from its upper half; in float64
//   that changes no bit, because the products are symmetric: an FP64 mma
//   adds each entry's K products as fused multiply-adds in one K order for
//   every entry, and a * b + c rounds as b * a + c, so G[j, i] computed
//   with the operands swapped is G[i, j] bit for bit (held on the card by
//   tests/test_torch_gpu.py against a panel that starts off a tile, whose
//   tiles are all computed, none mirrored). So one launch does it, where
//   the float32 kernel's 3xTF32 cross terms meet in another order and need
//   a second launch for the mirrored tiles; a_off and b_off are checked
//   and place no entry.

#include <cuda.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kTile = 128;         // rows and columns of G per block
constexpr int kTileK = 16;         // R columns per stage: one 128-byte swizzle row and one
                                   // m16n8k16 step
constexpr int kStages = 4;
constexpr int kConsumerWarps = 8;  // a 64x32 part of the tile each
constexpr int kConsumers = 32 * kConsumerWarps;
constexpr int kThreads = kConsumers + 128;  // + the producer warpgroup
constexpr int kProducerRegs = 40;             // setmaxnreg: 128 x 40 + 256 x 232 <= 65,536
constexpr int kConsumerRegs = 232;
constexpr int kPrepThreads = 256;
constexpr int kOperandBytes = kTile * kTileK * 8;  // one 128 x 16 float64 tile
constexpr int kStageBytes = 2 * kOperandBytes;
constexpr int kOutLd = kTile + 1;                  // the staged tile's row stride
constexpr int kRingBytes = kStages * kStageBytes > kTile * kOutLd * 8 ? kStages * kStageBytes
                                                                      : kTile * kOutLd * 8;
constexpr int kSmemBytes = kRingBytes + 1024;  // + slack to align the ring to 1024
constexpr int kEncodeError = 10000;            // + CUresult of a failed cuTensorMapEncodeTiled

static_assert(kSmemBytes <= 232448, "an H100 block takes at most 227 KB of shared memory");

enum Mode { kTriangle = 0, kPanel = 1, kDiagonal = 2, kCross = 3 };

// Where a block's tile goes: G [n, n] (kTriangle), the panel G[i0:i0+rows]
// as [rows, n] (kPanel), the diagonal [n] (kDiagonal), or the cross block
// G [rows, n] (kCross: rows = Ba, n = Bb, i0 = 0).
struct Out {
  int mode;
  int n;
  int i0, rows;  // the panel's first row and its row count (kPanel, kCross)
  double* g;
};

__global__ void __launch_bounds__(kPrepThreads)
prep_kernel(const double* __restrict__ z, const uint8_t* __restrict__ mask,
            const uint8_t* __restrict__ region, double zmax, int r, int r_pad,
            double* __restrict__ p) {
  // a null mask or region keeps every entry: z is then prepared already
  const size_t in = static_cast<size_t>(blockIdx.x) * r;
  const size_t out = static_cast<size_t>(blockIdx.x) * r_pad;
  for (int c = threadIdx.x; c < r_pad; c += kPrepThreads) {
    double v = 0.0;
    if (c < r) {
      // the plain version's where(mask, clamp(z), 0) * region, NaN included
      const double x = z[in + c];
      const double clipped = isnan(x) ? x : fmin(fmax(x, -zmax), zmax);
      v = (!mask || mask[in + c] ? clipped : 0.0) * (!region || region[c] ? 1.0 : 0.0);
    }
    p[out + c] = v;
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

// d += a * b for one 16x8 float64 tile over 16 columns (the fragments of
// the note at the top)
__device__ __forceinline__ void dmma(double (&d)[4], const double (&a)[8], const double (&b)[4]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7, %8, %9, %10, %11}, {%12, %13, %14, %15}, "
      "{%0, %1, %2, %3};"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]), "d"(a[6]),
        "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
}

// The A operand's rows (the tile's rows) come through map_a, the B
// operand's (its columns) through map_b; every mode but kCross passes one
// P's map as both.
__global__ void __launch_bounds__(kThreads, 1)
gram64_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
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
  } else if (out.mode == kPanel || out.mode == kCross) {
    // the panel's row tiles of one column tile are neighbours in the launch
    // order, so they share that column tile's loads through L2 (kCross: a's
    // row tiles of one b tile)
    row0 = out.i0 + (blockIdx.x % panel_row_tiles) * kTile;
    col0 = (blockIdx.x / panel_row_tiles) * kTile;
  } else {
    row0 = col0 = blockIdx.x * kTile;
  }
  // one operand, read once; the cross mode's operands are two P's, whatever
  // their rows
  const bool diag = row0 == col0 && out.mode != kCross;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(smem_addr(&full[s]), 1);
      mbar_init(smem_addr(&empty[s]), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {  // the producer warpgroup; one thread starts every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (tid == kConsumers) {
      for (int kt = 0; kt < k_tiles; ++kt) {
        const int s = kt % kStages, round = kt / kStages;
        if (round > 0) mbar_wait(smem_addr(&empty[s]), (round - 1) & 1);
        const uint32_t stage = ring + s * kStageBytes, bar = smem_addr(&full[s]);
        mbar_expect_tx(bar, diag ? kOperandBytes : kStageBytes);
        tma_load(stage, &map_a, bar, kt * kTileK, row0);
        if (!diag) tma_load(stage + kOperandBytes, &map_b, bar, kt * kTileK, col0);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
  const int wr = (warp / 4) * 64, wc = (warp % 4) * 32;  // this warp's 64x32 part of the tile
  const int g = lane >> 2, t = lane & 3;
  // where lane (g, t) finds its value q of a stage in a row r = g (mod 8)
  // of an operand: column 8(t / 2) + 2q + t % 2 under the swizzle
  int at[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) at[q] = (((4 * (t >> 1) + q) ^ g) << 1) + (t & 1);
  double acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0;

  const double* ring_ptr = reinterpret_cast<const double*>(smem_raw + (ring - raw));
  for (int kt = 0; kt < k_tiles; ++kt) {
    const int s = kt % kStages;
    mbar_wait(smem_addr(&full[s]), (kt / kStages) & 1);
    const double* a = ring_ptr + s * (kStageBytes / 8) + (wr + g) * kTileK;
    const double* b = ring_ptr + s * (kStageBytes / 8) + (diag ? 0 : kOperandBytes / 8) +
                      (wc + g) * kTileK;
    double fb[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) fb[j][q] = b[8 * j * kTileK + at[q]];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      double fa[8];
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int h = 0; h < 2; ++h) fa[h + 2 * q] = a[(16 * i + 8 * h) * kTileK + at[q]];
#pragma unroll
      for (int j = 0; j < 4; ++j) dmma(acc[i][j], fa, fb[j]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(smem_addr(&empty[s]));  // the stage may be refilled
  }

  const int n_out = out.n;
  double* __restrict__ gout = out.g;
  if ((out.mode == kPanel || out.mode == kCross) && !diag) {
    // a panel's (or a cross block's) tile has no mirror: each lane stores
    // its pairs G[i, j], G[i, j + 1] from its registers, 16-byte aligned
    // where n is even (the 4 lanes of a row 64 contiguous bytes)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int gi = row0 + wr + 16 * i + g + 8 * h, gj = col0 + wc + 8 * j + 2 * t;
          if (gi >= out.i0 + out.rows || gj >= n_out) continue;
          double* dst = gout + static_cast<size_t>(gi - out.i0) * n_out + gj;
          if ((n_out & 1) == 0) {
            *reinterpret_cast<double2*>(dst) = make_double2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
          } else {
            dst[0] = acc[i][j][2 * h];
            if (gj + 1 < n_out) dst[1] = acc[i][j][2 * h + 1];
          }
        }
    return;
  }

  // Epilogue: every stage has landed and, past the barrier, every consumer
  // warp is past its last fragment load, so the ring stages the tile.
  double* tile = reinterpret_cast<double*>(smem_raw + (ring - raw));
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = wr + 16 * i + g + 8 * (e >> 1), c = wc + 8 * j + 2 * t + (e & 1);
        tile[r * kOutLd + c] = acc[i][j][e];
      }
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
  if (out.mode == kDiagonal) {
    for (int r = tid; r < kTile; r += kConsumers) {
      if (row0 + r < n_out) gout[row0 + r] = tile[r * kOutLd + r];
    }
    return;
  }
  // the panel stores its rows i0 .. i0+rows-1 as rows 0 .. rows-1
  const int row_end = out.mode == kPanel ? out.i0 + out.rows : n_out;
  const int row_off = out.mode == kPanel ? out.i0 : 0;
  for (int idx = tid; idx < kTile * kTile; idx += kConsumers) {
    const int r = idx / kTile, c = idx % kTile;
    const double v = diag && r > c ? tile[c * kOutLd + r] : tile[r * kOutLd + c];
    if (row0 + r < row_end && col0 + c < n_out) {
      gout[static_cast<size_t>(row0 + r - row_off) * n_out + col0 + c] = v;
    }
  }
  if (out.mode == kTriangle && !diag) {  // G[j, i] = G[i, j]: the tile's columns become rows
    for (int idx = tid; idx < kTile * kTile; idx += kConsumers) {
      const int c = idx / kTile, r = idx % kTile;
      if (row0 + r < n_out && col0 + c < n_out) {
        gout[static_cast<size_t>(col0 + c) * n_out + row0 + r] = tile[r * kOutLd + c];
      }
    }
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

// P [n, r_pad] float64, read as 128 x 16 boxes with 128-byte swizzle; rows
// past n read as zeros
int make_map(CUtensorMap* map, const double* p, int n, int r_pad) {
  EncodeTiled encode;
  const int err = encode_tiled(&encode);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(r_pad), static_cast<cuuint64_t>(n)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(r_pad) * sizeof(double)};
  const cuuint32_t box[2] = {kTileK, kTile};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT64, 2, const_cast<double*>(p),
                              dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : kEncodeError + static_cast<int>(res);
}

long long upper_tiles(int n) {
  const long long t = (n + kTile - 1) / kTile;
  return t * (t + 1) / 2;
}

bool bad_shape(int n, int r, int r_pad) {
  return r_pad < r || r_pad <= 0 || r_pad % kTileK != 0 || upper_tiles(n) > INT_MAX;
}

// blocks of a mode at n rows (rows: the panel's; kCross: n = Bb, rows = Ba)
long long mode_blocks(int mode, int n, int rows) {
  const long long tiles = (n + kTile - 1) / kTile;
  if (mode == kTriangle) return upper_tiles(n);
  if (mode == kPanel || mode == kCross) return (rows + kTile - 1) / kTile * tiles;
  return tiles;
}

int prep(const void* z, const void* mask, const void* region, double zmax, int n, int r,
         int r_pad, double* p, cudaStream_t s) {
  prep_kernel<<<n, kPrepThreads, 0, s>>>(static_cast<const double*>(z),
                                          static_cast<const uint8_t*>(mask),
                                          static_cast<const uint8_t*>(region), zmax, r, r_pad, p);
  return static_cast<int>(cudaGetLastError());
}

// lets the kernel take kSmemBytes of dynamic shared memory, once a process
int configure() {
  static std::atomic<bool> done{false};
  if (done.load(std::memory_order_acquire)) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      gram64_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err == cudaSuccess) done.store(true, std::memory_order_release);
  return err;
}

// A's rows from pa [na, r_pad], B's from pb [nb, r_pad]; one P but in the
// cross mode
int gram(const double* pa, int na, const double* pb, int nb, int r_pad, int blocks,
         int panel_row_tiles, const Out& out, cudaStream_t s) {
  CUtensorMap map_a, map_b;
  int err = make_map(&map_a, pa, na, r_pad);
  if (err != cudaSuccess) return err;
  if ((err = make_map(&map_b, pb, nb, r_pad)) != cudaSuccess) return err;
  if ((err = configure()) != cudaSuccess) return err;
  gram64_kernel<<<blocks, kThreads, kSmemBytes, s>>>(map_a, map_b, r_pad / kTileK,
                                                     (nb + kTile - 1) / kTile, panel_row_tiles,
                                                     out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launch the prep pass and the Gram kernel on `stream` without
// synchronising: z [n, r] float64 (mask [n, r] and region [r] bytes) in,
// g [n, n] float64 out. `p_buf` is scratch of n * r_pad float64 (r_pad >=
// r, a multiple of 16).
int zprep_gram64_launch(const void* z, const void* mask, const void* region, double zmax, int n,
                        int r, int r_pad, void* p_buf, void* g, void* stream) {
  if (n <= 0) return cudaSuccess;
  if (bad_shape(n, r, r_pad)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  double* p = static_cast<double*>(p_buf);
  int err = prep(z, mask, region, zmax, n, r, r_pad, p, s);
  if (err != cudaSuccess) return err;
  const Out out{kTriangle, n, 0, n, static_cast<double*>(g)};
  return gram(p, n, p, n, r_pad, static_cast<int>(upper_tiles(n)), 1, out, s);
}

// The row-panel branch's pass once per step: the prep into `p_buf` (as
// above; a null mask or region keeps every entry), then the squared norms
// of P's rows, norms [n], as the diagonal of the tile product.
int zprep_split64_launch(const void* z, const void* mask, const void* region, double zmax, int n,
                         int r, int r_pad, void* p_buf, void* norms, void* stream) {
  if (n <= 0) return cudaSuccess;
  if (bad_shape(n, r, r_pad)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  double* p = static_cast<double*>(p_buf);
  int err = prep(z, mask, region, zmax, n, r, r_pad, p, s);
  if (err != cudaSuccess) return err;
  const Out out{kDiagonal, n, 0, n, static_cast<double*>(norms)};
  return gram(p, n, p, n, r_pad, static_cast<int>(mode_blocks(kDiagonal, n, n)), 1, out, s);
}

// One row panel, G[i0:i0+rows, 0:n] into g [rows, n], from the P that
// zprep_split64_launch wrote into `p_buf`.
int zprep_gram64_panel_launch(const void* p_buf, int n, int r_pad, int i0, int rows, void* g,
                              void* stream) {
  if (rows <= 0) return cudaSuccess;
  if (bad_shape(n, 0, r_pad) || i0 < 0 || rows > n - i0) return cudaErrorInvalidValue;
  const long long blocks = mode_blocks(kPanel, n, rows);
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  const Out out{kPanel, n, i0, rows, static_cast<double*>(g)};
  const double* p = static_cast<const double*>(p_buf);
  return gram(p, n, p, n, r_pad, static_cast<int>(blocks),
              static_cast<int>((rows + kTile - 1) / kTile), out,
              static_cast<cudaStream_t>(stream));
}

// The ring's block product, G = P_a P_b^T into g [na, nb], from the P's
// that zprep_split64_launch wrote into `a_buf` (na rows) and `b_buf` (nb
// rows): the entries zprep_gram64_panel_launch gives rows a_off + i and
// b_off + j of one P of all rows (see the header: one launch, no mirror).
int zprep_gram64_cross_launch(const void* a_buf, int na, const void* b_buf, int nb, int r_pad,
                              int a_off, int b_off, void* g, void* stream) {
  if (na <= 0 || nb <= 0) return cudaSuccess;
  if (bad_shape(na, 0, r_pad) || bad_shape(nb, 0, r_pad) || a_off < 0 || b_off < 0 ||
      a_off > INT_MAX - na || b_off > INT_MAX - nb) {
    return cudaErrorInvalidValue;
  }
  const long long blocks = mode_blocks(kCross, nb, na);
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  const Out out{kCross, nb, 0, na, static_cast<double*>(g)};
  return gram(static_cast<const double*>(a_buf), na, static_cast<const double*>(b_buf), nb, r_pad,
              static_cast<int>(blocks), static_cast<int>((na + kTile - 1) / kTile), out,
              static_cast<cudaStream_t>(stream));
}

// The Gram kernel's launch shape for n rows in `mode` (0 triangle, 1 panel
// of `rows` rows, 2 split, 3 cross of `rows` rows of a by n rows of b), for
// reports: out = {tile, k_tile, stages,
// threads per block, dynamic shared memory per block, blocks, resident
// blocks per SM, registers a thread, local (spill) bytes a thread, static
// shared memory per block}. Returns a cudaError_t.
int zprep_gram64_info(int n, int rows, int mode, int* out) {
  if (n <= 0 || mode < kTriangle || mode > kCross ||
      ((mode == kPanel || mode == kCross) && rows <= 0)) {
    return cudaErrorInvalidValue;
  }
  int err = configure();
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, gram64_kernel);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gram64_kernel, kThreads,
                                                      kSmemBytes);
  if (err != cudaSuccess) return err;
  const long long blocks = mode_blocks(mode, n, rows);
  const int info[10] = {kTile, kTileK, kStages, kThreads, kSmemBytes,
                        static_cast<int>(blocks < INT_MAX ? blocks : INT_MAX), per_sm,
                        attr.numRegs, static_cast<int>(attr.localSizeBytes),
                        static_cast<int>(attr.sharedSizeBytes)};
  for (int i = 0; i < 10; ++i) out[i] = info[i];
  return cudaSuccess;
}

const char* zprep_gram64_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
