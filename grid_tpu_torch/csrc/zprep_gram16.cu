// The bfloat16 form of csrc/zprep_gram.cu: G = P * P^T with
// P = where(mask, clip(z, -zmax, zmax), 0) * region, for z [N, R] bfloat16,
// as grid_tpu's step under device.dtype: bfloat16 computes it
// (grid_tpu/ops/knn.py:d2_matrix, z @ z.T in bf16): every product of two
// bf16 values is exact in float32, the sum is kept in float32 and G is
// rounded to bf16 once.
//
// Replaces grid_tpu/ops/pallas_kernels.py:zprep_gram (_zprep_tile and
// _gram_kernel; pallas_call at line 93) at device.dtype bfloat16.
//
// What bounds it on the H100: operations. The symmetric product at N=2504,
// R=2048 is N(N+1)R = 12.85 GFLOP, 13.0 us at the 989 TFLOP/s of dense bf16;
// a [512, 65,536] panel at R=1024 is 2*B*N*R = 68.7 GFLOP, 69.5 us, against
// 128 MB of P read and 64 MB of G written (57 us at 3.35 TB/s): the tensor
// cores and the copies both have to stay busy.
//
// Design (each point against the float32 form's tiles, which the first bf16
// form ran: one m64n128k16 product a k-step into a fresh accumulator every
// 64-column stage, a wait for it to retire, three adds into `mid` and
// `acc`, a 6-stage ring, one 128x128 tile a block and scalar bf16 stores):
//
// - One accumulator for the whole of R. The fresh accumulator a stage is a
//   3xTF32 device (the TF32 cores truncate over a long sum); a bf16 stage
//   has a sixth of that tensor work, so the wait and the adds cost more
//   than its products. Here each k-step adds into the wgmma accumulator
//   itself and one group stays in flight (wgmma.wait_group 1): a stage is
//   released when the next one's products are issued. The bf16 contract
//   allows one bf16 ulp of the entry or 2^-16 of max|G|; the accumulator's
//   own rounding over R=2048 stays far inside it (held on the card by
//   tests/test_torch_gpu.py and chip_smoke.py at R=2048 and 1024).
// - Tiles of 128x256: two consumer warpgroups each run m64n256k16 on 64
//   rows (128 float32 accumulators a thread, 232 registers by setmaxnreg),
//   so a stage's 48 KB from L2 (16 KB of A, 32 KB of B) feeds 4.2 MFLOP,
//   85 flops a byte where 128x128 tiles give 64.
// - A ring of 4 stages of 64 columns (one 128-byte swizzle row
//   of bf16), filled by TMA from one thread of a producer warpgroup on a
//   `full` mbarrier a stage; each consumer warp arrives on the stage's
//   `empty` mbarrier.
// - A persistent walk: one block an SM walks the tiles t = block, block +
//   grid, ... The producer runs ahead into the next tile while the
//   consumers store the last one. A panel's row tiles of one column tile
//   are neighbours in the walk, so each column tile of P leaves device
//   memory about once a panel and the panel's rows stay in L2.
// - A bf16 epilogue: the accumulators are rounded in registers and staged
//   as 64-column boxes of 128 rows in the TMA store's 128-byte swizzle (a
//   warp's writes hit 32 distinct banks), two boxes at a time
//   in a buffer of their own, and one thread stores each box with a TMA
//   bulk store; the consumers go on to the next tile while it drains.
//   Where G's rows are not 16-byte aligned (N not a multiple of 8) the
//   consumers store the staged boxes entry by entry instead.
//
// Modes, each with one C entry point that returns its cudaError_t (or
// 10000 + the CUresult of a failed tensor-map encoding):
//
// - triangle (zprep_gram16_launch): the split pass, then G [N, N]. Row
//   tile i (rows 128i..) takes the tiles from column 128i in steps of 256,
//   so the first tile of a row holds its diagonal 128x128 block in its
//   left half and loads only its 256 rows (the first 128 of them are the
//   A operand). G[j, i] = G[i, j] comes from the same registers, staged
//   transposed; a diagonal block takes its lower half from its upper half
//   in the staged tile, so G is exactly symmetric.
// - split (zprep_split16_launch): the split pass alone, once per step of
//   the row-panel branch.
// - panel (zprep_gram16_panel_launch): G[i0:i0+B, 0:N] [B, N] from the
//   split's P, tiles of (the panel's row tiles) x (256-column tiles), no
//   mirror.
// - cross (zprep_gram16_cross_launch): G = P_a P_b^T [Ba, Bb] for two row
//   blocks of split rows, the sharded ring's product of a rank's rows with
//   the visiting block: the panel mode's walk and epilogue over (a's row
//   tiles) x (b's 256-column tiles), with a's rows through the A map and
//   b's through the B map, in one launch with no mirror.
//
// One sum order: an entry's R columns are added k-step by k-step in R
// order into one accumulator, in every mode and every position of a tile,
// and its two products a*b and b*a are the same float32 value, so a
// panel's entry is bitwise the triangle's same entry, and a cross block's
// entry the panel's for the same two rows of one split of the whole
// cohort, whatever the blocks' offsets there (held on the card).
//
// The split pass (one block a row) writes P [N, R_pad] bf16 (R_pad a
// multiple of 16; the TMA box's columns past it read as zeros) and the
// squared norms as grid_tpu's jitted step sums them: sum(P * P) with the
// squares exact and the sum kept in float32 and rounded once (G's diagonal
// is the same sum in another order; d2 follows the norms, one definition
// for both branches).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>
#include <stdio.h>

#include <atomic>

namespace {

constexpr int kRows = 128;   // rows of a tile: two consumer warpgroups of 64
constexpr int kCols = 256;   // columns of a tile: the m64n256k16 width
constexpr int kTileK = 64;   // R columns a stage: one 128-byte swizzle row of bf16
constexpr int kBoxCols = 64;  // columns of a staged box of G: one 128-byte swizzle row
constexpr int kStages = 4;     // the ring's depth
constexpr int kEpiBoxes = 2;   // staged boxes of G at a time
constexpr int kConsumers = 256;
constexpr int kThreads = kConsumers + 128;  // + the producer warpgroup
constexpr int kProducerRegs = 40;           // setmaxnreg: 128 x 40 + 256 x 232 <= 65,536
constexpr int kConsumerRegs = 232;
constexpr int kABytes = kRows * kTileK * 2;     // 16 KB
constexpr int kBBytes = kCols * kTileK * 2;     // 32 KB
constexpr int kStageBytes = kABytes + kBBytes;  // 48 KB
constexpr int kBoxBytes = kRows * kBoxCols * 2;  // 16 KB
constexpr int kSmemBytes = kStages * kStageBytes + kEpiBoxes * kBoxBytes + 1024;  // + alignment
constexpr int kSplitThreads = 256;
constexpr int kPad = 16;             // R_pad's multiple: one k16 step
constexpr int kEncodeError = 10000;  // + CUresult of a failed cuTensorMapEncodeTiled

static_assert(kSmemBytes + 256 <= 232448, "an H100 block takes at most 227 KB of shared memory");
static_assert(kEpiBoxes >= 2 && 4 % kEpiBoxes == 0,
              "the staged boxes hold the diagonal block and divide the tile");

// the cross mode runs the panel mode's walk (kPanel) on two maps; its
// number is the one the reports and the other dtypes' kernels give it
enum Mode { kTriangle = 0, kPanel = 1, kCross = 3 };

// The walk's geometry: G [n, n] (kTriangle) or the panel G[i0:i0+rows] as
// [rows, n] (kPanel; a cross block [rows, n] with i0 = 0, n the B rows); `g`
// for the stores entry by entry when tma_store is 0.
struct Geo {
  int mode;
  int n;
  int i0, rows;
  int tiles;      // the launch's tiles in all
  int row_tiles;  // the panel's row tiles
  int k_tiles;    // stages of R
  int tma_store;  // G's rows 16-byte aligned: the boxes go out by TMA
  __nv_bfloat16* g;
};

// The tile t of the walk: its first row (A's rows, G's rows) and first
// column (B's rows, G's columns).
__device__ __forceinline__ void tile_at(const Geo& geo, int t, int& row0, int& col0) {
  if (geo.mode == kPanel) {
    row0 = geo.i0 + (t % geo.row_tiles) * kRows;
    col0 = (t / geo.row_tiles) * kCols;
    return;
  }
  int ti = 0;  // row tile ti holds ceil((n - 128 ti) / 256) tiles from column 128 ti
  for (;;) {
    const int here = (geo.n - ti * kRows + kCols - 1) / kCols;
    if (t < here) break;
    t -= here;
    ++ti;
  }
  row0 = ti * kRows;
  col0 = row0 + t * kCols;
}

// The split pass: one block per row writes P [N, R_pad] bf16 (clip, mask
// and region as the float32 pass; zero past R) and the row's squared norm as
// grid_tpu sums it: the squares exact in float32, their sum in float32 (a
// tree over the block) rounded once.
__global__ void __launch_bounds__(kSplitThreads)
split16_kernel(const __nv_bfloat16* __restrict__ z, const uint8_t* __restrict__ mask,
               const uint8_t* __restrict__ region, float zmax, int r, int r_pad,
               __nv_bfloat16* __restrict__ p_out, __nv_bfloat16* __restrict__ norms) {
  __shared__ float warp_sums[kSplitThreads / 32];
  const size_t in = static_cast<size_t>(blockIdx.x) * r;
  const size_t out = static_cast<size_t>(blockIdx.x) * r_pad;
  float sq = 0.f;
  for (int c = threadIdx.x; c < r_pad; c += kSplitThreads) {
    float p = 0.f;
    if (c < r) {
      const float v = __bfloat162float(z[in + c]);
      const float clipped = isnan(v) ? v : fminf(fmaxf(v, -zmax), zmax);
      p = (!mask || mask[in + c] ? clipped : 0.f) * (!region || region[c] ? 1.f : 0.f);
    }
    const __nv_bfloat16 pb = __float2bfloat16_rn(p);
    p_out[out + c] = pb;
    const float pf = __bfloat162float(pb);
    sq = fmaf(pf, pf, sq);  // pf * pf is exact: the fma rounds as the add alone
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x / 32] = sq;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.f;
#pragma unroll
    for (int w = 0; w < kSplitThreads / 32; ++w) total += warp_sums[w];
    norms[blockIdx.x] = __float2bfloat16_rn(total);
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

// one staged box of G to device memory at (col, row), in this thread's
// bulk group
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int col,
                                          int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%1, %2}], [%3];" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(col), "r"(row), "r"(src)
      : "memory");
}

__device__ __forceinline__ void st_shared_b32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;" ::"r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ void st_shared_b16(uint32_t addr, uint16_t v) {
  asm volatile("st.shared.b16 [%0], %1;" ::"r"(addr), "h"(v) : "memory");
}

__device__ __forceinline__ uint16_t ld_shared_b16(uint32_t addr) {
  uint16_t v;
  asm volatile("ld.shared.b16 %0, [%1];" : "=h"(v) : "r"(addr) : "memory");
  return v;
}

// the consumers' own barrier (the producer warpgroup never joins it)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
}

// generic-proxy writes to shared memory, made visible to the TMA's reads
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// wgmma shared-memory descriptor of a K-major tile with 128-byte swizzle:
// rows of 128 bytes, 8-row groups 1024 bytes apart (SBO); LBO is unused
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3ffff) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// byte offset of entry (row, col) in a [rows][64] bf16 box under the
// 128-byte swizzle: the row's 16-byte chunks XORed with the row mod 8
__device__ __forceinline__ uint32_t box_offset(int row, int col) {
  return row * 128 + ((((col >> 3) ^ row) & 7) << 4) + (col & 7) * 2;
}

// d (+)= A[64 x 16] * B[256 x 16]^T in bf16, float32 accumulators (both
// operands K-major); d is overwritten when scale_d is 0
__device__ __forceinline__ void wgmma_bf16(float (&d)[128], uint64_t desc_a, uint64_t desc_b,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, "
      "%87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, "
      "%118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 0;\n}\n"
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
        "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]),
        "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]),
        "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]),
        "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]),
        "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma
__device__ __forceinline__ void fence_operands(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The staged boxes reused: the TMA stores that read them have read them
// (the issuing thread waits on its bulk groups), or, storing entry by
// entry, every consumer is done reading them.
__device__ __forceinline__ void boxes_free(const Geo& geo, int tid) {
  if (geo.tma_store && tid == 0) asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
  consumers_sync();
}

// Stores `count` staged boxes: box b holds G's rows row..row+127 and
// columns col + 64 b..col + 64 b + 63, clipped to G's [out_rows, n].
__device__ __forceinline__ void store_boxes(const Geo& geo, const CUtensorMap* map_g,
                                            uint32_t epi, const uint8_t* epi_ptr, int count,
                                            int row, int col, int out_rows, int tid) {
  if (geo.tma_store) {
    if (tid == 0) {
      for (int b = 0; b < count; ++b) {
        const int c = col + b * kBoxCols;
        if (row < out_rows && c < geo.n) tma_store(map_g, epi + b * kBoxBytes, c, row);
      }
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    }
    return;
  }
  for (int idx = tid; idx < count * kRows * kBoxCols; idx += kConsumers) {
    const int b = idx / (kRows * kBoxCols), r = (idx / kBoxCols) % kRows, c = idx % kBoxCols;
    const int gr = row + r, gc = col + b * kBoxCols + c;
    if (gr < out_rows && gc < geo.n) {
      const uint16_t v = *reinterpret_cast<const uint16_t*>(epi_ptr + b * kBoxBytes +
                                                            box_offset(r, c));
      reinterpret_cast<uint16_t*>(geo.g)[static_cast<size_t>(gr) * geo.n + gc] = v;
    }
  }
}

// The epilogue of a tile: G's rows row0.. and columns col0.. from the
// accumulators (lane (w, l) of warpgroup wg holds rows wg*64 + 16w + l/4 +
// 8h and columns 8j + 2(l%4) + e as d[4j + 2h + e]), then the triangle's
// mirror, G[col0 + c, row0 + r].
__device__ __forceinline__ void epilogue(const Geo& geo, const CUtensorMap* map_g,
                                         float (&acc)[128], uint32_t epi, uint8_t* epi_ptr,
                                         int row0, int col0, bool diag, int tid) {
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int lr = lane >> 2, lc = 2 * (lane & 3);
  const int out_rows = geo.mode == kPanel ? geo.rows : geo.n;
  const int row_out = geo.mode == kPanel ? row0 - geo.i0 : row0;
#pragma unroll
  for (int q = 0; q < 4; q += kEpiBoxes) {
    boxes_free(geo, tid);
#pragma unroll
    for (int b = 0; b < kEpiBoxes; ++b) {
#pragma unroll
      for (int j8 = 0; j8 < 8; ++j8) {
        const int j = (q + b) * 8 + j8;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = wg * 64 + warp * 16 + lr + 8 * h;
          const __nv_bfloat162 v = __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
          st_shared_b32(epi + b * kBoxBytes + box_offset(r, j8 * 8 + lc),
                        *reinterpret_cast<const uint32_t*>(&v));
        }
      }
    }
    fence_async_shared();
    consumers_sync();
    if (diag && q == 0) {
      // the diagonal block (boxes 0 and 1) takes its lower half from its
      // upper half: reads above the diagonal, writes below it
      for (int idx = tid; idx < kRows * kRows; idx += kConsumers) {
        const int r = idx / kRows, c = idx % kRows;
        if (c < r) {
          const uint16_t v = ld_shared_b16(epi + (r >> 6) * kBoxBytes + box_offset(c, r & 63));
          st_shared_b16(epi + (c >> 6) * kBoxBytes + box_offset(r, c & 63), v);
        }
      }
      fence_async_shared();
      consumers_sync();
    }
    store_boxes(geo, map_g, epi, epi_ptr, kEpiBoxes, row_out, col0 + q * kBoxCols, out_rows, tid);
  }
  if (geo.mode != kTriangle) return;
  // the mirror: the tile's columns 128u.. become G's rows col0 + 128u..;
  // warpgroup wg stages its 64 rows as box wg, 128 rows of 64 columns
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    if (u == 0 && diag) continue;  // the diagonal block was stored whole
    boxes_free(geo, tid);
#pragma unroll
    for (int j = 16 * u; j < 16 * u + 16; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int rt = 8 * (j - 16 * u) + lc + e, ct = warp * 16 + lr + 8 * h;
          const __nv_bfloat16 v = __float2bfloat16_rn(acc[4 * j + 2 * h + e]);
          st_shared_b16(epi + wg * kBoxBytes + box_offset(rt, ct),
                        *reinterpret_cast<const uint16_t*>(&v));
        }
      }
    }
    fence_async_shared();
    consumers_sync();
    store_boxes(geo, map_g, epi, epi_ptr, 2, col0 + 128 * u, row0, geo.n, tid);
  }
}

// The A operand's rows (G's rows) come through map_a (128-row boxes), the
// B operand's (G's columns) through map_b (256-row boxes) of one P; G goes
// out through map_g (64 x 128 boxes) where geo.tma_store is set.
__global__ void __launch_bounds__(kThreads, 1)
gram16_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
              const __grid_constant__ CUtensorMap map_g, const Geo geo) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages];   // TMA bytes of a stage have landed
  __shared__ __align__(8) uint64_t empty[kStages];  // every consumer warp is done with it
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t ring = (raw + 1023) & ~1023u;  // swizzle atoms are 1024-byte aligned
  const uint32_t epi = ring + kStages * kStageBytes;
  uint8_t* epi_ptr = smem_raw + (epi - raw);
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(smem_addr(&full[s]), 1);
      mbar_init(smem_addr(&empty[s]), kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {  // the producer warpgroup; one thread starts every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (tid == kConsumers) {
      int it = 0;  // stages over the whole walk: ring slot and phase
      for (int t = blockIdx.x; t < geo.tiles; t += gridDim.x) {
        int row0, col0;
        tile_at(geo, t, row0, col0);
        const bool diag = geo.mode == kTriangle && row0 == col0;
        for (int kt = 0; kt < geo.k_tiles; ++kt, ++it) {
          const int s = it % kStages, round = it / kStages;
          if (round > 0) mbar_wait(smem_addr(&empty[s]), (round - 1) & 1);
          const uint32_t stage = ring + s * kStageBytes, bar = smem_addr(&full[s]);
          mbar_expect_tx(bar, diag ? kBBytes : kStageBytes);
          if (!diag) tma_load(stage, &map_a, bar, kt * kTileK, row0);
          tma_load(stage + kABytes, &map_b, bar, kt * kTileK, col0);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
  const int wg = tid / 128, lane = tid % 32;
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  int it = 0;
  for (int t = blockIdx.x; t < geo.tiles; t += gridDim.x) {
    int row0, col0;
    tile_at(geo, t, row0, col0);
    const bool diag = geo.mode == kTriangle && row0 == col0;
    for (int kt = 0; kt < geo.k_tiles; ++kt, ++it) {
      const int s = it % kStages;
      mbar_wait(smem_addr(&full[s]), (it / kStages) & 1);
      const uint32_t stage = ring + s * kStageBytes;
      // a diagonal tile's A rows are the first 128 of its B rows
      const uint64_t da = sw128_desc((diag ? stage + kABytes : stage) + wg * 64 * 128);
      const uint64_t db = sw128_desc(stage + kABytes);
      fence_operands(acc);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
      // each k-step is 32 bytes further along the swizzled row, +2 in the
      // descriptor's 16-byte units; the tile's first k-step overwrites
#pragma unroll
      for (int j = 0; j < kTileK / 16; ++j) wgmma_bf16(acc, da + 2 * j, db + 2 * j, kt > 0 || j > 0);
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
      fence_operands(acc);
      // the previous stage's products have retired: it may be refilled
      if (kt > 0 && lane == 0) mbar_arrive(smem_addr(&empty[(it - 1) % kStages]));
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    fence_operands(acc);
    if (lane == 0) mbar_arrive(smem_addr(&empty[(it - 1) % kStages]));
    epilogue(geo, &map_g, acc, epi, epi_ptr, row0, col0, diag, tid);
  }
  // the stores must have read the staged boxes before the block's shared
  // memory goes
  if (geo.tma_store && tid == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
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

// [rows, cols] bf16 at `base` (row stride cols), in boxes of box_rows x 64
// columns (128 bytes a row) with 128-byte swizzle; reads past the edges are
// zeros, stores past them are dropped
int make_map(CUtensorMap* map, const void* base, int rows, int cols, int box_rows) {
  EncodeTiled encode;
  const int err = encode_tiled(&encode);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {kBoxCols, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
                              dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : kEncodeError + static_cast<int>(res);
}

// tiles of a mode at n columns (and the panel's or the cross block's rows)
long long mode_tiles(int mode, int n, int rows) {
  if (mode == kPanel || mode == kCross) {
    return static_cast<long long>((rows + kRows - 1) / kRows) * ((n + kCols - 1) / kCols);
  }
  if (mode != kTriangle) return 0;
  long long tiles = 0;
  for (long long row0 = 0; row0 < n; row0 += kRows) tiles += (n - row0 + kCols - 1) / kCols;
  return tiles;
}

bool bad_shape(int n, int r, int r_pad) {
  return r_pad < r || r_pad <= 0 || r_pad % kPad != 0 || mode_tiles(kTriangle, n, n) > INT_MAX;
}

constexpr int kMaxDevices = 64;

// The current device's SM count, with the kernel's shared-memory limit
// raised on it: both asked once a device, not on every launch.
int device_sms(int* sms) {
  static std::atomic<int> known[kMaxDevices];  // 0: not asked yet
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < kMaxDevices && (*sms = known[device].load()) > 0) return cudaSuccess;
  err = cudaFuncSetAttribute(gram16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes);
  if (err != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess) {
    return err;
  }
  if (device < kMaxDevices) known[device] = *sms;
  return cudaSuccess;
}

int split16(const void* z, const void* mask, const void* region, float zmax, int n, int r,
            int r_pad, void* p, void* norms, cudaStream_t s) {
  split16_kernel<<<n, kSplitThreads, 0, s>>>(
      static_cast<const __nv_bfloat16*>(z), static_cast<const uint8_t*>(mask),
      static_cast<const uint8_t*>(region), zmax, r, r_pad, static_cast<__nv_bfloat16*>(p),
      static_cast<__nv_bfloat16*>(norms));
  return static_cast<int>(cudaGetLastError());
}

// The Gram kernel over the tiles of `mode`: the A operand's rows from P_a
// [na, r_pad] at pa, the B operand's from P_b [nb, r_pad] at pb (one P in
// the triangle and panel modes), G [out_rows, nb] at g; one block an SM, or
// one a tile where there are fewer.
int gram(const void* pa, int na, const void* pb, int nb, int r_pad, int mode, int i0, int rows,
         void* g, cudaStream_t s) {
  const long long tiles = mode_tiles(mode, nb, rows);
  if (tiles > INT_MAX) return cudaErrorInvalidValue;
  CUtensorMap map_a, map_b, map_g = {};
  int err = make_map(&map_a, pa, na, r_pad, kRows);
  if (err != cudaSuccess) return err;
  if ((err = make_map(&map_b, pb, nb, r_pad, kCols)) != cudaSuccess) return err;
  const int out_rows = mode == kTriangle ? nb : rows;
  const bool tma_store = nb % 8 == 0;  // G's row stride a multiple of 16 bytes
  if (tma_store && (err = make_map(&map_g, g, out_rows, nb, kRows)) != cudaSuccess) return err;
  int sms = 0;
  if ((err = device_sms(&sms)) != cudaSuccess) return err;
  const Geo geo{mode == kCross ? kPanel : mode, nb, i0, rows, static_cast<int>(tiles),
                (rows + kRows - 1) / kRows, (r_pad + kTileK - 1) / kTileK, tma_store ? 1 : 0,
                static_cast<__nv_bfloat16*>(g)};
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  gram16_kernel<<<grid, kThreads, kSmemBytes, s>>>(map_a, map_b, map_g, geo);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The triangle: the split pass writes P [n, r_pad] bf16 into `p_buf` (r_pad
// >= r, a multiple of 16) and the squared norms grid_tpu sums into `norms`
// [n] bf16, then the Gram kernel G [n, n] bf16. Launches on `stream`
// without synchronising.
int zprep_gram16_launch(const void* z, const void* mask, const void* region, float zmax, int n,
                        int r, int r_pad, void* p_buf, void* norms, void* g, void* stream) {
  if (n <= 0) return cudaSuccess;
  if (bad_shape(n, r, r_pad)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = split16(z, mask, region, zmax, n, r, r_pad, p_buf, norms, s);
  if (err != cudaSuccess) return err;
  return gram(p_buf, n, p_buf, n, r_pad, kTriangle, 0, n, g, s);
}

// The row-panel branch's pass once per step: the split pass alone, P into
// `p_buf` and the norms (as above; a null mask or region keeps every entry).
int zprep_split16_launch(const void* z, const void* mask, const void* region, float zmax, int n,
                         int r, int r_pad, void* p_buf, void* norms, void* stream) {
  if (n <= 0) return cudaSuccess;
  if (bad_shape(n, r, r_pad)) return cudaErrorInvalidValue;
  return split16(z, mask, region, zmax, n, r, r_pad, p_buf, norms,
                 static_cast<cudaStream_t>(stream));
}

// One row panel, G[i0:i0+rows, 0:n] into g [rows, n] bf16, from the P that
// zprep_split16_launch wrote into `p_buf`.
int zprep_gram16_panel_launch(const void* p_buf, int n, int r_pad, int i0, int rows, void* g,
                              void* stream) {
  if (rows <= 0) return cudaSuccess;
  if (bad_shape(n, 0, r_pad) || i0 < 0 || rows > n - i0) return cudaErrorInvalidValue;
  return gram(p_buf, n, p_buf, n, r_pad, kPanel, i0, rows, g, static_cast<cudaStream_t>(stream));
}

// The cross mode: G = P_a P_b^T into g [na, nb] bf16, from two blocks of
// split rows, P_a [na, r_pad] at `pa` and P_b [nb, r_pad] at `pb` (each as
// zprep_split16_launch wrote it). a_row0 and b_row0, the blocks' first rows
// in the cohort, place no entry: every entry is summed in one order whatever
// its place in a tile, so G is bitwise the panel mode's entries for those
// rows of one split of the whole cohort at any offsets.
int zprep_gram16_cross_launch(const void* pa, int na, const void* pb, int nb, int r_pad,
                              int a_row0, int b_row0, void* g, void* stream) {
  if (na <= 0 || nb <= 0) return cudaSuccess;
  if (bad_shape(na, 0, r_pad) || bad_shape(nb, 0, r_pad) || a_row0 < 0 || b_row0 < 0) {
    return cudaErrorInvalidValue;
  }
  return gram(pa, na, pb, nb, r_pad, kCross, 0, na, g, static_cast<cudaStream_t>(stream));
}

// The Gram kernel's launch in `mode` (0 triangle of n rows, 1 panel of
// `rows` rows by n, 3 cross of a block of `rows` rows by one of n), for
// reports: out = {tile rows, tile columns, k-stage
// columns, stages, threads a block, dynamic shared memory a block, staged
// boxes of G, tiles, resident blocks an SM, blocks launched (one an SM:
// the persistent walk), registers a thread, local (spill) bytes a thread,
// static shared memory a block}. Returns a cudaError_t.
int zprep_gram16_info(int n, int rows, int mode, int* out) {
  if (n <= 0 || (mode != kTriangle && mode != kPanel && mode != kCross) ||
      (mode != kTriangle && rows <= 0)) {
    return cudaErrorInvalidValue;
  }
  int sms = 0;
  int err = device_sms(&sms);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  if ((err = cudaFuncGetAttributes(&attr, gram16_kernel)) != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gram16_kernel, kThreads,
                                                      kSmemBytes);
  if (err != cudaSuccess) return err;
  const long long tiles = mode_tiles(mode, n, rows);
  const int info[13] = {kRows, kCols, kTileK, kStages, kThreads, kSmemBytes, kEpiBoxes,
                        static_cast<int>(tiles < INT_MAX ? tiles : INT_MAX), per_sm,
                        static_cast<int>(tiles < sms ? tiles : sms), attr.numRegs,
                        static_cast<int>(attr.localSizeBytes),
                        static_cast<int>(attr.sharedSizeBytes)};
  for (int i = 0; i < 13; ++i) out[i] = info[i];
  return cudaSuccess;
}

const char* zprep_gram16_error_string(int err) {
  if (err >= kEncodeError) {
    static thread_local char msg[64];
    snprintf(msg, sizeof msg, "cuTensorMapEncodeTiled failed, CUresult %d", err - kEncodeError);
    return msg;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
