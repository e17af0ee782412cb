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
// H100 SXM data sheet), 0.19 ms and 1.03 ms. wgmma
// has no f64 form; the f64 tensor-core shape is mma.sync m8n8k4, whose
// products and sums are IEEE float64, so no split (the float32 kernel's
// 3xTF32) is needed for the float64 contract.
//
// Design (a simple kernel that is right; making it fast is later work):
//
// - Prep pass: one block per row writes P as float64 [N, R_pad], R_pad a
//   multiple of the K-stage, zero padded: the padding adds exactly 0 and
//   every row starts 16-byte aligned for cp.async.
// - Gram kernel: one block of 4 warps per 64x64 tile of G; each warp owns a
//   32x32 quarter as 4x4 m8n8k4 tiles (32 float64 accumulators a lane). A
//   two-stage ring of 16-column stages in shared memory is filled by
//   cp.async (16-byte copies, zero fill past row N) while the warps run the
//   previous stage. Shared rows are 20 doubles apart, so a half-warp's
//   fragment loads (4 rows x 4 columns of 8 bytes) hit 32 distinct banks.
//   Every entry is summed in the same K order, 4 columns at a time.
//
// Three modes share the prep pass and the tile code; each has one C entry
// point that returns its cudaError_t:
//
// - triangle (zprep_gram64_launch): the prep, then the upper-triangle tiles
//   (i <= j) of G [N, N]; each tile also writes its mirror G[j, i], and a
//   diagonal tile writes its upper half and mirrors it, so G is exactly
//   symmetric.
// - split (zprep_split64_launch): the prep once per step of the row-panel
//   branch (P stays in the buffer for the panels), then the diagonal tiles
//   only, of which the kernel stores the diagonal: the squared norms |P_i|^2
//   [N], computed by the code that computes each panel's G[i, i].
// - panel (zprep_gram64_panel_launch): G[i0:i0+B, 0:N] [B, N] from P, one
//   block per (row tile of the panel) x (column tile), the panel's row
//   tiles of one column tile neighbours in the launch order so that the
//   column tile is read from device memory about once per panel.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;         // rows and columns of G per block
constexpr int kTileK = 16;        // R columns per stage; R_pad is a multiple of it
constexpr int kLd = kTileK + 4;   // shared row stride in doubles: conflict-free fragments
constexpr int kThreads = 128;     // four warps, a 32x32 quarter of the tile each
constexpr int kPrepThreads = 256;
constexpr int kChunks = kTile * kTileK / 2;  // 16-byte copies of one operand stage

enum Mode { kTriangle = 0, kPanel = 1, kDiagonal = 2 };

// Where a block's tile goes: G [n, n] (kTriangle), the panel G[i0:i0+rows]
// as [rows, n] (kPanel), or the diagonal [n] (kDiagonal).
struct Out {
  int mode;
  int n;
  int i0, rows;  // the panel's first row and its row count (kPanel)
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

// 16 bytes from device memory into shared memory, asynchronously; zeros
// where src_bytes is 0
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

// d += a * b for one 8x8 float64 tile over 4 columns: lane l holds A[l/4][l%4],
// B[l%4][l/4] and D[l/4][2 (l%4)], D[l/4][2 (l%4) + 1]
__device__ __forceinline__ void dmma(double (&d)[2], double a, double b) {
  asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, {%0, %1};"
               : "+d"(d[0]), "+d"(d[1])
               : "d"(a), "d"(b));
}

__global__ void __launch_bounds__(kThreads)
gram64_kernel(const double* __restrict__ p, int n, int r_pad, int tiles, int panel_row_tiles,
              const Out out) {
  __shared__ __align__(16) double sa[2][kTile * kLd];
  __shared__ __align__(16) double sb[2][kTile * kLd];

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
  } else {
    row0 = col0 = blockIdx.x * kTile;
  }
  const bool diag = row0 == col0;

  const int k_tiles = r_pad / kTileK;
  auto load = [&](int stage, int kt) {
    for (int c = threadIdx.x; c < kChunks; c += kThreads) {
      const int r = c / (kTileK / 2), q = c % (kTileK / 2);
      const int ga = row0 + r, gb = col0 + r;
      const size_t col = static_cast<size_t>(kt) * kTileK + 2 * q;
      cp_async16(smem_addr(&sa[stage][r * kLd + 2 * q]),
                 p + static_cast<size_t>(ga < n ? ga : n - 1) * r_pad + col, ga < n ? 16 : 0);
      cp_async16(smem_addr(&sb[stage][r * kLd + 2 * q]),
                 p + static_cast<size_t>(gb < n ? gb : n - 1) * r_pad + col, gb < n ? 16 : 0);
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wr = (warp >> 1) * 32, wc = (warp & 1) * 32;  // this warp's quarter of the tile
  const int g = lane >> 2, t = lane & 3;
  double acc[4][4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = 0.0;

  load(0, 0);
  for (int kt = 0; kt < k_tiles; ++kt) {
    const int s = kt & 1;
    if (kt + 1 < k_tiles) {
      load(s ^ 1, kt + 1);  // its stage was last read before the barrier ending kt - 1
      asm volatile("cp.async.wait_group 1;" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;" ::: "memory");
    }
    __syncthreads();  // every thread's copies of stage s have landed
    const double* a = sa[s];
    const double* b = sb[s];
#pragma unroll
    for (int kk = 0; kk < kTileK; kk += 4) {
      double fa[4], fb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) fa[i] = a[(wr + 8 * i + g) * kLd + kk + t];
#pragma unroll
      for (int j = 0; j < 4; ++j) fb[j] = b[(wc + 8 * j + g) * kLd + kk + t];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) dmma(acc[i][j], fa[i], fb[j]);
    }
    __syncthreads();  // stage s may be refilled
  }

  const int n_out = out.n;
  double* __restrict__ gout = out.g;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = wr + 8 * i + g, c = wc + 8 * j + 2 * t + e;
        const int gi = row0 + r, gj = col0 + c;
        const double v = acc[i][j][e];
        if (out.mode == kDiagonal) {
          if (r == c && gi < n_out) gout[gi] = v;
        } else if (out.mode == kPanel) {
          if (gi < out.i0 + out.rows && gj < n_out) {
            gout[static_cast<size_t>(gi - out.i0) * n_out + gj] = v;
          }
        } else if (gi < n_out && gj < n_out && (!diag || r <= c)) {
          // G[i, j] and its mirror G[j, i]; a diagonal tile's upper half only
          gout[static_cast<size_t>(gi) * n_out + gj] = v;
          if (!diag || r < c) gout[static_cast<size_t>(gj) * n_out + gi] = v;
        }
      }
    }
  }
}

long long upper_tiles(int n) {
  const long long t = (n + kTile - 1) / kTile;
  return t * (t + 1) / 2;
}

bool bad_shape(int n, int r, int r_pad) {
  return r_pad < r || r_pad <= 0 || r_pad % kTileK != 0 || upper_tiles(n) > INT_MAX;
}

int prep(const void* z, const void* mask, const void* region, double zmax, int n, int r,
         int r_pad, double* p, cudaStream_t s) {
  prep_kernel<<<n, kPrepThreads, 0, s>>>(static_cast<const double*>(z),
                                          static_cast<const uint8_t*>(mask),
                                          static_cast<const uint8_t*>(region), zmax, r, r_pad, p);
  return static_cast<int>(cudaGetLastError());
}

int gram(const double* p, int n, int r_pad, int blocks, int panel_row_tiles, const Out& out,
         cudaStream_t s) {
  gram64_kernel<<<blocks, kThreads, 0, s>>>(p, n, r_pad, (n + kTile - 1) / kTile,
                                            panel_row_tiles, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launch the prep pass and the Gram kernel on `stream` without
// synchronising: z [n, r] float64 (mask [n, r] and region [r] bytes) in,
// g [n, n] float64 out. `p_buf` is scratch of n * r_pad float64 (r_pad >=
// r, a multiple of 16). Returns a cudaError_t.
int zprep_gram64_launch(const void* z, const void* mask, const void* region, double zmax, int n,
                        int r, int r_pad, void* p_buf, void* g, void* stream) {
  if (n <= 0) return cudaSuccess;
  if (bad_shape(n, r, r_pad)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  double* p = static_cast<double*>(p_buf);
  int err = prep(z, mask, region, zmax, n, r, r_pad, p, s);
  if (err != cudaSuccess) return err;
  const Out out{kTriangle, n, 0, n, static_cast<double*>(g)};
  return gram(p, n, r_pad, static_cast<int>(upper_tiles(n)), 1, out, s);
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
  return gram(p, n, r_pad, (n + kTile - 1) / kTile, 1, out, s);
}

// One row panel, G[i0:i0+rows, 0:n] into g [rows, n], from the P that
// zprep_split64_launch wrote into `p_buf`.
int zprep_gram64_panel_launch(const void* p_buf, int n, int r_pad, int i0, int rows, void* g,
                              void* stream) {
  if (rows <= 0) return cudaSuccess;
  if (bad_shape(n, 0, r_pad) || i0 < 0 || rows > n - i0) return cudaErrorInvalidValue;
  const long long row_tiles = (rows + kTile - 1) / kTile;
  const long long blocks = row_tiles * ((n + kTile - 1) / kTile);
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  const Out out{kPanel, n, i0, rows, static_cast<double*>(g)};
  return gram(static_cast<const double*>(p_buf), n, r_pad, static_cast<int>(blocks),
              static_cast<int>(row_tiles), out, static_cast<cudaStream_t>(stream));
}

// The Gram kernel's launch shape for n rows, for reports: out = {tile,
// k_tile, stages, threads per block, static shared memory per block,
// blocks (upper tiles), resident blocks per SM, registers a thread, local
// (spill) bytes a thread}. Returns a cudaError_t.
int zprep_gram64_info(int n, int* out) {
  cudaFuncAttributes attr;
  int err = cudaFuncGetAttributes(&attr, gram64_kernel);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gram64_kernel, kThreads, 0);
  if (err != cudaSuccess) return err;
  const int info[9] = {kTile, kTileK, 2, kThreads, static_cast<int>(attr.sharedSizeBytes),
                       static_cast<int>(upper_tiles(n)), per_sm, attr.numRegs,
                       static_cast<int>(attr.localSizeBytes)};
  for (int i = 0; i < 9; ++i) out[i] = info[i];
  return cudaSuccess;
}

const char* zprep_gram64_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
